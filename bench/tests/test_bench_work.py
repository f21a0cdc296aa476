"""The work counts behind the roofline and MFU metrics, against brute-force
counts on tiny shapes (one window for every layer, and a window per layer),
and the trace reduction on hand-made events."""
import itertools
from types import SimpleNamespace

import pytest

import devtrace
import model_flops as mf
import run
from kernels import flash_attention as fa
from models import dense

C = {"num_layers": 3, "d_model": 12, "num_heads": 4, "num_kv_heads": 2,
     "head_dim": 3, "d_ff": 20, "vocab_size": 17}
#: three windowed layers to one full-attention layer
MIXED = [(4, 2, 16, 40)] * 3 + [(4, 2, 16, 0)]


def sizes(layers):
    return dict(C, num_layers=len(layers), layers=layers)


def brute_pairs(S, P, W):
    return sum(1 for q in range(P, P + S) for k in range(q + 1)
               if not W or q - k < W)


def brute_keys(S, P, W):
    return len({k for q in range(P, P + S) for k in range(q + 1)
                if not W or q - k < W})


@pytest.mark.parametrize("S,P,W", list(itertools.product(
    (1, 2, 7, 16), (0, 1, 5, 12), (0, 1, 3, 8))))
def test_visible_pairs(S, P, W):
    assert mf.visible_pairs(S, P, W) == brute_pairs(S, P, W)


@pytest.mark.parametrize("S,P,W", [(5, 0, 0), (9, 4, 0), (9, 4, 3),
                                   (6, 0, 2), (1, 10, 4)])
def test_flash_attention_work(S, P, W):
    H, KV, hd = C["num_heads"], C["num_kv_heads"], C["head_dim"]
    flops, nbytes = fa.work((H, KV, hd, W), S, P, 2)
    # QK^T and PV: 2 multiply-adds of hd each per head and visible pair
    assert flops == H * brute_pairs(S, P, W) * 2 * 2 * hd
    assert nbytes == (2 * H * S + 2 * KV * brute_keys(S, P, W)) * hd * 2
    peaks = {"flops": 10.0, "bytes_per_s": 5.0}
    assert fa.roofline_s(flops, nbytes, peaks) == max(flops / 10.0,
                                                      nbytes / 5.0)


def brute_token_flops(c, pos, logits, lo=0, hi=None):
    """One token at position `pos` through layers [lo, hi), multiply-adds
    counted one product at a time, each layer under its own shape."""
    d, ff = c["d_model"], c["d_ff"]
    total = 0
    for H, KV, hd, W in c["layers"][lo:hi]:
        total += (d * H * hd + 2 * d * KV * hd + H * hd * d     # q k v o
                  + 2 * d * ff + ff * d                         # gate up down
                  + H * 2 * hd * brute_pairs(1, pos, W))
    return 2 * (total + (d * c["vocab_size"] if logits else 0))


@pytest.mark.parametrize("W", (0, 3))
def test_model_flops(W):
    c = sizes([(C["num_heads"], C["num_kv_heads"], C["head_dim"], W)] * 3)
    S, P = 6, 2
    whole = sum(brute_token_flops(c, P + i, i == S - 1) for i in range(S))
    assert dense.prefill_flops(c, S, P, 0, c["num_layers"], True) == whole
    assert dense.decode_flops(c, 7) == brute_token_flops(c, 7, True)


@pytest.mark.parametrize("S,P,lo,hi", [(50, 0, 0, 4), (30, 25, 0, 4),
                                       (45, 10, 2, 4), (7, 60, 3, 4),
                                       (60, 0, 1, 2)])
def test_model_flops_per_layer_windows(S, P, lo, hi):
    """Each layer counts the pairs its own window lets through."""
    c = sizes(MIXED)
    logits = hi == len(MIXED)
    want = sum(brute_token_flops(c, P + i, logits and i == S - 1, lo, hi)
               for i in range(S))
    assert dense.prefill_flops(c, S, P, lo, hi, logits) == want
    assert dense.decode_flops(c, P + S) == brute_token_flops(c, P + S, True)


def traced_run(c, quanta, decodes=(), fa_s=2.0, window_s=4.0):
    spans = devtrace.Spans()
    spans.quanta, spans.decodes = list(quanta), [list(d) for d in decodes]
    return SimpleNamespace(
        trace={"by_op": {"fa_tc_kernel": fa_s, "gemm": 1.0},
               "window_s": window_s},
        spans=spans, sizes=c, model=dense, elt_bytes=2,
        peaks={"flops": 1e3, "bytes_per_s": 1e2})


QUANTA = [(50, 0, 0, 4, True), (30, 25, 1, 3, False), (7, 60, 3, 4, True)]


def test_roofline_sums_each_layers_own_window():
    c = sizes(MIXED)
    r = traced_run(c, QUANTA)
    least = 0.0
    for S, P, lo, hi, _ in QUANTA:
        for H, KV, hd, W in MIXED[lo:hi]:
            flops = 4 * H * hd * brute_pairs(S, P, W)
            nbytes = (2 * H * S + 2 * KV * brute_keys(S, P, W)) * hd * 2
            least += max(flops / 1e3, nbytes / 1e2)
    got = run.load_reader("flash_attention_roofline")(r)
    assert got == pytest.approx(100.0 * least / 2.0, rel=1e-12)


def test_step_mfu_counts_the_quanta_layer_ranges():
    c = sizes(MIXED)
    r = traced_run(c, QUANTA, decodes=[[3, 41], [99]])
    flops = sum(brute_token_flops(c, P + i, logits and i == S - 1, lo, hi)
                for S, P, lo, hi, logits in QUANTA for i in range(S))
    flops += sum(brute_token_flops(c, n, True) for n in (3, 41, 99))
    got = run.load_reader("step_mfu")(r)
    assert got == pytest.approx(100.0 * flops / (4.0 * 1e3), rel=1e-12)


class FakeEngine:
    """Runs a prefill quantum over up to three layers."""
    cfg = SimpleNamespace(num_layers=4)

    def prefill_quantum(self, st):
        st.layer = min(st.layer + 3, self.cfg.num_layers)
        return st, st.layer == self.cfg.num_layers

    def decode_iteration(self, tokens):
        return dict(tokens)

    def slot_lengths(self):
        return {0: 9, 1: 40}

    start_prefill = prefill_logits = admit = evict = \
        lambda self, *a, **kw: None


def test_spans_record_each_quantums_layer_range():
    eng, spans = FakeEngine(), devtrace.Spans()
    spans.wrap(eng)
    st = SimpleNamespace(layer=0, x=SimpleNamespace(shape=(1, 5, 8)),
                         prefix_len=2)
    eng.prefill_quantum(st)                 # not recorded: no open slice
    spans.active = True
    st.layer = 0
    eng.prefill_quantum(st)
    eng.prefill_quantum(st)
    eng.decode_iteration({1: 7})
    assert spans.quanta == [(5, 2, 0, 3, False), (5, 2, 3, 4, True)]
    assert spans.decodes == [[40]]


def test_trace_reduction():
    ev = [("gemm", 0.0, 1.0, True), ("gemm", 0.5, 1.5, True),
          ("fa_tc_kernel", 3.0, 4.0, True),
          ("engine.decode_iteration", 1.4, 3.2, False),
          ("aten::mm", 1.6, 1.7, False), ("engine.admit", 4.2, 4.6, False),
          ("cudaLaunchKernel", 4.7, 5.0, False)]
    r = devtrace.reduce(ev, 5.0)
    assert r["busy_s"] == pytest.approx(2.5)
    assert dict(r["device_ops"]) == pytest.approx({"gemm": 2.0,
                                                   "fa_tc_kernel": 1.0})
    assert dict(r["idle_gaps"]) == pytest.approx(
        {"engine.decode_iteration": 1.5, "engine.admit": 1.0})
    assert devtrace.reduce([("x", 0.0, 1.0, False)], 1.0) is None

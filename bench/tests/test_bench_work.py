"""The work counts behind the roofline and MFU metrics, against brute-force
counts on tiny shapes, and the trace reduction on hand-made events."""
import itertools

import pytest

import devtrace
import model_flops as mf
from kernels import flash_attention as fa

C = {"num_layers": 3, "d_model": 12, "num_heads": 4, "num_kv_heads": 2,
     "head_dim": 3, "d_ff": 20, "vocab_size": 17, "sliding_window": 0}


def brute_pairs(S, P, W):
    return sum(1 for q in range(P, P + S) for k in range(q + 1)
               if not W or q - k < W)


@pytest.mark.parametrize("S,P,W", list(itertools.product(
    (1, 2, 7, 16), (0, 1, 5, 12), (0, 1, 3, 8))))
def test_visible_pairs(S, P, W):
    assert mf.visible_pairs(S, P, W) == brute_pairs(S, P, W)


@pytest.mark.parametrize("S,P,W", [(5, 0, 0), (9, 4, 0), (9, 4, 3),
                                   (6, 0, 2), (1, 10, 4)])
def test_flash_attention_work(S, P, W):
    c = dict(C, sliding_window=W)
    flops, nbytes = fa.work(c, S, P, 2)
    H, KV, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    # QK^T and PV: 2 multiply-adds of hd each per head and visible pair
    assert flops == H * brute_pairs(S, P, W) * 2 * 2 * hd
    keys = {k for q in range(P, P + S) for k in range(q + 1)
            if not W or q - k < W}
    assert nbytes == (2 * H * S + 2 * KV * len(keys)) * hd * 2
    peaks = {"flops": 10.0, "bytes_per_s": 5.0}
    assert fa.roofline_s(flops, nbytes, peaks) == max(flops / 10.0,
                                                      nbytes / 5.0)


def brute_token_flops(c, pos, logits):
    """One token at position `pos` through every layer, multiply-adds
    counted one product at a time."""
    d, hd, ff = c["d_model"], c["head_dim"], c["d_ff"]
    H, KV = c["num_heads"], c["num_kv_heads"]
    per_layer = (d * H * hd + 2 * d * KV * hd + H * hd * d   # q k v o
                 + 2 * d * ff + ff * d                       # gate up down
                 + H * 2 * hd * brute_pairs(1, pos, c["sliding_window"]))
    return 2 * (c["num_layers"] * per_layer
                + (d * c["vocab_size"] if logits else 0))


@pytest.mark.parametrize("W", (0, 3))
def test_model_flops(W):
    c = dict(C, sliding_window=W)
    S, P = 6, 2
    whole = sum(brute_token_flops(c, P + i, i == S - 1) for i in range(S))
    assert mf.prefill_flops(c, S, P, c["num_layers"], True) == whole
    assert mf.decode_flops(c, 7) == brute_token_flops(c, 7, True)


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

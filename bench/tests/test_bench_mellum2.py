"""Mellum2's model module (``models/mellum2.py``) and its readers: the model
FLOPs against a brute count, the layers' window pattern, the reference's
routing against a direct one, B4's work and the two new per-layer readers
on hand-made runs, and the cell's rehearsal end to end on the CPU."""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import check
import devtrace
import run
from kernels import moe_grouped_gemm as mg
from models import mellum2

BENCH = Path(__file__).resolve().parent.parent
CELL = "mellum2_12b_a2_5b.azure_overload"


def config():
    return json.loads((BENCH / "configs" / "mellum2_12b_a2_5b.json").read_text())


def test_layers_follow_the_published_pattern():
    c = mellum2.sizes(config(), False)
    assert c["layers"] == [(32, 4, 128, 1024)] * 3 + [(32, 4, 128, 0)] + \
        [(32, 4, 128, 1024)] * 3 + [(32, 4, 128, 0)] + \
        [(32, 4, 128, 1024)] * 3 + [(32, 4, 128, 0)] + \
        ([(32, 4, 128, 1024)] * 3 + [(32, 4, 128, 0)]) * 4
    assert (c["d_model"], c["d_ff"], c["num_experts"], c["experts_per_token"],
            c["vocab_size"], c["max_len"]) == (2304, 896, 64, 8, 98304, 4096)
    assert c["yarn"]["factor"] == 16 and c["full_rope_theta"] == 5e5
    r = mellum2.sizes(config(), True)
    assert [w for *_, w in r["layers"]] == [8, 8, 8, 0]
    cfg = mellum2.port_config(config(), c)
    assert cfg.layer_windows == tuple(w for *_, w in c["layers"])
    assert cfg.full_rope.yarn.original_max_position_embeddings == 8192
    assert cfg.capacity_factor == cfg.decode_capacity_factor == 64


def brute_flops(c, S, P, lo, hi, logits):
    """Multiply-adds one product at a time, token by token."""
    d, ff, E, K = c["d_model"], c["d_ff"], c["num_experts"], \
        c["experts_per_token"]
    total = 0
    for i in range(S):
        pos = P + i
        for H, KV, hd, W in c["layers"][lo:hi]:
            keys = sum(1 for k in range(pos + 1) if not W or pos - k < W)
            total += (d * H * hd + 2 * d * KV * hd + H * hd * d   # q k v o
                      + d * E                                     # router
                      + K * (2 * d * ff + ff * d)                 # K experts
                      + H * 2 * hd * keys)                        # QK^T, PV
    if logits:
        total += d * c["vocab_size"]
    return 2 * total


@pytest.mark.parametrize("S,P,lo,hi", [(12, 0, 0, 4), (5, 9, 1, 3),
                                       (1, 30, 0, 4), (20, 3, 3, 4)])
def test_model_flops(S, P, lo, hi):
    c = mellum2.sizes(config(), True)
    logits = hi == len(c["layers"])
    assert mellum2.prefill_flops(c, S, P, lo, hi, logits) == \
        brute_flops(c, S, P, lo, hi, logits)
    assert mellum2.decode_flops(c, 17) == brute_flops(c, 1, 17, 0, 4, True)


def test_reference_routes_top_k_renormalised():
    """At the rehearsal's size the reference's expert sum equals a direct
    loop over each token's top-K experts with renormalised gates."""
    c = mellum2.sizes(config(), True)
    w = mellum2.reference_layout(mellum2.draw(c, 5, torch.device("cpu"),
                                              torch.float32))
    ref = check.load_reference(config())(c, w)
    p = {k: v.float() for k, v in w["layers"][0].items()}
    x = torch.randn((9, c["d_model"]), generator=torch.Generator().manual_seed(1))
    got = ref._experts(p, x)
    h = ref._norm(x, p["ln2"])
    want = x.clone()
    for t in range(9):
        pr = torch.softmax(h[t] @ p["router"], -1)
        top, idx = pr.topk(c["experts_per_token"])
        for g, e in zip(top / top.sum(), idx.tolist()):
            y = torch.nn.functional.silu(h[t] @ p["w_gate"][e]) * (h[t] @ p["w_up"][e])
            want[t] += g * (y @ p["w_down"][e])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def traced(quanta, decodes, stats, b4_s=2.0):
    c = mellum2.sizes(config(), False)
    spans = devtrace.Spans()
    spans.quanta, spans.decodes = list(quanta), [list(d) for d in decodes]
    return SimpleNamespace(
        trace={"by_op": {"moe_grouped_gemm_tc_kernel(x)": b4_s, "gemm": 1.0},
               "window_s": 4.0}, spans=spans, sizes=c, stats=stats,
        elt_bytes=2, peaks={"flops": 1e12, "bytes_per_s": 1e10})


def test_b4_roofline_from_shapes_and_tallies():
    c = mellum2.sizes(config(), False)
    stats = {"moe_layer_runs.prefill": 10, "moe_experts_touched.prefill": 640,
             "moe_layer_runs.decode_2": 28, "moe_experts_touched.decode_2": 420}
    quanta = [(100, 0, 0, 28, True), (40, 0, 3, 4, False)]
    r = traced(quanta, [[5, 9]], stats)
    d, ff = c["d_model"], c["d_ff"]

    def least(rows, experts):
        flops = 6 * d * ff * rows
        nbytes = 3 * (experts * d * ff + rows * (d + ff)) * 2
        return max(flops / 1e12, nbytes / 1e10)
    want = 28 * least(800, 64) + least(320, 64) + 28 * least(16, 15)
    got = run.load_reader("moe_grouped_gemm_roofline")(r)
    assert got == pytest.approx(100 * want / 2.0, rel=1e-12)
    assert mg.work(c, 8, 3, 2) == (6 * d * ff * 8, 3 * (3 * d * ff + 8 * (d + ff)) * 2)
    # no counters (a program without them), or no B4 kernel: no reading
    assert run.load_reader("moe_grouped_gemm_roofline")(traced(quanta, [], {})) is None
    assert run.load_reader("moe_grouped_gemm_roofline")(
        traced(quanta, [], stats, b4_s=0.0)) is None


def test_experts_per_decode_layer():
    read = run.load_reader("moe.experts_per_decode_layer")
    st = {"moe_layer_runs.decode_1": 28, "moe_experts_touched.decode_1": 224,
          "moe_layer_runs.decode_3": 56, "moe_experts_touched.decode_3": 1000,
          "moe_layer_runs.prefill": 5, "moe_experts_touched.prefill": 320}
    assert read(SimpleNamespace(stats=st)) == pytest.approx(1224 / 84)
    assert read(SimpleNamespace(stats={})) is None


def test_rehearsal_reads_correct_with_the_counter():
    """The cell's rehearsal on the CPU (--trace 1): `correct` true, the
    counter metric read; B4's roofline needs the card's trace, so the
    rehearsal has none."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        CELL, "--seed", str(2 ** 31 + 77), "--seconds", "2",
                        "--trace", "1", "--rehearse", "1"],
                       cwd=BENCH.parent, env=env, capture_output=True,
                       text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    m = out["metrics"]
    assert 0 < m["moe.experts_per_decode_layer"]["value"] <= 8   # E
    assert "moe_grouped_gemm_roofline" not in m

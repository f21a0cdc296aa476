#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each (a failing phase raises and the run exits non-zero):

1. build     — compile the hand CUDA kernels from ``src/repro_torch/csrc``
               (one nvcc per source, in parallel), report the card, ptxas's
               registers and spills, B1's wgmma (HGMMA) and TMA
               (UTMALDG) instruction counts and the tensor-core (HMMA)
               count of every bf16 B3 kernel, from cuobjdump (none: fail);
2. kernels   — each kernel against its plain PyTorch version in bf16 at the
               main paths' shapes (atol = rtol = 2e-2; B1 also to 5e-3 in
               ||got - want|| / ||want|| per (batch, head) against the plain
               version in f32, a limit that a dropped key tile, emulated in
               the plain version, must exceed), with median times of the
               kernel, the plain version and, as a yardstick only,
               ``scaled_dot_product_attention`` (``library_ms``; none for
               the SSD scan, which no PyTorch call computes).  ``ms`` and
               ``library_ms`` are calls issued one by one, the host's launch
               cost included, ``host_us`` the wrapper's host work per call;
               ``graph_ms`` and
               ``library_graph_ms`` the same calls replayed from a CUDA
               graph (device time).  A case bound by bytes cycles through
               copies of its inputs, so what a call reads has left the L2
               cache.  Each case has its bound, ``tflops`` and
               ``share_of_bound`` (bound / ms).  Two identical B1 calls must
               be bit-equal.  B3 in bf16 is held the same way on y and the
               state (``kernels/checks.py``: SSD_REL_TOL, against a dropped
               64-token u-tile), at 4 x 2048 for both models, a ragged
               length and one 16384-token prompt alone.  Untimed edge cases
               hold B1, B2 and B3 to their plain versions at the edges of
               their tiles, splits and chunks, B3 also at a slow decay that
               carries the state across 17 chunks (a cut state passing and
               a dropped entering state must read above the limit), and
               B3's f32 kernel to 2e-5, the encoder-decoder's edges: B1
               with one query row, causal and across to 1024 frames, B1
               unmasked over 1024 frames, B2 over a full 1024-key cross
               cache, and B1 and B2 in f32 at the shapes the ``claims``
               phase gives them (4 q / 2 KV heads of 64, 128-token
               context) to 2e-5, where the last key or 64 keys dropped
               must read above the limit (``edge_cases``, through
               ``kernels/checks.py``);
3. engine    — full-width mistral_7b (random bf16 weights from a seed) on one
               ReplicaEngine: a preempted 1536-token prefill resumes bit for
               bit, and a prefix-cache hit runs the suffix prefill at
               q_offset 256 and agrees with a from-scratch prefill;
4. serve     — the same model behind MiniCluster(pecsched) serving 16
               requests (12 shorts, 4 longs), with each kernel's launch
               count read around this run (the dense main path);
5. profile   — torch.profiler over decode iterations at 8 slots: wall and
               device-busy time per iteration and the top kernels;
6. claims    — the 26 engine specs of the smoke grid (1,378 requests, the
               analytic clock) through ``experiments.run_sweep`` on the card,
               over the reference's reduced f32 stack: every engine-side
               claim passes, B1 and B2 launch, and two smoke_mini specs run
               again on the CPU and on the card give the same summaries
               (the same decisions) and the same greedy tokens;
7. cluster   — ``launch/serve_cluster.py`` at the full width and depth of
               mistral_7b in bf16: 2 + 1 engines with a 4096-token context,
               the measured clock, 24 azure_default requests at 4x the
               measured short capacity (the long runs 3,488 tokens and
               claims both general engines) under pecsched
               and fifo, each served with its target length of in-vocab
               tokens, pecsched preempting the long at least once; serving
               metrics, launches, and the measured seconds per prefill layer
               beside the cost model's;
8. overhead  — ``launch/engine_overhead.py`` at full width: context switch,
               suspension state against the KV, KV migration;
9. ssm       — full-width mamba2_130m,
10. hybrid   — full-width zamba2_2_7b,
11. moe      — olmoe_1b_7b at full width and depth (64 experts, top 8),
12. audio    — seamless_m4t_large_v2 at full width and depth (24 encoder
               and 24 decoder layers), and
13. vlm      — internvl2_76b at full width and 24 of its 80 layers (all 80
               do not fit one card in bf16), each with random bf16 weights
               from seed 0 through ``launch/quickstart.py``: prefill of 4 x
               2048 positions (vlm: 256 patch embeddings + 1792 tokens;
               audio: 1024 encoder frames and a BOS decoder prompt), then 32
               greedy decode steps, with launches read around the prefill
               and around the decode steps (each family's main path) and
               checked exactly, and a profile of 4 more decode steps and of
               one more prefill (device idle share, operations per step);
14. invariant — the five models in f32 at full width (depth cut where
               ``INVARIANT_MODELS`` says): after prefill, decode_step's
               logits equal the last logits of a forward over the extended
               sequence.

Then one JSON line with every kernel's numbers (launches summed over the
serve, claims, cluster, overhead, ssm, hybrid, moe, audio and vlm phases)
and, last, the result line ``{"ok": true, "device": {...}}``.  The script exits non-zero without a
result line when CUDA is absent or the port's sources are not beside it.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 2e-2                      # bf16: atol = rtol
REL_TOL = 5e-3                  # bf16 B1: ||got - want|| / ||want|| per (batch, head)
#: claims: the share of requests whose greedy tokens are the same on the CPU
#: and the card (a near tie between the top two logits may flip one argmax
#: between devices, and then that request's later tokens)
GREEDY_AGREEMENT = 0.95
#: cluster: arrivals over the measured short capacity.  The long's prefill
#: is bound by the card (32 layers of ~3.4 ms at 3,488 tokens) and a short's
#: service by the host (decode iterations), so the arrival rate the
#: calibration gives moves with the host's speed: at 4x the shorts behind
#: the long arrive inside its prefill, at 1.2x they may come after it ends
CLUSTER_UTILIZATION = 4.0
HBM_BPS = 3.35e12               # H100 SXM data sheet
BF16_FLOPS = 989e12


def _say(phase: str, **fields) -> None:
    print(f"{phase}: {json.dumps(fields)}", flush=True)


def _eager(calls, reps: int = 10, trials: int = 5):
    """(ms, host_us): median over `trials` of the mean per-call time of
    `reps` back-to-back calls issued one by one, timed with CUDA events
    after a warm-up call of each, and the host's own time per call (the
    wrapper's work up to the launch returning).  `calls` is one call or a
    list taken in turn (`_copies`)."""
    import torch
    calls = calls if isinstance(calls, list) else [calls]
    for fn in calls:
        fn()
    times, host = [], []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for i in range(reps):
            calls[i % len(calls)]()
        host.append(1e6 * (time.perf_counter() - t0) / reps)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times), statistics.median(host)


def _median_ms(calls, reps: int = 10, trials: int = 5) -> float:
    """The device-timed part of `_eager`."""
    return _eager(calls, reps, trials)[0]


def _graph_ms(calls, reps: int = 20, trials: int = 5) -> float:
    """Device time per call: median over `trials` of one replay of a CUDA
    graph holding `reps` calls (taken in turn from `calls`, as in
    `_eager`), timed with CUDA events.  Unlike `_eager`, this
    leaves out the host's cost of each launch, which bounds a short
    kernel's time issued one by one."""
    import torch
    calls = calls if isinstance(calls, list) else [calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # warm-up outside capture
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            calls[i % len(calls)]()
    graph.replay()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    del graph
    return statistics.median(times)


def _kernel_times(calls):
    """A kernel's `ms` (issued one by one), `host_us` (its wrapper's host
    work per call) and `graph_ms` (device time)."""
    ms, host_us = _eager(calls)
    return dict(ms=ms, host_us=host_us, graph_ms=_graph_ms(calls))


def _copies(torch, dev, nbytes, bound_by, tensors):
    """`tensors` and, for a case bound by bytes, clones of them: enough
    sets that cycling through them reads twice the L2 cache's size between
    two reads of one set, so each call finds its inputs out of L2 as a
    serving step finds each layer's.  One set for a case bound by
    operations, whose inputs are reread from L2 by design."""
    n = 1
    if bound_by == "bytes":
        l2 = torch.cuda.get_device_properties(dev).L2_cache_size
        n = 1 + -(-2 * l2 // nbytes)
    return [tensors] + [tuple(t.clone() for t in tensors) for _ in range(n - 1)]


def _visible_pairs(sq, kv_len, causal, window, q_offset):
    """(query, key) pairs attention must compute for these inputs, per
    batch element: the work the data needs, not the padded maximum."""
    total = 0
    for kl in kv_len:
        for i in range(sq):
            qpos = i + q_offset
            hi = min(kl, qpos + 1) if causal else kl
            lo = max(0, qpos - window + 1) if window else 0
            total += max(0, hi - lo)
    return total


def _bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of operations over the bf16 peak and
    bytes over the memory rate."""
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BPS
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def _timed(row, flops, nbytes):
    """Add to a case its bound, the achieved rate and the share of the
    bound the kernel reaches (bound_ms / ms), also on device time."""
    bound_ms, bound_by = _bound(flops, nbytes)
    row.update(bound_ms=bound_ms, bound_by=bound_by,
               tflops=flops / (row["ms"] * 1e-3) / 1e12,
               share_of_bound=bound_ms / row["ms"],
               graph_share_of_bound=bound_ms / row["graph_ms"])
    return row


def _sass_functions(lib_path):
    """{mangled function name: its SASS} of a built library, from cuobjdump."""
    from repro_torch.kernels import _build
    exe = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(exe), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return {chunk.split("\n", 1)[0].strip(): chunk
            for chunk in sass.split("Function : ")[1:]}


def _sass_counts(lib_path):
    """Tensor-core (HGMMA, i.e. wgmma) and TMA (UTMALDG) instructions in each
    tensor-core kernel of B1's library."""
    counts = {}
    for fn, body in _sass_functions(lib_path).items():
        m = re.search(r"fa_tc_kernelILi(\d+)E", fn)
        if m:
            counts[f"fa_tc_kernel<{m.group(1)}>"] = {
                op: len(re.findall(rf"\b{op}\b", body)) for op in ("HGMMA", "UTMALDG")}
    if len(counts) != 3 or not all(min(c.values()) > 0 for c in counts.values()):
        raise AssertionError(f"B1's tensor-core kernels lack wgmma or TMA: {counts}")
    return counts


def _ssd_sass_counts(lib_path):
    """Tensor-core instructions (HMMA, i.e. mma.sync) in every instantiation
    of B3's three bf16 product kernels: (instantiations, least, most)."""
    counts = {}
    for fn, body in _sass_functions(lib_path).items():
        for kernel in ("cb_kernel", "state_kernel", "out_kernel"):
            if kernel in fn:
                counts.setdefault(kernel, []).append(len(re.findall(r"\bHMMA\b", body)))
    if set(counts) != {"cb_kernel", "state_kernel", "out_kernel"} \
            or min(min(c) for c in counts.values()) == 0:
        raise AssertionError(f"B3's bf16 kernels lack tensor-core HMMA: {counts}")
    return {k: dict(instantiations=len(c), hmma_min=min(c), hmma_max=max(c))
            for k, c in counts.items()}


def phase_kernels(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels.checks import rel_err
    from repro_torch.kernels.flash_attention import flash_attention, torch_attention
    from repro_torch.kernels.flash_decode import flash_decode, split_plan, torch_decode

    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)

    def check(name, got, want):
        err = (got.float() - want.float()).abs().max().item()
        if not torch.allclose(got.float(), want.float(), atol=TOL, rtol=TOL):
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version, max |err| {err} (tol {TOL})")
        return err

    def check_rel(name, got, want):
        rel = rel_err(got, want)
        if not rel < REL_TOL:
            raise AssertionError(f"{name}: ||got - want|| / ||want|| {rel} in a "
                                 f"(batch, head) (limit {REL_TOL})")
        return rel

    cases, rows = [], {}
    # flash attention: prefill quantum, suffix after a cache hit, window
    # (mistral_7b: H 32, KV 8, D 128); zamba2's shared block (MHA, D 80);
    # olmoe_1b_7b's prefill (MHA 16, D 128); seamless_m4t_large_v2's encoder
    # (unmasked over 1024 frames, MHA 16, D 64) and its decoder's BOS row
    # across to those frames; internvl2_76b's prefill (64 q / 8 KV heads).
    # q is a transposed (B, S, H, D) view, as attention_block passes it.
    for name, B, H, KV, D, sq, sk, qo, win, ragged, causal in (
            ("fa_causal_1536", 1, 32, 8, 128, 1536, 1536, 0, 0, False, True),
            ("fa_suffix_256_at_256", 1, 32, 8, 128, 256, 512, 256, 0, False, True),
            ("fa_window64_512_ragged", 2, 32, 8, 128, 512, 512, 0, 64, True, True),
            ("fa_mha_d80_causal_2048", 4, 32, 32, 80, 2048, 2048, 0, 0, False, True),
            ("fa_olmoe_mha16_causal_2048", 4, 16, 16, 128, 2048, 2048, 0, 0, False,
             True),
            ("fa_audio_enc_noncausal_1024_d64", 4, 16, 16, 64, 1024, 1024, 0, 0,
             False, False),
            ("fa_audio_cross_sq1_1024_d64", 4, 16, 16, 64, 1, 1024, 0, 0, False,
             False),
            ("fa_vlm_gqa8_causal_2048", 4, 64, 8, 128, 2048, 2048, 0, 0, False,
             True)):
        q = rn(B, sq, H, D).transpose(1, 2)
        k, v = rn(B, KV, sk, D), rn(B, KV, sk, D)
        kl = [sk, sk - 77] if ragged else [sk] * B
        kvl = torch.tensor(kl, dtype=torch.int32, device=dev) if ragged else None
        kw = dict(causal=causal, sliding_window=win, q_offset=qo, kv_len=kvl)
        got = flash_attention(q, k, v, **kw)
        # the plain version in f32 on the same bf16 inputs; rounded to bf16
        # it is torch_attention(q, k, v) itself
        want = torch_attention(q.float(), k.float(), v.float(), **kw)
        err = check(name, got, want.to(q.dtype))
        rel = check_rel(name, got, want)
        # the reading of a fault: the last 128-key tile of each sequence
        # dropped (the plain version with kv_len 128 shorter)
        fault = rel_err(torch_attention(q.float(), k.float(), v.float(), **dict(
            kw, kv_len=torch.tensor(kl, dtype=torch.int32, device=dev) - 128)).to(
                q.dtype), want)
        if not fault > REL_TOL:
            raise AssertionError(f"{name}: a dropped key tile reads {fault}, "
                                 f"inside the limit {REL_TOL}")
        del want
        if not torch.equal(got, flash_attention(q, k, v, **kw)):
            raise AssertionError(f"{name}: two identical calls differ")
        qpos = torch.arange(sq, device=dev)[:, None] + qo
        kpos = torch.arange(sk, device=dev)[None]
        mask = ((qpos >= kpos) if causal else True) & ((qpos - kpos < win) if win
                                                      else True)
        mask = mask & (kpos[None, None] < torch.tensor(kl, device=dev)[:, None, None,
                                                                       None])
        dense = qo == 0 and win == 0 and not ragged and (sq == sk or not causal)
        pairs = _visible_pairs(sq, kl, causal, win, qo)
        flops = 4 * H * D * pairs
        k_rows = sum(min(x, sq + qo) if causal else x for x in kl)
        nbytes = 2 * (2 * B * H * sq * D + 2 * KV * k_rows * D)
        sets = _copies(torch, dev, nbytes, _bound(flops, nbytes)[1], (q, k, v))
        calls = [lambda t=t: flash_attention(*t, **kw) for t in sets]
        lib = [(lambda t=t: F.scaled_dot_product_attention(*t, is_causal=causal,
                                                           enable_gqa=True))
               if dense else
               (lambda t=t: F.scaled_dot_product_attention(*t, attn_mask=mask,
                                                           enable_gqa=True))
               for t in sets]
        row = _timed(dict(max_abs_err=err, tol=TOL, rel_err=rel, rel_tol=REL_TOL,
                          fault_rel_err=fault, bit_equal_repeat=True,
                          copies=len(sets), **_kernel_times(calls),
                          plain_ms=_median_ms(lambda: torch_attention(q, k, v, **kw),
                                              3, 3),
                          library_ms=_median_ms(lib), library_graph_ms=_graph_ms(lib)),
                     flops, nbytes)
        del sets, calls, lib
        cases.append(dict(case=name, pairs=pairs, **row))
        rows.setdefault("flash_attention", row)
    # flash decode: 8 slots with ragged cache lengths, with and without
    # window (mistral_7b), zamba2's shared block (MHA, D 80), olmoe_1b_7b's
    # decode (4 x ~2048, MHA 16, D 128), seamless_m4t_large_v2's cross
    # attention over a full cache of 1024 frames (MHA 16, D 64) and
    # internvl2_76b's decode (8 query heads per KV head, 4 x ~2080)
    for name, B, S, H, KV, D, win, full in (
            ("fd_b8_s2048_ragged_win0", 8, 2048, 32, 8, 128, 0, False),
            ("fd_b8_s2048_ragged_win64", 8, 2048, 32, 8, 128, 64, False),
            ("fd_mha_d80_b8_s2048_ragged", 8, 2048, 32, 32, 80, 0, False),
            ("fd_olmoe_mha16_b4_s2088_ragged", 4, 2088, 16, 16, 128, 0, False),
            ("fd_audio_cross_b4_s1024_d64", 4, 1024, 16, 16, 64, 0, True),
            ("fd_vlm_rep8_b4_s2080_ragged", 4, 2080, 64, 8, 128, 0, False)):
        q, k, v = rn(B, H, D), rn(B, KV, S, D), rn(B, KV, S, D)
        cl = torch.randint(1, S + 1, (B,), generator=g, device=dev,
                           dtype=torch.int32)
        cl[0] = S
        if full:
            cl.fill_(S)
        err = check(name, flash_decode(q, k, v, cl, sliding_window=win),
                    torch_decode(q, k, v, cl, sliding_window=win))
        kpos = torch.arange(S, device=dev)[None]
        valid = kpos < cl[:, None]
        if win:
            valid &= kpos >= cl[:, None] - win
        mask = valid[:, None, None, :]
        read = sum(min(x, win) if win else x for x in cl.tolist())
        nbytes = 2 * (2 * KV * D * read + 2 * B * H * D)
        flops = 4 * H * D * read
        n_split, chunk = split_plan(B, KV, S, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        sets = _copies(torch, dev, nbytes, _bound(flops, nbytes)[1], (q, k, v))
        calls = [lambda t=t: flash_decode(*t, cl, sliding_window=win) for t in sets]
        lib = [lambda t=t: F.scaled_dot_product_attention(
            t[0][:, :, None], t[1], t[2], attn_mask=mask, enable_gqa=True)
            for t in sets]
        row = _timed(dict(max_abs_err=err, tol=TOL, copies=len(sets),
                          **_kernel_times(calls),
                          plain_ms=_median_ms(lambda: torch_decode(
                              q, k, v, cl, sliding_window=win)),
                          library_ms=_median_ms(lib), library_graph_ms=_graph_ms(lib)),
                     flops, nbytes)
        del sets, calls, lib
        cases.append(dict(case=name, tokens_read=read, n_split=n_split,
                          split_keys=chunk, blocks=KV * B * n_split, **row))
        rows.setdefault("flash_decode", row)
    edges = _edge_cases(torch, dev, g, rn)
    edges += _ssd_edge_cases(torch, dev, g)
    _ssd_cases(torch, dev, g, cases, rows)
    _say("kernels", cases=cases, edge_cases=edges)
    return rows


def _edge_cases(torch, dev, g, rn):
    """B1 and B2 in bf16 at the edges of their tiling and splits, each
    against its plain version (`kernels/checks.py`: 2e-2, B1 also B1_REL_TOL
    in relative norm, repeats bit-equal), untimed: B1 with ragged Sq/Sk, a
    q_offset with Sq < Sk, a window across tile edges, ragged kv_len and
    rows with no visible key (output 0, LSE -inf where the plain version
    has it), at D 64/80/128; B2 with cache_len 0, 1, under one split, on a
    split boundary, one past it and S, with windows across a boundary; and
    the encoder-decoder's edges (`checks.cross_edge_checks`): B1 with one
    query row, causal and across to 1024 frames, B1 unmasked over 1024, B2
    over a full 1024-key cross cache; and B1 and B2 in f32 at the evaluation
    path's engine shapes (`checks.engine_f32_checks`)."""
    from repro_torch.kernels.checks import (attention_check, cross_edge_checks,
                                            decode_check, engine_f32_checks)
    from repro_torch.kernels.flash_decode import split_plan
    out = []
    for name, B, H, KV, D, sq, sk, causal, win, qo, kvl in (
            ("fa_ragged_100_at_60_of_160_d64", 2, 16, 4, 64, 100, 160, True, 0, 60,
             [160, 155]),
            ("fa_window70_200_d128", 1, 32, 8, 128, 200, 200, True, 70, 0, None),
            ("fa_noncausal_kvlen37_d80", 2, 8, 8, 80, 130, 130, False, 0, 0, [130, 37]),
            ("fa_empty_rows_d128", 2, 32, 8, 128, 96, 192, True, 17, -8, [192, 0])):
        q = rn(B, sq, H, D).transpose(1, 2)
        k, v = rn(B, KV, sk, D), rn(B, KV, sk, D)
        kv_len = torch.tensor(kvl, dtype=torch.int32, device=dev) if kvl else None
        out.append(attention_check(name, q, k, v, causal=causal, sliding_window=win,
                                   q_offset=qo, kv_len=kv_len))
    B, KV, S = 8, 8, 2048
    n_split, chunk = split_plan(B, KV, S, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    cl = torch.tensor([0, 1, chunk // 3, chunk, chunk + 1, S, 2 * chunk - 5, S - 1],
                      dtype=torch.int32, device=dev)
    for D, H in ((128, 32), (80, 8), (64, 64)):
        q, k, v = rn(B, H, D), rn(B, KV, S, D), rn(B, KV, S, D)
        for win in (0, chunk // 2 + 3):
            name = f"fd_split_edges_d{D}_rep{H // KV}_win{win}"
            out.append(dict(decode_check(name, q, k, v, cl, sliding_window=win),
                            n_split=n_split, split_keys=chunk))
    out += cross_edge_checks(generator=g, device=dev)
    # their own generator: the draws above and below stay as they were
    return out + engine_f32_checks(
        generator=torch.Generator(device=dev).manual_seed(16), device=dev)


def _ssd_cases(torch, dev, g, cases, rows):
    """B3 at both models' prefill shapes (4 x 2048), at the models' own
    chunks, with a ragged length, and one 16384-token prompt alone; y and
    the final state checked as `checks.ssd_check` says, then timed."""
    from repro_torch.kernels.checks import ssd_check, ssd_inputs
    from repro_torch.kernels.ssd_kernel import chunk_len, ssd_scan, torch_ssd_scan
    for name, b, nh, hd, ns, chunk, s, init in (
            ("ssd_mamba2_130m_b4_s2048", 4, 24, 64, 128, 256, 2048, True),
            ("ssd_zamba2_b4_s2048", 4, 80, 64, 64, 64, 2048, False),
            ("ssd_mamba2_130m_b4_s2000_ragged", 4, 24, 64, 128, 256, 2000, False),
            # one long prompt prefilled alone, the traffic PecSched preempts for
            ("ssd_mamba2_130m_b1_s16384", 1, 24, 64, 128, 256, 16384, True)):
        xbc, x, dt, A, B, C, D, h0 = ssd_inputs(b, s, nh, hd, ns, init=init,
                                                generator=g, device=dev)
        kw = dict(chunk=chunk, init_state=h0, return_state=True)
        checked = ssd_check(name, x, dt, A, B, C, D, chunk=chunk, init_state=h0)
        # work this input needs: C.B^T once per (batch, chunk) pair t >= u,
        # scores.x per head, and C.h and the state update per token
        pairs = sum(n * (n + 1) // 2 for n in
                    [chunk] * (s // chunk) + ([s % chunk] if s % chunk else []))
        flops = (2 * b * pairs * ns + 2 * b * nh * pairs * hd
                 + 4 * b * nh * s * hd * ns)
        nbytes = (2 * (2 * b * s * nh * hd + 2 * b * s * ns) + 4 * b * s * nh
                  + 4 * 2 * nh + 4 * b * nh * hd * ns * (2 if init else 1))

        def call(xbc, dt, h0=None):
            x = xbc[..., :nh * hd].reshape(b, s, nh, hd)
            return ssd_scan(x, dt, A, xbc[..., nh * hd:nh * hd + ns],
                            xbc[..., nh * hd + ns:], D, **dict(kw, init_state=h0))
        sets = _copies(torch, dev, nbytes, _bound(flops, nbytes)[1],
                       (xbc, dt) + ((h0,) if init else ()))
        calls = [lambda t=t: call(*t) for t in sets]
        # device time of each of the call's kernels (the four passes in bf16)
        passes = _profile_steps(torch, calls[0], 3)["top_kernels_ms_per_iter"]
        row = _timed(dict(checked, copies=len(sets), passes_ms=passes,
                          **_kernel_times(calls),
                          plain_ms=_median_ms(lambda: torch_ssd_scan(x, dt, A, B, C, D,
                                                                     **kw), 3, 3),
                          library_ms=None), flops, nbytes)
        del sets, calls
        cases.append(dict(case=name, chunk=chunk, kernel_chunk=chunk_len(s, ns),
                          flops=flops, bytes=nbytes, **row))
        rows.setdefault("ssd_scan", row)


def _ssd_edge_cases(torch, dev, g):
    """B3 untimed on `checks.ssd_edge_cases` (the edges of its 64-token
    tiles and its chunk, and a slow decay over 17 chunks with the carry
    faults) at ns 64 and 128, b 1 and 2, as `checks.ssd_check` holds it;
    and the f32 CUDA-core kernel to 2e-5 (dt in Mamba2's initial range, as
    tests/test_torch_cuda.py draws it)."""
    from repro_torch.kernels.checks import ssd_check, ssd_edge_cases, ssd_inputs
    from repro_torch.kernels.ssd_kernel import chunk_len, ssd_scan, torch_ssd_scan
    out = []
    for ns, nh in ((64, 5), (128, 3)):
        for b in (1, 2):
            for s, init, slow in ssd_edge_cases(ns, b):
                name = (f"ssd_{'slow' if slow else 'edges'}_ns{ns}_b{b}_s{s}"
                        f"{'_init' if init else ''}")
                _, x, dt, A, B, C, D, h0 = ssd_inputs(b, s, nh, 64, ns, init=init,
                                                      generator=g, device=dev,
                                                      slow=slow)
                out.append(dict(case=name, kernel_chunk=chunk_len(s, ns),
                                **ssd_check(name, x, dt, A, B, C, D, chunk=64,
                                            init_state=h0, carry=slow)))
    _, x, dt, A, B, C, D, h0 = ssd_inputs(2, 300, 3, 64, 128, init=True, generator=g,
                                          device=dev, dtype=torch.float32,
                                          dt_shift=4.0)
    kw = dict(chunk=256, init_state=h0, return_state=True)
    y, h = ssd_scan(x, dt, A, B, C, D, **kw)
    wy, wh = torch_ssd_scan(x, dt, A, B, C, D, **kw)
    err = max((y - wy).abs().max().item(), (h - wh).abs().max().item())
    if not (torch.allclose(y, wy, atol=2e-5, rtol=2e-5)
            and torch.allclose(h, wh, atol=2e-5, rtol=2e-5)):
        raise AssertionError(f"ssd f32: CUDA-core kernel off its plain version by {err}")
    out.append(dict(case="ssd_f32_b2_s300_ns128", max_abs_err=err, tol=2e-5))
    return out


def phase_engine(torch, dev, cfg, params):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serving.engine import ReplicaEngine

    eng = ReplicaEngine(cfg, params, max_len=2048, layers_per_quantum=2,
                        device=dev)
    rng = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, 1536), generator=rng)

    def run(st):
        done = st.layer >= cfg.num_layers
        while not done:
            st, done = eng.prefill_quantum(st)
        return st

    t0 = time.perf_counter()
    ref = run(eng.start_prefill(0, toks))
    ref_logits = eng.prefill_logits(ref)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    st = eng.start_prefill(1, toks)
    for _ in range(2):                               # 2 quanta, then preempted
        st, _ = eng.prefill_quantum(st)
    other = run(eng.start_prefill(2, toks[:, :300]))  # another request runs
    eng.prefill_logits(other)
    st = run(st)                                     # resumed
    bit_exact = (torch.equal(eng.prefill_logits(st), ref_logits)
                 and all(torch.equal(a, b) for a, b in
                         zip(st.kv_k + st.kv_v, ref.kv_k + ref.kv_v)))
    if not bit_exact:
        raise AssertionError("preempted prefill did not resume bit for bit")
    del ref, st, other

    a = torch.randint(0, cfg.vocab_size, (512,), generator=rng)
    b = torch.cat([a[:256], torch.randint(0, cfg.vocab_size, (256,),
                                          generator=rng)])
    host_a = tuple(a.tolist())
    host_b = tuple(b.tolist())
    st_a = run(eng.start_prefill(10, a[None], host_tokens=host_a))
    eng.cache_prompt(10, *st_a.full_kv(), host_tokens=host_a)
    hit, pk, pv = eng.lookup_cached_prefix(host_b)
    if hit.n_tokens != 256 or pk is None:
        raise AssertionError(f"prefix cache missed: hit {hit.n_tokens} tokens")
    before = flash_attention.launches
    st_c = run(eng.start_prefill(11, b[None], prefix_k=pk, prefix_v=pv,
                                 host_tokens=host_b))
    suffix_launches = flash_attention.launches - before
    if st_c.prefix_len != 256 or suffix_launches != cfg.num_layers:
        raise AssertionError("suffix prefill did not run the attention kernel "
                             f"at q_offset 256 once per layer ({suffix_launches})")
    hit_logits = eng.prefill_logits(st_c).float()
    scratch_logits = eng.prefill_logits(run(eng.start_prefill(12, b[None]))).float()
    err = (hit_logits - scratch_logits).abs().max().item()
    if not torch.allclose(hit_logits, scratch_logits, atol=TOL, rtol=TOL):
        raise AssertionError(f"cache-hit logits differ from scratch by {err}")
    if int(hit_logits.argmax()) != int(scratch_logits.argmax()):
        raise AssertionError("cache-hit and scratch prefills chose other tokens")
    _say("engine", prefill_1536_s=prefill_s, preempt_resume_bit_exact=True,
         prefix_hit_tokens=hit.n_tokens, suffix_attention_launches=suffix_launches,
         cache_hit_vs_scratch_max_abs_err=err, tol=TOL,
         argmax_equal=True)
    del eng


def phase_serve(torch, dev, cfg, params):
    import numpy as np

    from repro_torch.serving import MiniCluster, ServeRequest

    max_new = 16
    mc = MiniCluster(cfg, params, n_engines=2, policy="pecsched", max_len=2048,
                     long_threshold=512, layers_per_quantum=2, device=dev)
    rng = np.random.default_rng(0)
    longs = {1, 4, 7, 10}
    t = 0.0
    for i in range(16):
        is_long = i in longs
        n = int(rng.integers(1024, 1537) if is_long else rng.integers(32, 257))
        mc.submit(ServeRequest(rid=i, arrival=t, max_new=max_new, is_long=is_long,
                               tokens=rng.integers(0, cfg.vocab_size, n).astype(np.int32)))
        t += float(rng.exponential(0.03))
    torch.cuda.reset_peak_memory_stats()
    _, wall, counts = _run_counted(torch, mc.run)
    launches = {n: counts[n] for n in ("flash_attention", "flash_decode")}
    done = {r.rid: r for r in mc.done}
    if len(done) != 16 or any(len(r.generated) != max_new for r in done.values()):
        raise AssertionError("not every request completed with max_new tokens: "
                             f"{ {r.rid: len(r.generated) for r in mc.done} }")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never ran on the serving path: {launches}")
    for r in done.values():
        if not all(0 <= x < cfg.vocab_size for x in r.generated):
            raise AssertionError(f"request {r.rid} generated an invalid token")

    def stats(xs):
        return {"mean": float(np.mean(xs)), "p99": float(np.percentile(xs, 99))}
    ttft = [r.first_token - r.arrival for r in done.values()]
    tpot = [(r.finish - r.first_token) / (max_new - 1) for r in done.values()]
    be = mc.backend
    _say("serve", requests=len(done), wall_s=wall, metrics=mc.metrics(),
         ttft_s=stats(ttft), tpot_s=stats(tpot),
         decode_tokens=be.stats["decode_tokens"], decode_s=be.decode_s,
         decode_tokens_per_s=be.stats["decode_tokens"] / be.decode_s,
         prefill_quanta=be.stats["prefill_quanta"],
         prefix_cache=be.prefix_cache_stats(), launches=launches,
         launches_per_request={k: v / len(done) for k, v in launches.items()},
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches


def phase_profile(torch, dev, cfg, params):
    """Where a decode iteration's time goes at the serving batch (8 slots of
    ~256 cached tokens): wall time per iteration, the device's busy share
    over it and the kernels that take the most device time."""
    from repro_torch.serving.engine import ReplicaEngine

    eng = ReplicaEngine(cfg, params, max_len=2048, device=dev)
    g = torch.Generator().manual_seed(2)
    slots = {}
    for rid in range(eng.max_slots):
        st = eng.start_prefill(rid, torch.randint(0, cfg.vocab_size, (1, 256),
                                                  generator=g))
        done = False
        while not done:
            st, done = eng.prefill_quantum(st)
        slots[eng.admit(rid, st)] = int(eng.prefill_logits(st)[0].argmax())
    for _ in range(2):                               # warm: view built, caches hot
        slots = eng.decode_iteration(slots)
    state = {"slots": slots}

    def step():
        state["slots"] = eng.decode_iteration(state["slots"])
    _say("profile", what="decode_iteration, 8 slots x 256 tokens",
         **_profile_steps(torch, step, 5))
    del eng


def phase_claims(torch, dev):
    """The engine cells of the smoke grid (`experiments.smoke_grid`, all on
    the analytic clock) on torch engines on the card, over the reference's
    reduced f32 stack (2 layers, d_model 256, 4 q / 2 KV heads of 64): every
    engine-side claim must evaluate and pass, and B1 and B2 must launch.
    Two smoke_mini specs then run on the CPU and again on the card: their
    summaries must equal the sweep's apart from the wall-clock fields (on
    the analytic clock decisions do not depend on numerics, so this holds
    the decisions, not the kernels), and at least GREEDY_AGREEMENT of their
    requests must generate the same greedy tokens on both.  The kernels'
    numerics at these shapes are held in the kernels phase
    (`checks.engine_f32_checks`)."""
    import repro_torch.experiments as ex
    from repro_torch.experiments import runner

    specs = [s for s in ex.smoke_grid() if s.backend == "engine"]
    results, wall, counts = _run_counted(
        torch, lambda: ex.run_sweep(specs, device=dev))
    cres = [r for r in ex.evaluate_claims(ex.smoke_sweep_cells(results))
            if r.backend == "engine"]
    failed = [(r.cid, r.skipped or r.value) for r in cres
              if r.skipped or not r.passed]
    if failed:
        raise AssertionError(f"claims: engine-side claims failed on the card: "
                             f"{failed}")
    launches = {n: counts[n] for n in ("flash_attention", "flash_decode")}
    if min(launches.values()) == 0:
        raise AssertionError(f"claims: a kernel never ran: {launches}")
    volatile = ("wall_s", "sched_time_s")
    again = [s for s in specs
             if s.scenario == "smoke_mini" and s.policy in ("pecsched", "fifo")]
    agree = {}
    for spec in again:
        tokens = {}
        for where in ("cpu", dev):
            summary = ex.run_spec(spec, device=where)
            diff = sorted(k for k in set(summary) | set(results[spec])
                          if k not in volatile
                          and summary.get(k) != results[spec].get(k))
            if diff:
                raise AssertionError(f"claims: {spec.key()} run on {where} "
                                     f"differs from the card's sweep in {diff}")
            backend = runner.engine_stack(spec.model, spec.engine_clock, where)[3]
            tokens[str(where)] = {r: list(t) for r, t in backend.generated.items()}
        cpu, card = tokens["cpu"], tokens[str(dev)]
        if {r: len(t) for r, t in cpu.items()} != {r: len(t) for r, t in card.items()}:
            raise AssertionError(f"claims: {spec.key()} generated other lengths "
                                 "on the CPU and the card")
        agree[spec.policy] = dict(
            requests=len(cpu), tokens=sum(map(len, cpu.values())),
            equal_requests=sum(cpu[r] == card[r] for r in cpu),
            equal_tokens=sum(a == b for r in cpu for a, b in zip(cpu[r], card[r])))
        if agree[spec.policy]["equal_requests"] < GREEDY_AGREEMENT * len(cpu):
            raise AssertionError(f"claims: {spec.key()} greedy tokens on the CPU "
                                 f"and the card: {agree[spec.policy]} (at least "
                                 f"{GREEDY_AGREEMENT} of the requests equal)")
    _say("claims", specs=len(specs),
         requests=sum(s.n_requests for s in specs),
         claims_passed=sum(r.passed for r in cres), claims_total=len(cres),
         wall_s=wall, launches=counts,
         cpu_summaries_equal=[s.policy for s in again],
         cpu_card_greedy=agree, greedy_agreement_min=GREEDY_AGREEMENT)
    return counts


def phase_cluster(torch, dev):
    """launch/serve_cluster.py at the full width and depth of mistral_7b in
    bf16: 2 general engines + 1 decode engine with a 4096-token context,
    the measured clock, the azure_default scenario (24 requests, 16 new
    tokens each; a request's engine prompt is its cluster length over 64,
    so the long runs 3,488 tokens) under pecsched and fifo, arriving at
    CLUSTER_UTILIZATION times the measured short capacity; the prefill
    target is fitted so the long claims both general engines.  Every
    request completes with its target length of in-vocab tokens, and
    pecsched preempts the long's prefill at least once.  Per policy: the
    serving metrics and the kernels' launches; then the measured seconds
    per prefill layer of the long beside the cost model's.  The summary's
    TTFT and TPOT (``sim_`` keys) are not engine times: the policy stamps
    them on the virtual clock with the cost model's price of the trace's
    cluster-scale output lengths (the engines decode at most 16 of them),
    so the engines' own time per output token is
    `decode_ms_per_iteration`."""
    from repro_torch.launch import serve_cluster

    stack = serve_cluster.build(device=dev, max_new=16)
    trace = serve_cluster.make_trace(stack, "azure_default", 24,
                                     utilization=CLUSTER_UTILIZATION)
    reqs = trace["requests"]
    longs = [r for r in reqs if r.is_long]
    totals = dict.fromkeys(_counters(), 0)
    per_policy = {}
    for policy in ("pecsched", "fifo"):
        torch.cuda.reset_peak_memory_stats()
        r, wall, counts = _run_counted(
            torch, lambda: serve_cluster.run_policy(stack, reqs, policy))
        if len(r["done"]) != len(reqs):
            raise AssertionError(f"cluster: {policy} completed {len(r['done'])} "
                                 f"of {len(reqs)} requests")
        for rid, toks in r["generated"].items():
            if len(toks) != r["target_new"][rid]:
                raise AssertionError(f"cluster: {policy} request {rid} generated "
                                     f"{len(toks)} of {r['target_new'][rid]}")
            if not all(0 <= t < stack.cfg.vocab_size for t in toks):
                raise AssertionError(f"cluster: {policy} request {rid} generated "
                                     "a token outside the vocab")
        if min(counts["flash_attention"], counts["flash_decode"]) == 0:
            raise AssertionError(f"cluster: a kernel never ran: {counts}")
        s = r["summary"]
        if policy == "pecsched" and not s["preemptions"] > 0:
            raise AssertionError("cluster: pecsched never preempted the long's "
                                 "prefill")
        per_policy[policy] = dict(
            done=len(r["done"]), short_qd_mean_s=s["short_qd_mean"],
            short_qd_p99_s=s["short_qd_pct"]["99"],
            long_jct_mean_s=s["long_jct_mean"], preemptions=s["preemptions"],
            sim_ttft_mean_s=s["ttft_mean"], sim_ttft_p99_s=s["ttft_pct"]["99"],
            sim_tpot_mean_s=s["tpot_mean"],
            decode_tokens=r["decode_tokens"],
            decode_tokens_per_s=r["decode_tokens"] / r["decode_s"],
            decode_tokens_per_iteration=r["decode_tokens"] / r["decode_iters"],
            decode_ms_per_iteration=1e3 * r["decode_s"] / r["decode_iters"],
            measured_s=r["measured_s"], wall_s=wall, launches=counts,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
        for n in totals:
            totals[n] += counts[n]
    cfg = stack.cfg
    _say("cluster", arch="mistral_7b", layers=cfg.num_layers, d_model=cfg.d_model,
         dtype=cfg.dtype, engines="2+1", max_len=stack.backend.max_len,
         clock="measured", scenario="azure_default", requests=len(reqs),
         longs=len(longs), utilization=CLUSTER_UTILIZATION,
         arrival_rps=trace["rps"], max_new=16,
         prefill_target_s=stack.em.target_prefill_s,
         long_claims=[stack.em.replicas_needed(r.input_len) for r in longs],
         engine_prompt_tokens=sorted({stack.backend.prompt_len(r) for r in reqs}),
         policies=per_policy,
         prefill_layer=serve_cluster.layer_seconds(stack, reqs))
    return totals


def phase_overhead(torch, dev):
    """launch/engine_overhead.py at full width (mistral_7b bf16, a long of
    1536 tokens paused halfway for a 16-token short)."""
    from repro_torch.launch import engine_overhead

    out, _, counts = _run_counted(torch, lambda: engine_overhead.run(device=dev))
    _say("overhead", launches=counts, **out)
    return counts


def _profile_steps(torch, step, n):
    """torch.profiler over n calls of step(): wall and device-busy time per
    call, the device's idle share and the kernels taking the most time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel, launched = {}, 0
    for e in prof.key_averages():
        # device-side kernel events only: an operator's own entry repeats
        # the time of the kernels it launched
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us
            launched += e.count
    busy = sum(per_kernel.values()) / 1e6
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return dict(iterations=n, wall_ms_per_iter=1e3 * wall / n,
                device_busy_ms_per_iter=(1e3 * busy / n) if busy else "not measured",
                device_idle_share=(1 - busy / wall) if busy else "not measured",
                device_ops_per_iter=launched / n if busy else "not measured",
                top_kernels_ms_per_iter={k[:60]: v / 1e3 / n for k, v in top})


def _counters():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.ssd_kernel import ssd_scan
    return {"flash_attention": flash_attention, "flash_decode": flash_decode,
            "ssd_scan": ssd_scan}


def _run_counted(torch, fn):
    """fn() with every launch count set to 0 just before it and read just
    after; returns (fn's result, wall seconds to the card's end, counts)."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {n: c.launches for n, c in counters.items()}


def _expect(phase, what, got, want):
    if got != want:
        raise AssertionError(f"{phase}: {what} launched {got} times, "
                             f"expected {want}")


def _expected_launches(cfg):
    """{kernel: (launches per prefill, per decode step)} on a model's main
    path through the model API."""
    n, fam = cfg.num_layers, cfg.family
    if fam in ("ssm", "hybrid"):
        attn = n // cfg.attn_every if cfg.attn_every else 0
        return {"ssd_scan": (n, 0), "flash_attention": (attn, 0),
                "flash_decode": (0, attn)}
    if fam == "audio":      # encoder, decoder self and cross attention
        return {"ssd_scan": (0, 0), "flash_attention": (cfg.encoder_layers + 2 * n, 0),
                "flash_decode": (0, 2 * n)}
    return {"ssd_scan": (0, 0), "flash_attention": (n, 0), "flash_decode": (0, n)}


def _nbytes(tree):
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def phase_model(torch, dev, phase, arch, layers=None, cut=None):
    """A model's main path at full width in bf16 (random weights from seed
    0) through launch/quickstart.py: prefill of 4 sequences of 2048
    positions (vlm: 256 patch embeddings and 1792 tokens; audio: 1024
    encoder frames and a BOS decoder prompt), then 32 greedy decode steps,
    with each kernel's launches checked exactly, and a profile of 4 more
    decode steps and of one more prefill.  `layers` cuts the depth."""
    from repro_torch.configs import get_config
    from repro_torch.launch import quickstart
    from repro_torch.models import decode_step, init_params

    cfg = get_config(arch)
    full_layers = cfg.num_layers
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    B, S, N = 4, 2048, 32
    prompt_len = S - cfg.frontend_tokens if cfg.family == "vlm" else S
    params = init_params(cfg, seed=0, device=dev)
    weights_gb = _nbytes(params) / 1e9
    # warm-up at a short prompt: first-call costs stay out of the timings
    lg, cache = quickstart.start(cfg, params, quickstart.make_batch(
        cfg, B, 64, seed=1, device=dev), 3)
    quickstart.greedy(cfg, params, cache, lg, 3)
    del cache, lg
    batch = quickstart.make_batch(cfg, B, prompt_len, seed=0, device=dev)
    torch.cuda.reset_peak_memory_stats()
    (lg, cache), prefill_s, pre = _run_counted(
        torch, lambda: quickstart.start(cfg, params, batch, N + 8))
    prefill_finite = bool(torch.isfinite(lg).all())
    (toks, finite), decode_s, dec = _run_counted(
        torch, lambda: quickstart.greedy(cfg, params, cache, lg, N + 1))
    if not (prefill_finite and finite):
        raise AssertionError(f"{phase}: a logit is not finite")
    if not all(0 <= int(t.min()) and int(t.max()) < cfg.vocab_size for t in toks):
        raise AssertionError(f"{phase}: a generated token is out of the vocab")
    for name, (per_prefill, per_step) in _expected_launches(cfg).items():
        _expect(phase, f"{name} per prefill", pre[name], per_prefill)
        _expect(phase, f"{name} over {N} decode steps", dec[name], per_step * N)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # where a decode step's time goes: 4 more steps under the profiler
    prof = _profile_steps(torch, lambda: decode_step(cfg, params, cache, toks[-1]), 4)
    # and a prefill's: one more under the profiler
    del cache, lg
    pre_prof = _profile_steps(torch, lambda: quickstart.start(cfg, params, batch,
                                                              N + 8), 1)
    extra = dict(layers_full=full_layers, cut=cut) if layers else {}
    _say(phase, arch=arch, family=cfg.family, layers=cfg.num_layers, **extra,
         d_model=cfg.d_model, dtype=cfg.dtype, weights_gb=weights_gb, batch=B,
         prefill_positions=S, prompt_tokens=batch["tokens"].shape[1],
         prefill_s=prefill_s, prefill_positions_per_s=B * S / prefill_s,
         decode_steps=N, decode_ms_per_step=1e3 * decode_s / N,
         decode_tokens_per_s=B * N / decode_s, launches_prefill=pre,
         launches_decode=dec, logits_finite=True, max_memory_allocated_gb=peak_gb,
         decode_step_profile=prof, prefill_profile=pre_prof)
    return {n: pre[n] + dec[n] for n in pre}


#: the invariant's models (f32, full width): (arch, layers kept, why cut)
INVARIANT_MODELS = (
    ("mamba2_130m", 12, "12 of 24 layers"),
    ("zamba2_2_7b", 12, "12 of 54 layers (two hybrid segments)"),
    ("olmoe_1b_7b", None, None),
    ("seamless_m4t_large_v2", None, None),
    ("internvl2_76b", 12, "12 of 80 layers: 3.4 GB each in f32"))


def phase_invariant(torch, dev):
    """The serving invariant on the card, in f32 at full width (depth cut
    where `INVARIANT_MODELS` says): prefill's logits equal the last logits
    of forward (1e-3), and decode_step's after prefill equal forward's over
    the extended sequence (5e-3), the tolerances of tests/test_models.py;
    moe with the dropless capacity factor E, as there.  2 sequences of 300
    tokens (vlm: after 256 patch embeddings; audio: against 1024 frames)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import quickstart
    from repro_torch.models import decode_step, forward, init_params

    errs, cuts = {}, {}
    for arch, layers, cut in INVARIANT_MODELS:
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
            cuts[arch] = cut
        params = init_params(cfg, seed=0, device=dev)
        batch = quickstart.make_batch(cfg, 2, 300, seed=2, device=dev)
        batch["tokens"] = quickstart.make_prompt(cfg, 2, 300, seed=2, device=dev)
        cf = float(cfg.num_experts) if cfg.family == "moe" else None
        logits, _ = forward(cfg, params, batch, moe_cf=cf)
        lg, cache = quickstart.start(cfg, params, batch, 1)
        tok = lg.argmax(-1)
        lg2, _ = decode_step(cfg, params, cache, tok)
        full, _ = forward(cfg, params, dict(
            batch, tokens=torch.cat([batch["tokens"], tok[:, None]], 1)), moe_cf=cf)
        for what, got, want, tol in (("prefill", lg, logits[:, -1], 1e-3),
                                     ("decode", lg2, full[:, -1], 5e-3)):
            err = (got - want).abs().max().item()
            if not torch.allclose(got, want, atol=tol, rtol=tol):
                raise AssertionError(f"invariant: {arch} {what} logits differ "
                                     f"from forward by {err} (tol {tol})")
            errs[f"{arch}_{what}_max_abs_err"] = err
        del params, cache, logits, full
        torch.cuda.empty_cache()
    _say("invariant", dtype="float32", batch=2, prompt_len=300, depth_cut=cuts,
         tol_prefill=1e-3, tol_decode=5e-3, **errs)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import init_params

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    build_s = _build.build_all()
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln
                 or ("spill" in ln and "0 bytes spill stores, 0 bytes spill loads"
                     not in ln)]
             for n, log in _build.build_logs.items()}
    _say("build", build_s=build_s, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi, ptxas_registers=ptxas,
         b1_sass=_sass_counts(_build._lib_path("flash_attention")),
         b3_bf16_sass=_ssd_sass_counts(_build._lib_path("ssd_scan_tc")))
    print(smi.splitlines()[0], flush=True)

    rows = phase_kernels(torch, dev)
    cfg = get_config("mistral_7b")                 # full width and depth, bf16
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    _say("model", arch="mistral_7b", layers=cfg.num_layers, d_model=cfg.d_model,
         dtype=cfg.dtype, init_s=time.perf_counter() - t0,
         weights_gb=torch.cuda.memory_allocated() / 1e9)
    phase_engine(torch, dev, cfg, params)
    torch.cuda.empty_cache()
    launches = dict.fromkeys(_counters(), 0)
    launches.update(phase_serve(torch, dev, cfg, params))
    torch.cuda.empty_cache()
    phase_profile(torch, dev, cfg, params)
    del params
    torch.cuda.empty_cache()
    for phase in (phase_claims, phase_cluster, phase_overhead):
        for name, n in phase(torch, dev).items():
            launches[name] += n
        torch.cuda.empty_cache()
    for phase, arch, layers, cut in (
            ("ssm", "mamba2_130m", None, None),
            ("hybrid", "zamba2_2_7b", None, None),
            ("moe", "olmoe_1b_7b", None, None),
            ("audio", "seamless_m4t_large_v2", None, None),
            ("vlm", "internvl2_76b", 24,
             "24 of 80 layers: 80 are ~141 GB in bf16, over one card's 80 GB")):
        for name, n in phase_model(torch, dev, phase, arch, layers, cut).items():
            launches[name] += n
        torch.cuda.empty_cache()
    phase_invariant(torch, dev)

    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:85"),
               "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                                "src/repro/kernels/flash_decode.py:72"),
               "ssd_scan": ("src/repro_torch/csrc/ssd_scan_tc.cu",
                            "src/repro/kernels/ssd_kernel.py:74")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = rows[name]
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=launches[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

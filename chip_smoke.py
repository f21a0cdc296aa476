#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each (a failing phase raises and the run exits non-zero):

1. build   — compile the hand CUDA kernels from ``src/repro_torch/csrc``
             (one nvcc per source, in parallel) and report the card;
2. kernels — each kernel against its plain PyTorch version in bf16 at the
             serving path's shapes (atol = rtol = 2e-2), with median times of
             the kernel, the plain version and, as a yardstick only,
             ``scaled_dot_product_attention`` (``library_ms``);
3. engine  — full-width mistral_7b (random bf16 weights from a seed) on one
             ReplicaEngine: a preempted 1536-token prefill resumes bit for
             bit, and a prefix-cache hit runs the suffix prefill at
             q_offset 256 and agrees with a from-scratch prefill;
4. serve   — the same model behind MiniCluster(pecsched) serving 16
             requests (12 shorts, 4 longs), with each kernel's launch count
             read around this run (the main path);
5. profile — torch.profiler over decode iterations at 8 slots: wall and
             device-busy time per iteration and the top kernels.

Then one JSON line with every kernel's numbers and, last, the result line
``{"ok": true, "device": {...}}``.  The script exits non-zero without a
result line when CUDA is absent or the port's sources are not beside it.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 2e-2                      # bf16: atol = rtol
HBM_BPS = 3.35e12               # H100 SXM data sheet
BF16_FLOPS = 989e12


def _say(phase: str, **fields) -> None:
    print(f"{phase}: {json.dumps(fields)}", flush=True)


def _median_ms(fn, reps: int = 10, trials: int = 5) -> float:
    """Median over `trials` of the mean per-call time of `reps` back-to-back
    calls, timed with CUDA events after one warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


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


def phase_kernels(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, torch_attention
    from repro_torch.kernels.flash_decode import flash_decode, torch_decode

    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)

    def check(name, got, want):
        err = (got.float() - want.float()).abs().max().item()
        if not torch.allclose(got.float(), want.float(), atol=TOL, rtol=TOL):
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version, max |err| {err} (tol {TOL})")
        return err

    cases, rows = [], {}
    H, KV, D = 32, 8, 128
    # flash attention: prefill quantum, suffix after a cache hit, window
    for name, B, sq, sk, qo, win, ragged in (
            ("fa_causal_1536", 1, 1536, 1536, 0, 0, False),
            ("fa_suffix_256_at_256", 1, 256, 512, 256, 0, False),
            ("fa_window64_512_ragged", 2, 512, 512, 0, 64, True)):
        q, k, v = rn(B, H, sq, D), rn(B, KV, sk, D), rn(B, KV, sk, D)
        kvl = (torch.tensor([sk, sk - 77], dtype=torch.int32, device=dev)
               if ragged else None)
        kw = dict(causal=True, sliding_window=win, q_offset=qo, kv_len=kvl)
        err = check(name, flash_attention(q, k, v, **kw),
                    torch_attention(q, k, v, **kw))
        kl = kvl.tolist() if ragged else [sk] * B
        qpos = torch.arange(sq, device=dev)[:, None] + qo
        kpos = torch.arange(sk, device=dev)[None]
        mask = (qpos >= kpos) & ((qpos - kpos < win) if win else True)
        mask = mask[None, None] & (kpos[None, None] < torch.tensor(
            kl, device=dev)[:, None, None, None])
        lib = ((lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                       enable_gqa=True))
               if (qo == 0 and win == 0 and not ragged and sq == sk) else
               (lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                       enable_gqa=True)))
        pairs = _visible_pairs(sq, kl, True, win, qo)
        flops = 4 * H * D * pairs
        k_rows = sum(min(x, sq + qo) for x in kl)
        nbytes = 2 * (2 * B * H * sq * D + 2 * KV * k_rows * D)
        row = dict(max_abs_err=err, tol=TOL,
                   ms=_median_ms(lambda: flash_attention(q, k, v, **kw)),
                   plain_ms=_median_ms(lambda: torch_attention(q, k, v, **kw), 3, 3),
                   library_ms=_median_ms(lib),
                   bound_ms=1e3 * max(flops / BF16_FLOPS, nbytes / HBM_BPS),
                   bound_by="operations" if flops / BF16_FLOPS > nbytes / HBM_BPS
                   else "bytes")
        cases.append(dict(case=name, pairs=pairs, **row))
        rows.setdefault("flash_attention", row)
    # flash decode: 8 slots with ragged cache lengths, with and without window
    B, S = 8, 2048
    q, k, v = rn(B, H, D), rn(B, KV, S, D), rn(B, KV, S, D)
    cl = torch.randint(1, S + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    cl[0] = S
    for win in (0, 64):
        name = f"fd_b8_s2048_ragged_win{win}"
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
        row = dict(max_abs_err=err, tol=TOL,
                   ms=_median_ms(lambda: flash_decode(q, k, v, cl, sliding_window=win)),
                   plain_ms=_median_ms(lambda: torch_decode(q, k, v, cl,
                                                            sliding_window=win)),
                   library_ms=_median_ms(lambda: F.scaled_dot_product_attention(
                       q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)),
                   bound_ms=1e3 * max(flops / BF16_FLOPS, nbytes / HBM_BPS),
                   bound_by="bytes" if nbytes / HBM_BPS >= flops / BF16_FLOPS
                   else "operations")
        cases.append(dict(case=name, tokens_read=read, **row))
        rows.setdefault("flash_decode", row)
    _say("kernels", cases=cases)
    return rows


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

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
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
    flash_attention.launches = 0
    flash_decode.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mc.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "flash_decode": flash_decode.launches}
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
    from torch.profiler import ProfilerActivity, profile

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
    torch.cuda.synchronize()
    n = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            slots = eng.decode_iteration(slots)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = {}
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
    busy = sum(per_kernel.values()) / 1e6
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    _say("profile", what="decode_iteration, 8 slots x 256 tokens",
         iterations=n, wall_ms_per_iter=1e3 * wall / n,
         device_busy_ms_per_iter=(1e3 * busy / n) if busy else "not measured",
         device_idle_share=(1 - busy / wall) if busy else "not measured",
         top_kernels_ms_per_iter={k[:60]: v / 1e3 / n for k, v in top})
    del eng


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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    build_s = _build.build_all()
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
             for n, log in _build.build_logs.items()}
    _say("build", build_s=build_s, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi, ptxas_registers=ptxas)
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
    launches = phase_serve(torch, dev, cfg, params)
    torch.cuda.empty_cache()
    phase_profile(torch, dev, cfg, params)

    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:85"),
               "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                                "src/repro/kernels/flash_decode.py:72")}
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

"""Real-execution microbenchmarks on the port's replica engine (the twin of
the reference's ``benchmarks/engine_overhead.py``, paper §5.1/§6.5):

  * context-switch cost — the extra time of a long prefill paused halfway
    for a short one and resumed, over the uninterrupted prefill and the
    short's own prefill in the same repetition (the paper's preemption
    overhead);
  * suspension-state size — the paused prefill's intermediate activation
    bytes against the KV bytes of the finished prefill (the reference's
    measure) and of the layers completed at the pause (the paper's "<5 %
    of the KV", §5.1);
  * KV migration cost — admitting a finished prefill into another engine's
    paged decode pool (§5.2 disaggregation).

By default it runs the FULL mistral_7b config in bf16 on the card with a
long of 1536 tokens; ``--device cpu --layers N`` runs the reference's
reduced f32 case (a long of 96 tokens, ``N`` layers).  Each time is the
median of ``--reps`` runs after a warm-up, synchronised with the card.

    PYTHONPATH=src python -m repro_torch.launch.engine_overhead
    PYTHONPATH=src python -m repro_torch.launch.engine_overhead --device cpu --layers 8
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from typing import Dict

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.hardware import resolve_device
from repro_torch.models import init_params
from repro_torch.serving.engine import ReplicaEngine

SHORT = 16


def run(*, layers: int = 0, seq_long: int = 0, device="cuda",
        reps: int = 5) -> Dict:
    """The three measurements on mistral_7b: the full config with a long of
    1536 tokens, or (``layers`` > 0) the reduced f32 build with a long of
    96; `seq_long` overrides the long's length."""
    dev = resolve_device(device)
    cfg = get_config("mistral_7b")
    if layers:
        cfg = dataclasses.replace(reduced_config(cfg, layers=layers),
                                  dtype="float32", sliding_window=0)
    seq_long = seq_long or (96 if layers else 1536)
    max_len = max(128, 1 << seq_long.bit_length())     # > seq_long
    params = init_params(cfg, seed=0, device=dev)
    eng = ReplicaEngine(cfg, params, max_len=max_len, layers_per_quantum=1,
                        device=dev)
    dec = ReplicaEngine(cfg, params, max_len=max_len, layers_per_quantum=1,
                        device=dev)
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (1, seq_long), generator=g)
    short = torch.randint(0, cfg.vocab_size, (1, SHORT), generator=g)
    n_layers = cfg.num_layers

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def finish(st):
        done = st.layer >= n_layers
        while not done:
            st, done = eng.prefill_quantum(st)
        return st

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    finish(eng.start_prefill(0, toks))          # warm-up: builds, first calls
    finish(eng.start_prefill(0, short))
    t_long, t_short, t_total, t_mig = [], [], [], []
    frac_full = frac_pause = 0.0
    for _ in range(reps):
        st, d = timed(lambda: finish(eng.start_prefill(0, toks)))
        t_long.append(d)
        _, d = timed(lambda: finish(eng.start_prefill(2, short)))
        t_short.append(d)

        def preempted():
            s = eng.start_prefill(1, toks)
            for _ in range(n_layers // 2):
                s, _ = eng.prefill_quantum(s)
            paused = s.intermediate_bytes() / max(s.kv_bytes(), 1)
            finish(eng.start_prefill(2, short))  # the preempting short
            return finish(s), paused
        (_, frac_pause), d = timed(preempted)
        t_total.append(d)
        frac_full = st.intermediate_bytes() / max(st.kv_bytes(), 1)
        slot, d = timed(lambda: dec.admit(0, st))  # the pool write = migration
        t_mig.append(d)
        dec.evict(slot)
    med = statistics.median
    # paired per repetition; negative when the switch costs less than the
    # spread between runs
    ctx = med([t - a - b for t, a, b in zip(t_total, t_long, t_short)])
    return {"arch": "mistral_7b", "layers": n_layers, "d_model": cfg.d_model,
            "dtype": cfg.dtype, "device": str(dev), "seq_long": seq_long,
            "seq_short": SHORT, "reps": reps,
            "t_long_prefill_ms": med(t_long) * 1e3,
            "t_short_prefill_ms": med(t_short) * 1e3,
            "t_preempted_total_ms": med(t_total) * 1e3,
            "context_switch_ms": ctx * 1e3,
            "context_switch_frac": ctx / med(t_long),
            "suspend_state_vs_kv": frac_full,
            "suspend_state_vs_kv_at_pause": frac_pause,
            "kv_migration_ms": med(t_mig) * 1e3,
            "kv_migrated_bytes": st.kv_bytes()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=0,
                    help="reduced f32 model with this many layers "
                         "(0 = the full config in bf16)")
    ap.add_argument("--seq-long", type=int, default=0,
                    help="the long prompt's tokens (0 = 1536 at full size, "
                         "96 reduced)")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    out = run(layers=args.layers, seq_long=args.seq_long, device=args.device,
              reps=args.reps)
    print(f"[engine] long prefill {out['t_long_prefill_ms']:.2f} ms, short "
          f"{out['t_short_prefill_ms']:.2f} ms, context switch "
          f"{out['context_switch_ms']:.3f} ms "
          f"({out['context_switch_frac'] * 100:.2f} % of the prefill)")
    print(f"[engine] suspension state = "
          f"{out['suspend_state_vs_kv'] * 100:.2f} % of the finished KV, "
          f"{out['suspend_state_vs_kv_at_pause'] * 100:.2f} % of the KV of "
          f"the layers done at the pause (paper §5.1: usually < 5 %)")
    print(f"[engine] KV migration to the decode engine: "
          f"{out['kv_migration_ms']:.2f} ms for {out['kv_migrated_bytes']:,} "
          f"bytes")
    print(json.dumps(out))


if __name__ == "__main__":
    main()

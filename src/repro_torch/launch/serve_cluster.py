"""End-to-end serving driver: any scheduling policy x any workload scenario
on a real-execution mini cluster of torch engines (the port's twin of the
reference's ``examples/serve_cluster.py``).

The scheduling brain is the same `make_policy` stack the analytic simulator
runs; execution is the port's `EngineBackend` over `ReplicaEngine`s —
layer-granular preemptible prefill, KV migration to the dedicated decode
engine, slot-chunked decode.  Virtual time advances by measured compute
(``--clock measured``, default) or by the cost-model estimate
(``--clock analytic``, the cross-backend parity mode).  The cost model
prices an H100 (`hardware.H100_SXM`).

By default it serves the FULL mistral_7b config in bf16 on the card (random
weights from seed 0) with a 4096-token context; ``--device cpu --layers N``
runs the reference's reduced f32 model (128-token context) on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.serve_cluster
    PYTHONPATH=src python -m repro_torch.launch.serve_cluster --device cpu --layers 2
    PYTHONPATH=src python -m repro_torch.launch.serve_cluster --policy all \\
        --scenario heavy_tail --n 32 --compare-sim

Scenario traces carry cluster-scale token counts.  On the reduced model the
backend maps them to engine-sized prompts (log-scaled, bucketed), as the
reference does; at full width a prompt is its cluster length over
FULL_TOKEN_DIVISOR (`scaled_prompts`), so a long runs thousands of tokens
and its prefill spans enough time for shorts to preempt it.  Gang
sequence-parallel prefill is not ported: on one card the gang degree is 1
and every long runs the single-replica path on the first replica it
claims.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import (POLICY_NAMES, ClusterConfig, ExecutionModel,
                              Phase, Simulator, get_scenario, list_scenarios,
                              make_policy)
from repro_torch.core.request import Request
from repro_torch.hardware import H100_SXM, resolve_device
from repro_torch.models import init_params
from repro_torch.serving.backend import EngineBackend


#: prefill latency target (s) that sizes a long's replica claim
#: (`ExecutionModel.replicas_needed`) on the reduced model: the reference's
#: 0.5 s, where a 300K-token long claims an SP group of 2-3.  At full width
#: the target is fitted to the trace (`fit_prefill_target`).
REDUCED_PREFILL_TARGET_S = 0.5
#: engine context: the reference's 128 tokens on the reduced model, 4096 at
#: full width (each engine's pool holds 9 sequences of KV and its decode
#: view 8, 9.1 GB in bf16; 3 engines and 14.5 GB of weights make ~42 GB)
REDUCED_MAX_LEN = 128
FULL_MAX_LEN = 4096
#: at full width a request's engine prompt is its cluster-scale length over
#: this, rounded up to 16 tokens, at least 16 and at most what the context
#: holds: a 222,947-token long runs 3,488 tokens, most shorts 16-64, so a
#: long's prefill costs what it costs against a short's in the trace
FULL_TOKEN_DIVISOR = 64


@dataclasses.dataclass
class ClusterStack:
    """The model, the cluster it is scheduled on and the engines.
    `fit_target`: `make_trace` refits `em`'s prefill target to the trace."""
    cfg: ModelConfig
    cc: ClusterConfig
    em: ExecutionModel
    backend: EngineBackend
    engines: int
    fit_target: bool = False


def scaled_prompts(cfg: ModelConfig, max_prompt: int, seed: int = 0):
    """Token provider for full-width engines: a request's prompt is
    input_len / FULL_TOKEN_DIVISOR rounded up to 16 tokens (16 to
    `max_prompt`), random from (seed, rid); a prefix group's requests share
    their scaled prefix, drawn from (seed, group), as the backend's own
    prompts do."""
    def length(n: int) -> int:
        return min(max_prompt, max(16, -(-n // (16 * FULL_TOKEN_DIVISOR)) * 16))

    def provide(req: Request) -> np.ndarray:
        n = length(req.input_len)
        toks = np.random.default_rng((seed, req.rid & 0x7FFFFFFF)).integers(
            0, cfg.vocab_size, n).astype(np.int32)
        if req.prefix_group is not None and req.prefix_len > 0:
            p = min(length(req.prefix_len), n)
            toks[:p] = np.random.default_rng(
                (seed, 0x9E3779B9, req.prefix_group & 0x7FFFFFFF)).integers(
                    0, cfg.vocab_size, p)
        return toks
    return provide


def fit_prefill_target(em: ExecutionModel, reqs: List[Request],
                       engines: int) -> Optional[float]:
    """The prefill target at which the trace's longest long claims all
    `engines` general replicas and no long claims more (None without a
    long).  The reduced model's 0.5 s does this for a 300K-token long; at
    full width no fixed target does: the H100 cost model prices 223K tokens
    at 33 s on one replica and 400K at 97 s, so a target that makes the
    first claim 2 makes the second claim 4, more than the mini cluster
    has, and FIFO's head-of-line long would wait for them forever."""
    longest = max((r.input_len for r in reqs if r.is_long), default=0)
    if not longest:
        return None
    return em.prefill_time(longest, 1, sp_mode="local") / (engines - 0.5)


def build(*, layers: int = 0, device="cuda", engines: int = 2,
          clock: str = "measured", max_len: Optional[int] = None,
          max_new: int = 4, prefill_target: Optional[float] = None,
          seed: int = 0) -> ClusterStack:
    """mistral_7b on `engines` general engines + 1 decode engine: the full
    config in its own dtype with FULL_MAX_LEN and `scaled_prompts`, or
    (``layers`` > 0) the reference's reduced f32 build with that many
    layers, REDUCED_MAX_LEN and no sliding window.  `prefill_target`
    defaults to REDUCED_PREFILL_TARGET_S when reduced and is fitted to the
    trace at full width."""
    dev = resolve_device(device)
    cfg = get_config("mistral_7b")
    if layers:
        cfg = dataclasses.replace(reduced_config(cfg, layers=layers),
                                  dtype="float32", sliding_window=0)
    params = init_params(cfg, seed=0, device=dev)
    # one extra replica: PecSched dedicates it to decode, the baselines get
    # it back as general capacity — total engine count is equal either way
    cc = ClusterConfig(n_nodes=1, gpus_per_node=engines + 1, tp=1,
                       hw=H100_SXM, n_short_decode_replicas=1,
                       max_decode_concurrency=8)
    fit = prefill_target is None and not layers
    em = ExecutionModel(cfg, cc.replica_spec(),
                        target_prefill_s=prefill_target
                        or REDUCED_PREFILL_TARGET_S)
    backend = EngineBackend(cfg, params,
                            max_len=max_len or (REDUCED_MAX_LEN if layers
                                                else FULL_MAX_LEN),
                            layers_per_quantum=1, clock=clock,
                            max_new_cap=max_new, seed=seed, device=dev)
    if not layers:
        backend.token_provider = scaled_prompts(cfg, backend.max_prompt, seed)
    return ClusterStack(cfg, cc, em, backend, engines, fit)


def calibrate_rps(backend: EngineBackend, n_general: int,
                  utilization: float) -> float:
    """Measure one short prefill+decode and size the arrival rate so the
    general engines run at `utilization` x their short-service capacity
    (the engine-world analogue of workload.calibrate_short_capacity)."""
    eng = backend._engine(0)
    dt = 0.0
    for i, measure in ((-1, False), (-2, True)):    # first pass pays builds
        warm = Request(rid=i, arrival=0.0, input_len=1000, output_len=4)
        d = backend._complete_prefill(eng, warm)
        d += backend._decode_batch(eng, [warm])
        if measure:
            dt = d
    backend.reset()
    return utilization * n_general / max(dt, 1e-6)


def make_trace(stack: ClusterStack, scenario: str, n: int, *, seed: int = 0,
               utilization: float = 1.2, trace_csv: Optional[str] = None,
               warmup: bool = True) -> Dict:
    """The scenario's requests at the calibrated arrival rate (and, where
    `stack.fit_target`, the prefill target fitted to them); with `warmup`
    every engine-side prompt length runs once on every engine first, so the
    measured clock sees steady-state compute."""
    be = stack.backend
    rps = calibrate_rps(be, stack.engines, utilization)
    kw = {"path": trace_csv} if scenario == "csv" else {}
    reqs = get_scenario(scenario, n_requests=n, seed=seed, arrival_rps=rps,
                        **kw)
    target = fit_prefill_target(stack.em, reqs, stack.engines) \
        if stack.fit_target else None
    if target:
        stack.em = ExecutionModel(stack.cfg, stack.cc.replica_spec(),
                                  target_prefill_s=target)
    if warmup:
        be.warmup({be.prompt_len(r) for r in reqs}, range(stack.engines + 1))
    return {"requests": reqs, "rps": rps}


def run_policy(stack: ClusterStack, reqs: List[Request], policy: str, *,
               compare_sim: bool = False) -> Dict:
    """Serve `reqs` under `policy` on the engines: its summary, wall time,
    decode counters, the requests that completed and their tokens, and
    (`compare_sim`) the analytic SimBackend's summary of the same trace."""
    be = stack.backend
    be.reset()
    pol = make_policy(policy, stack.cc, stack.em)
    t0 = time.perf_counter()
    s = Simulator(pol, backend=be).run(copy.deepcopy(reqs))
    wall = time.perf_counter() - t0
    done = [r for r in pol.all_requests if r.phase == Phase.DONE]
    out = {"policy": policy, "summary": s, "wall_s": wall,
           "measured_s": be.measured_s, "decode_s": be.decode_s,
           "decode_tokens": be.stats["decode_tokens"],
           "decode_iters": be.stats["decode_iters"],
           "role_log": list(pol.role_log), "done": done,
           "generated": {r.rid: list(be.generated.get(r.rid, []))
                         for r in done},
           "target_new": {r.rid: be._target_new(r) for r in done}}
    if compare_sim:
        out["sim"] = Simulator(make_policy(policy, stack.cc, stack.em)).run(
            copy.deepcopy(reqs))
    return out


def layer_seconds(stack: ClusterStack, reqs: List[Request]) -> Dict:
    """Measured seconds per prefill layer on one replica (the median over
    the long prefills run so far, `sp_per_layer_s()[1]`) beside the cost
    model's estimate for one layer of the same engine-side prompt (the
    median long's), with that prompt's engine and cluster lengths."""
    measured = stack.backend.sp_per_layer_s().get(1)
    longs = sorted((r for r in reqs if r.is_long), key=stack.backend.prompt_len)
    if not longs:
        return {"long_engine_tokens": 0, "long_cluster_tokens": 0,
                "measured_s_per_layer": measured, "model_s_per_layer": None}
    mid = longs[len(longs) // 2]
    n = stack.backend.prompt_len(mid)
    return {"long_engine_tokens": n, "long_cluster_tokens": mid.input_len,
            "measured_s_per_layer": measured,
            "model_s_per_layer": stack.em.prefill_time(n, 1, sp_mode="local")
            / stack.cfg.num_layers}


def _ms(v) -> float:
    return (v if v is not None else float("nan")) * 1e3


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="pecsched,fifo",
                    help="comma-separated make_policy names, or 'all'")
    ap.add_argument("--scenario", default="azure_default")
    ap.add_argument("--list-scenarios", action="store_true")
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engines", type=int, default=2,
                    help="general engines (one more is added as the "
                         "PecSched decode pool / extra baseline capacity)")
    ap.add_argument("--clock", choices=("measured", "analytic"),
                    default="measured")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=0,
                    help="reduced f32 model with this many layers "
                         "(0 = the full config in bf16)")
    ap.add_argument("--max-len", type=int, default=None,
                    help="engine context (default: 128 reduced, 4096 at "
                         "full width)")
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--utilization", type=float, default=1.2,
                    help="arrival rate as a fraction of measured short "
                         "capacity (>1 forces queueing/preemption)")
    ap.add_argument("--prefill-target", type=float, default=None,
                    help="prefill latency target (s) driving how many "
                         "replicas a long claims (default: 0.5 reduced; at "
                         "full width fitted so the trace's longest long "
                         "claims every general engine)")
    ap.add_argument("--trace-csv", default=None,
                    help="path for --scenario csv")
    ap.add_argument("--compare-sim", action="store_true",
                    help="also replay the trace through the analytic "
                         "SimBackend and print both")
    args = ap.parse_args(argv)

    if args.list_scenarios:
        for name, desc in list_scenarios().items():
            print(f"{name:15s} {desc}")
        return
    policies = POLICY_NAMES if args.policy == "all" \
        else tuple(args.policy.split(","))
    stack = build(layers=args.layers, device=args.device,
                  engines=args.engines, clock=args.clock,
                  max_len=args.max_len, max_new=args.max_new,
                  prefill_target=args.prefill_target, seed=args.seed)
    trace = make_trace(stack, args.scenario, args.n, seed=args.seed,
                       utilization=args.utilization,
                       trace_csv=args.trace_csv)
    reqs = trace["requests"]
    print(f"mini cluster: {args.engines}+1 engines, model {stack.cfg.name} "
          f"({stack.cfg.num_layers} layers, {stack.cfg.dtype}) on "
          f"{stack.backend.device}, scenario {args.scenario!r}: {len(reqs)} "
          f"requests ({sum(r.is_long for r in reqs)} long) at "
          f"{trace['rps']:.1f} rps, clock={args.clock}")
    print(f"{'policy':14s} {'done':>7s} {'qd_mean':>9s} {'qd_p99':>9s} "
          f"{'ttft*':>9s} {'tpot*':>9s} {'longJCT':>9s} {'preempt':>7s} "
          f"{'compute':>8s} {'wall':>6s}")

    def row(name, s):
        return (f"{name:14s} {s['short_completed']:4d}+{s['long_completed']:d}L "
                f"{_ms(s['short_qd_mean']):8.1f}m "
                f"{_ms(s['short_qd_pct']['99']):8.1f}m "
                f"{_ms(s['ttft_mean']):8.1f}m {_ms(s['tpot_mean']):8.2f}m "
                f"{_ms(s['long_jct_mean']):8.1f}m {s['preemptions']:7d}")
    for policy in policies:
        r = run_policy(stack, reqs, policy, compare_sim=args.compare_sim)
        print(f"{row(policy, r['summary'])} {r['measured_s']:7.2f}s "
              f"{r['wall_s']:5.1f}s")
        if r["role_log"]:
            print("  role timeline: " + ", ".join(
                f"t={t * 1e3:.2f}ms r{rid} {old}->{new}"
                for t, rid, old, new in r["role_log"][:6]))
        if "sim" in r:
            print(f"  {row('(sim)', r['sim'])}")
    print("* the policy's stamps on the virtual clock, with the cost model's "
          "price of the trace's output lengths (the engines decode at most "
          f"{stack.backend.max_new_cap}): not engine times")
    ls = layer_seconds(stack, reqs)
    if ls["measured_s_per_layer"] is not None:
        print(f"prefill layer at {ls['long_engine_tokens']} tokens (a "
              f"{ls['long_cluster_tokens']}-token long): measured "
              f"{ls['measured_s_per_layer'] * 1e3:.3f} ms, cost model "
              f"{ls['model_s_per_layer'] * 1e3:.3f} ms")


if __name__ == "__main__":
    main()

"""Sweep runner: execute ExperimentSpecs on either backend, with an
on-disk JSON result cache and optional process-parallel execution (the
port of the reference's ``experiments/runner.py``, on torch engines).

One spec -> one `metrics.summarize` dict (plus runner bookkeeping:
`wall_s`, `sched_time_s`, `n_dispatches`, `_spec`).  Results are cached
per spec under ``<cache_dir>/<spec.key()>.<spec_hash>.json``; an engine
spec's file also names the device type it ran on
(``....<spec_hash>.cuda.json``), so a result measured on one device is
never handed to a run on another.  The hash covers every spec field plus
`spec.SCHEMA_VERSION`; the device is a runner argument, not a spec field.

Backends:

* ``backend="sim"``: the model's paper cluster (`workload.paper_cluster`)
  replayed analytically, exactly as the reference does.  Sim specs are
  pure functions of the spec and touch no device, so they are safe to fan
  out across processes (``workers > 1``; spawn context).

* ``backend="engine"``: the reference's reduced f32 build of the spec's
  model (2 layers, 128-token context, no sliding window) on the small
  real-engine cluster (2 general + 1 dedicated-decode replica), executed by
  the port's `EngineBackend` on `device` — the card unless the caller asks
  for the CPU.  Engines are reused across specs in-process (reset between
  runs), keyed by (model, clock, device).  Engine specs always run
  serially in-process.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import (ClusterConfig, Simulator, get_scenario,
                              make_policy)
from repro_torch.core.costmodel import ExecutionModel
from repro_torch.core.fleet import (FleetConfig, FleetController,
                                    reclamation_wave)
from repro_torch.core.workload import calibrate_short_capacity, paper_cluster
from repro_torch.experiments.spec import (PINNED_SCENARIOS, SCHEMA_VERSION,
                                          ExperimentSpec)
from repro_torch.hardware import resolve_device

# in-process caches: capacity calibration per model, engine stack per
# (model, clock, device) — both deterministic, both expensive to rebuild
_CAPACITY: Dict[str, float] = {}
_ENGINE_STACKS: Dict[Tuple[str, str, str], Tuple] = {}

ENGINE_LAYERS = 2
ENGINE_MAX_LEN = 128
#: engine-scale prefill latency target: tight enough that a 300K-token long
#: needs an SP group (replicas_needed >= 2) on the reduced model, so the
#: engine cells exercise the multi-replica claim and fast-SP pricing (the
#: gang itself collapses to one replica on a one-card host)
ENGINE_TARGET_PREFILL_S = 0.5


def short_capacity(model: str) -> float:
    cap = _CAPACITY.get(model)
    if cap is None:
        cc, em = paper_cluster(model)
        cap = _CAPACITY[model] = calibrate_short_capacity(cc, em)
    return cap


def engine_cluster(cfg) -> Tuple[ClusterConfig, ExecutionModel]:
    """The small real-engine topology every engine spec runs on: 2 general
    replicas + 1 dedicated short-decode replica (tests/test_backends.py)."""
    cc = ClusterConfig(n_nodes=1, gpus_per_node=3, tp=1,
                       n_short_decode_replicas=1, max_decode_concurrency=8)
    return cc, ExecutionModel(cfg, cc.replica_spec(),
                              target_prefill_s=ENGINE_TARGET_PREFILL_S)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


def engine_stack(model: str, clock: str, device="cuda"):
    """(cfg, cluster, em, backend) for engine specs on `device`, with the
    weights of `init_params(cfg, seed=0)` on the CPU; cached in-process
    per (model, clock, device)."""
    dev = resolve_device(device)
    key = (model, clock, str(dev))
    stack = _ENGINE_STACKS.get(key)
    if stack is None:
        from repro_torch.configs import get_config, reduced_config
        from repro_torch.models import init_params
        from repro_torch.serving.backend import EngineBackend
        cfg = dataclasses.replace(
            reduced_config(get_config(model), layers=ENGINE_LAYERS),
            dtype="float32", sliding_window=0)
        # drawn on the CPU and moved: the engines hold the same weights on
        # every device (a generator on the card draws other numbers)
        params = _to_device(init_params(cfg, seed=0, device="cpu"), dev)
        cc, em = engine_cluster(cfg)
        backend = EngineBackend(cfg, params, max_len=ENGINE_MAX_LEN,
                                layers_per_quantum=1, clock=clock, device=dev)
        stack = _ENGINE_STACKS[key] = (cfg, cc, em, backend)
    return stack


# ---------------------------------------------------------------------------
# workload + execution for one spec
# ---------------------------------------------------------------------------
def build_requests(spec: ExperimentSpec, cc, em) -> List:
    # fleet_* keys configure the churn layer (fleet_controller below), not
    # the trace builder
    overrides = {k: v for k, v in spec.overrides
                 if not k.startswith("fleet_")}
    if spec.scenario not in PINNED_SCENARIOS and "arrival_rps" not in overrides:
        if spec.backend == "sim":
            cap = short_capacity(spec.model)
        else:
            cap = calibrate_short_capacity(cc, em)
        overrides["arrival_rps"] = cap * spec.utilization
    return get_scenario(spec.scenario, n_requests=spec.n_requests,
                        seed=spec.seed, **overrides)


def fleet_controller(spec: ExperimentSpec, cc,
                     reqs: List) -> Optional[FleetController]:
    """Churn layer for one spec: the `churn` scenario gets a default 20%
    reclamation wave at the trace's first arrival quartile; `fleet_*`
    overrides (prefix stripped) pin or extend any `FleetConfig` field and
    activate the layer on any scenario.  Everything is a deterministic
    function of the spec + built trace, so cached results stay valid."""
    fo = {k[len("fleet_"):]: v for k, v in spec.overrides
          if k.startswith("fleet_")}
    if spec.scenario != "churn" and not fo:
        return None
    arrivals = sorted(r.arrival for r in reqs)
    span = arrivals[-1] - arrivals[0] if arrivals else 0.0
    wave_at = fo.pop("wave_at", None)
    if wave_at is None:
        wave_at = (arrivals[0] + 0.25 * span) if arrivals else 0.0
    wave_frac = fo.pop("wave_frac", 0.20)
    reclamations = fo.pop("reclamations", None)
    if reclamations is None:
        reclamations = reclamation_wave(float(wave_at), float(wave_frac),
                                        cc.n_replicas)
    else:
        reclamations = tuple((float(t), int(rid)) for t, rid in reclamations)
    # default notice window: 1% of the trace span — a real grace period on
    # both the seconds-scale sim timeline and the ms-scale engine timeline
    notice_s = float(fo.pop("notice_s", 0.01 * span))
    return FleetController(FleetConfig(reclamations=reclamations,
                                       notice_s=notice_s, **fo))


def run_spec(spec: ExperimentSpec, device="cuda") -> Dict:
    """Execute one spec to completion and return its summary dict; an
    engine spec runs its engines on `device`."""
    if spec.backend == "sim":
        cc, em = paper_cluster(spec.model)
        backend = None
    else:
        _, cc, em, backend = engine_stack(spec.model, spec.engine_clock,
                                          device)
        backend.reset()
    reqs = build_requests(spec, cc, em)
    policy = make_policy(spec.policy, cc, em)
    fleet = fleet_controller(spec, cc, reqs)
    sim = Simulator(policy, fleet=fleet) if backend is None \
        else Simulator(policy, backend=backend, fleet=fleet)
    t0 = time.perf_counter()
    summary = sim.run(reqs)
    summary["wall_s"] = time.perf_counter() - t0
    summary["sched_time_s"] = sim.sched_time
    summary["n_dispatches"] = sim.n_dispatches
    # JSON-normalized (tuples -> lists) so a live summary compares equal to
    # its cache-file round trip
    summary["_spec"] = json.loads(json.dumps(spec.to_dict()))
    return summary


def _run_spec_for_pool(spec_dict: Dict) -> Dict:
    return run_spec(ExperimentSpec.from_dict(spec_dict))


# ---------------------------------------------------------------------------
# sweep with on-disk cache
# ---------------------------------------------------------------------------
def _cache_path(cache_dir: Path, spec: ExperimentSpec, device: str) -> Path:
    tag = f".{device}" if spec.backend == "engine" else ""
    return cache_dir / f"{spec.key()}.{spec.spec_hash()}{tag}.json"


def _cache_load(cache_dir: Optional[Path], spec: ExperimentSpec,
                device: str) -> Optional[Dict]:
    if cache_dir is None:
        return None
    path = _cache_path(cache_dir, spec, device)
    if not path.exists():
        return None
    try:
        blob = json.loads(path.read_text())
    except (json.JSONDecodeError, OSError):
        return None
    if blob.get("schema") != SCHEMA_VERSION or \
            blob.get("hash") != spec.spec_hash():
        return None
    return blob["summary"]


def _cache_store(cache_dir: Optional[Path], spec: ExperimentSpec,
                 device: str, summary: Dict) -> None:
    if cache_dir is None:
        return
    cache_dir.mkdir(parents=True, exist_ok=True)
    blob = {"schema": SCHEMA_VERSION, "hash": spec.spec_hash(),
            "spec": spec.to_dict(), "summary": summary}
    if spec.backend == "engine":
        blob["device"] = device
    _cache_path(cache_dir, spec, device).write_text(
        json.dumps(blob, indent=1, default=float))


def run_sweep(specs: Sequence[ExperimentSpec], *,
              cache_dir: Optional[os.PathLike] = None,
              workers: int = 1, force: bool = False, device="cuda"
              ) -> Dict[ExperimentSpec, Dict]:
    """Run every spec (cache-aware) and return {spec: summary}.

    ``workers > 1`` fans *sim* specs out over a spawn-context process pool;
    engine specs always run serially in this process, on `device` (live
    engines are neither picklable nor worth rebuilding per worker).
    """
    cache = Path(cache_dir) if cache_dir is not None else None
    engine_specs = any(s.backend == "engine" for s in specs)
    dev = resolve_device(device).type if engine_specs else "none"
    results: Dict[ExperimentSpec, Dict] = {}
    pending: List[ExperimentSpec] = []
    for spec in specs:
        hit = None if force else _cache_load(cache, spec, dev)
        if hit is not None:
            results[spec] = hit
        else:
            pending.append(spec)

    par = [s for s in pending if s.backend == "sim"] if workers > 1 else []
    serial = [s for s in pending if s not in par]

    if par:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        # spawn (not fork): torch holds threads in this process.  Spawned
        # children need repro_torch on their path even when the parent got
        # it from conftest, so propagate it.
        src = str(Path(__file__).resolve().parents[2])
        env_path = os.environ.get("PYTHONPATH", "")
        if src not in env_path.split(os.pathsep):
            os.environ["PYTHONPATH"] = (src + os.pathsep + env_path
                                        if env_path else src)
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
            for spec, summary in zip(
                    par, ex.map(_run_spec_for_pool,
                                [s.to_dict() for s in par])):
                results[spec] = summary
                _cache_store(cache, spec, dev, summary)
    for spec in serial:
        summary = run_spec(spec, device)
        results[spec] = summary
        _cache_store(cache, spec, dev, summary)
    return results


def by_policy(results: Dict[ExperimentSpec, Dict]
              ) -> Dict[Tuple[str, str, str, int], Dict[str, Dict]]:
    """Regroup sweep results as {(backend, model, scenario, seed):
    {policy: summary}} — the per-cell shape the claims registry evaluates
    against.  Two specs that differ only in a dimension this key does NOT
    carry (n_requests, utilization, overrides, engine_clock) would silently
    overwrite each other's policy entry, so that collision is an error:
    evaluate such grids cell by cell instead."""
    out: Dict[Tuple[str, str, str, int], Dict[str, Dict]] = {}
    for spec, summary in results.items():
        cell = out.setdefault(
            (spec.backend, spec.model, spec.scenario, spec.seed), {})
        if spec.policy in cell:
            raise ValueError(
                f"ambiguous cell {(spec.backend, spec.model, spec.scenario, spec.seed)}: "
                f"policy {spec.policy!r} appears with multiple "
                f"n_requests/utilization/override variants")
        cell[spec.policy] = summary
    return out

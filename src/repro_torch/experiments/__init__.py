"""Experiments subsystem: declarative sweeps + claims-as-tests.

The paper's evaluation section (§6) lives here as executable, seeded,
tolerance-checked artifacts:

* `ExperimentSpec` / `grid`      — declarative policy x scenario x model x
                                   backend x seed cells (spec.py)
* `run_sweep` / `run_spec`       — cache-aware, optionally process-parallel
                                   execution of a spec grid (runner.py)
* `CLAIMS` / `evaluate_claims`   — the paper's figures/tables as Claim
                                   objects with direction + tolerance
                                   (claims.py)
* `render_markdown`/`write_report` — the claims ledger as markdown and
                                   claims_report.json (report.py)

`smoke_grid()` below is the canonical reduced grid: the `-m claims` test
suite, the CI claims-smoke job and `examples/paper_claims.py` all replay
exactly this grid, so "the claims pass" means the same thing everywhere.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

from repro_torch.experiments.claims import (CLAIMS, Claim, ClaimResult,
                                      eval_claim, evaluate_claims,
                                      policies_needed, register_claim)
from repro_torch.experiments.report import (render_markdown, summarize_results,
                                      write_report)
from repro_torch.experiments.runner import by_policy, run_spec, run_sweep
from repro_torch.experiments.spec import (PINNED_SCENARIOS, SCHEMA_VERSION,
                                    ExperimentSpec, grid)

# canonical smoke-grid shape (kept small: the whole grid must stay well
# under the 5-minute CI budget on CPU)
SMOKE_SIM_N = 2500
SMOKE_SIM_MT_N = 2000
SMOKE_ENGINE_N = 42
SMOKE_MODEL = "mistral_7b"
SMOKE_SEED = 0

#: per-(backend, scenario) workload setup for smoke-grid cells that need a
#: regime other than the default 0.65-utilization mix.  The coordination
#: cells (§5.2) pin a prefill-surge regime — high utilization with a light
#: (summarization-like) decode side, so the decode pool has headroom to
#: lend — which is exactly the workload class where the static split
#: underuses the pool.  Values are tuples (frozen-spec friendly); the
#: arrival_params overrides REPLACE the scenario's default process knobs.
CELL_SETUP: Dict[Tuple[str, str], Dict] = {
    ("sim", "bursty"): dict(
        n_requests=4000, utilization=2.5,
        overrides=(("output_mu", math.log(30.0)),)),
    ("sim", "diurnal"): dict(
        n_requests=4000, utilization=2.0,
        overrides=(("output_mu", math.log(30.0)),
                   ("arrival_params", (("period", 40.0), ("depth", 0.9))))),
    # engine traces span milliseconds (CPU-sized capacity), so the burst /
    # day-night cycles are compressed to keep several phases in-span
    ("engine", "bursty"): dict(
        n_requests=64, utilization=2.5,
        overrides=(("output_mu", math.log(30.0)),
                   ("arrival_params", (("burst_factor", 8.0),
                                       ("burst_frac", 0.2),
                                       ("mean_cycle", 0.004))))),
    ("engine", "diurnal"): dict(
        n_requests=64, utilization=2.5,
        overrides=(("output_mu", math.log(30.0)),
                   ("arrival_params", (("period", 0.008),
                                       ("depth", 0.9))))),
    # prediction-robustness cells: deep overload so the queue-drain ORDER
    # (the thing prediction changes) sets the p99, not raw capacity.  The
    # gamma renewal process is rate-scale-free, so the engine cell needs no
    # time compression — only its own (higher) utilization, where the
    # 2-general-replica cluster reproduces the sim crossover.
    ("sim", "pred_stress"): dict(n_requests=2500, utilization=8.0),
    ("engine", "pred_stress"): dict(n_requests=64, utilization=12.0),
    # prefix-cache cells: chat_multiturn runs the default 0.65-utilization
    # mix (the claims there are about reuse, not overload); shared_prefix
    # pins the bursty overload regime where cache-greedy routing must pay
    # its p99 tax.  The engine shared cell compresses the MMPP cycle like
    # the bursty cell, so several burst phases land inside the short span.
    ("sim", "shared_prefix"): dict(n_requests=2500, utilization=4.0),
    ("engine", "shared_prefix"): dict(
        n_requests=64, utilization=4.0,
        overrides=(("mean_cycle", 0.004),)),
    # SLO cells: utilization just past calibrated short capacity with the
    # tier contracts halved — the binding regime where plain PecSched's
    # FIFO-within-class order drops interactive attainment below 0.95 and
    # plan-ahead slack ordering wins it back.  The engine timeline spans
    # milliseconds, so its burst cycle AND its SLO targets are compressed
    # to the measured engine TTFT/TPOT scale (see claims.py slo_* notes).
    ("sim", "slo_tiered"): dict(
        n_requests=3000, utilization=1.05,
        overrides=(("slo_scale", 0.5),)),
    ("engine", "slo_tiered"): dict(
        n_requests=64, utilization=1.05,
        overrides=(("mean_cycle", 0.004), ("slo_scale", 0.0005))),
    # elastic-fleet cells: `churn` runs the default 0.65-utilization mix —
    # the wave (runner-injected, 20% of the fleet) is the stressor, and the
    # question is whether the short-QD win survives it.  `churn_scale` runs
    # far past the post-wave capacity knee (PecSched absorbs the wave until
    # ~2x calibrated capacity) with the autoscaler allowed to backfill the
    # whole wave after a provisioning delay, so the recovery claims have a
    # regime where scale-up visibly bounds the surviving tail.
    ("sim", "churn_scale"): dict(
        n_requests=2500, utilization=2.4,
        overrides=(("fleet_autoscale", True), ("fleet_max_joins", 7),
                   ("fleet_provision_s", 5.0))),
}


def smoke_grid() -> List[ExperimentSpec]:
    """The pinned reduced grid the claims suite replays: every (backend,
    scenario) cell the registry needs, with the policies its claims read.

    Engine cells for azure_default replay the pinned `smoke_mini` trace
    (the engine world's stand-in, see `smoke_sweep_cells`); engine cells
    for other scenarios run the named scenario directly at the engine
    cluster's calibrated arrival rate, with any `CELL_SETUP` regime."""
    specs: List[ExperimentSpec] = []
    from repro_torch.experiments.claims import claims_for_scenarios
    for (backend, scenario) in sorted(claims_for_scenarios()):
        pols = policies_needed(scenario, backend)
        setup = dict(CELL_SETUP.get((backend, scenario), ()))
        if backend == "sim":
            setup.setdefault(
                "n_requests",
                SMOKE_SIM_MT_N if scenario == "multi_tenant" else SMOKE_SIM_N)
            specs += grid(pols, scenarios=(scenario,), models=(SMOKE_MODEL,),
                          backends=("sim",), seeds=(SMOKE_SEED,), **setup)
        else:
            setup.setdefault("n_requests", SMOKE_ENGINE_N)
            run_as = "smoke_mini" if scenario == "azure_default" else scenario
            specs += grid(pols, scenarios=(run_as,),
                          models=(SMOKE_MODEL,), backends=("engine",),
                          seeds=(SMOKE_SEED,), **setup)
    # dedupe (several scenarios share policies)
    seen, out = set(), []
    for s in specs:
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


def smoke_sweep_cells(results: Dict[ExperimentSpec, Dict]
                      ) -> Dict[Tuple[str, str], Dict[str, Dict]]:
    """Regroup smoke-grid results into the (backend, scenario) cells
    `evaluate_claims` consumes.  The engine cells run the pinned smoke_mini
    trace; the registry's azure_default engine claims read that cell — the
    engine world has exactly one pinned workload.

    Collapsing to (backend, scenario) is only sound for a single-model,
    single-seed grid (which the smoke grid is); a multi-model or multi-seed
    result set would mix cells, so it is rejected rather than merged."""
    cells: Dict[Tuple[str, str], Dict[str, Dict]] = {}
    for (backend, model, scenario, seed), by_pol in by_policy(results).items():
        key = (backend, "azure_default" if backend == "engine"
               and scenario == "smoke_mini" else scenario)
        cell = cells.setdefault(key, {})
        dupes = set(cell) & set(by_pol)
        if dupes:
            raise ValueError(
                f"cell {key} would mix runs of {sorted(dupes)} (model "
                f"{model!r} seed {seed}): evaluate multi-model/seed grids "
                f"per cell via runner.by_policy instead")
        cell.update(by_pol)
    return cells

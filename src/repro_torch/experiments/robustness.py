"""Prediction-robustness sweep: p99 short delay + long JCT vs sigma.

The tentpole question of the prediction extension (§7): *how good does an
output-length predictor have to be before predicted-SJF beats PecSched's
prediction-free preemption — and how fast does the advantage decay as the
predictor degrades?*  This module sweeps the multiplicative log-normal
error scale sigma over the pinned `pred_stress` regime (the CELL_SETUP
cell the claims suite replays) on either backend and locates the
**crossover sigma***: the error level where PecSched wins the short p99
back from `sjf_pred`.

Arms per sigma: `sjf_pred:noisy<sigma>` (point-estimate budgets) and
`tail_aware:noisy<sigma>` (q90 budgets, same ordering); anchors:
`pecsched` (prediction-free) and `sjf_pred:oracle` (sigma = 0 — the exact
truth, not `noisy0.0`, whose √2-bucketing already quantizes).

    PYTHONPATH=src python -m repro_torch.experiments.robustness            # sim
    PYTHONPATH=src python -m repro_torch.experiments.robustness --backends sim engine
    PYTHONPATH=src python -m repro_torch.experiments.robustness --sigmas 0 0.6 2.4
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.experiments.runner import run_sweep
from repro_torch.experiments.spec import ExperimentSpec, grid

#: default multiplicative-error ladder (sigma of log-normal noise); 0 maps
#: to the oracle arm.  2.0 sits past the measured sim+engine crossover, so
#: the default sweep always brackets sigma*.
SIGMA_LADDER: Tuple[float, ...] = (0.0, 0.3, 0.6, 1.2, 2.0)


def arm_names(sigma: float) -> Tuple[str, str]:
    """(sjf_pred, tail_aware) policy names for one error level."""
    if sigma <= 0:
        return "sjf_pred:oracle", "tail_aware:oracle"
    return f"sjf_pred:noisy{sigma:g}", f"tail_aware:noisy{sigma:g}"


def robustness_grid(backend: str, sigmas: Sequence[float] = SIGMA_LADDER,
                    *, model: str = "mistral_7b", seed: int = 0,
                    n_requests: Optional[int] = None,
                    utilization: Optional[float] = None
                    ) -> List[ExperimentSpec]:
    """Spec grid for one backend: both arms at every sigma + the anchors,
    in the same pred_stress regime the claims cells pin (CELL_SETUP)."""
    from repro_torch.experiments import CELL_SETUP
    setup = dict(CELL_SETUP[(backend, "pred_stress")])
    if n_requests is not None:
        setup["n_requests"] = n_requests
    if utilization is not None:
        setup["utilization"] = utilization
    pols: List[str] = ["pecsched", "sjf_pred:oracle"]
    for s in sigmas:
        for p in arm_names(s):
            if p not in pols:
                pols.append(p)
    return grid(pols, scenarios=("pred_stress",), models=(model,),
                backends=(backend,), seeds=(seed,), **setup)


def crossover_sigma(cell: Dict[str, Dict],
                    sigmas: Sequence[float] = SIGMA_LADDER,
                    arm: str = "sjf_pred") -> Optional[float]:
    """Smallest sigma where the arm's short p99 delay reaches PecSched's,
    linearly interpolated between ladder points; None if the arm still
    wins at the largest sigma swept (no crossover in range)."""
    base = cell["pecsched"]["short_qd_pct"]["99"]
    pts = []
    for s in sorted(sigmas):
        name = arm_names(s)[0 if arm == "sjf_pred" else 1]
        if name in cell:
            pts.append((s, cell[name]["short_qd_pct"]["99"] / max(base, 1e-9)))
    prev = None
    for s, r in pts:
        if r >= 1.0:
            if prev is None or prev[1] >= 1.0:
                return s
            s0, r0 = prev
            return s0 + (s - s0) * (1.0 - r0) / max(r - r0, 1e-9)
        prev = (s, r)
    return None


def render_table(cell: Dict[str, Dict],
                 sigmas: Sequence[float] = SIGMA_LADDER) -> str:
    """Markdown: one row per sigma, both arms, vs the PecSched anchor."""
    base = cell["pecsched"]
    lines = [
        "| sigma | policy | short qd p99 (s) | vs pecsched | long JCT (s) "
        "| decode evictions |",
        "|---|---|---|---|---|---|",
        "| — | `pecsched` | {:.4g} | 1.00x | {:.4g} | 0 |".format(
            base["short_qd_pct"]["99"], base["long_jct_mean"] or 0.0),
    ]
    for s in sorted(sigmas):
        for name in arm_names(s):
            summ = cell.get(name)
            if summ is None:
                continue
            lines.append(
                "| {:g} | `{}` | {:.4g} | {:.2f}x | {:.4g} | {} |".format(
                    s, name, summ["short_qd_pct"]["99"],
                    summ["short_qd_pct"]["99"]
                    / max(base["short_qd_pct"]["99"], 1e-9),
                    summ["long_jct_mean"] or 0.0,
                    summ["decode_preemptions"]))
    return "\n".join(lines)


def sweep(backends: Sequence[str] = ("sim",),
          sigmas: Sequence[float] = SIGMA_LADDER, *, seed: int = 0,
          n_requests: Optional[int] = None,
          utilization: Optional[float] = None,
          cache_dir: Optional[str] = None,
          workers: int = 1) -> Dict[str, Dict[str, Dict]]:
    """Run the sweep; returns {backend: {policy: summary}}."""
    out: Dict[str, Dict[str, Dict]] = {}
    for backend in backends:
        specs = robustness_grid(backend, sigmas, seed=seed,
                                n_requests=n_requests,
                                utilization=utilization)
        results = run_sweep(specs, cache_dir=cache_dir, workers=workers)
        out[backend] = {spec.policy: summ for spec, summ in results.items()}
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="output-length-prediction robustness sweep")
    ap.add_argument("--backends", nargs="+", default=["sim"],
                    choices=["sim", "engine"])
    ap.add_argument("--sigmas", nargs="+", type=float,
                    default=list(SIGMA_LADDER))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=None,
                    help="override the pinned cell's n_requests")
    ap.add_argument("--utilization", type=float, default=None)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--cache", default="benchmarks/artifacts/experiments",
                    help="sweep result cache dir ('' disables)")
    args = ap.parse_args(argv)

    t0 = time.time()
    cells = sweep(args.backends, args.sigmas, seed=args.seed,
                  n_requests=args.n, utilization=args.utilization,
                  cache_dir=args.cache or None, workers=args.workers)
    for backend, cell in cells.items():
        print(f"\n## Prediction robustness — {backend} (pred_stress)\n")
        print(render_table(cell, args.sigmas))
        for arm in ("sjf_pred", "tail_aware"):
            x = crossover_sigma(cell, args.sigmas, arm)
            print(f"\ncrossover sigma* ({arm} vs pecsched, short qd p99): "
                  + (f"{x:.3g}" if x is not None
                     else f"none in sigma <= {max(args.sigmas):g}"))
    print(f"\n[{time.time() - t0:.1f}s]")
    return 0


if __name__ == "__main__":
    sys.exit(main())

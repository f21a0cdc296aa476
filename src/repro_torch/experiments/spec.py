"""Declarative experiment specifications.

An `ExperimentSpec` names one cell of the evaluation grid — policy x
scenario x model x backend x seed — plus the knobs that pin its workload.
Specs are frozen, hashable, picklable (process-parallel sweeps) and have a
stable content hash (`spec_hash`) that keys the on-disk result cache: the
same spec always maps to the same cache file, and any change to the grid
schema bumps `SCHEMA_VERSION` to invalidate stale results wholesale.

Worked example — one cell, run and cached; then the 15-policy sweep over
two scenarios that `by_policy` regroups for the claims registry::

    from repro_torch.experiments.spec import ExperimentSpec, grid
    from repro_torch.experiments.runner import run_spec, run_sweep, by_policy

    cell = ExperimentSpec(policy="pecsched", scenario="bursty",
                          n_requests=2000, seed=1)
    summary = run_spec(cell)              # one metrics.summarize dict
    summary["short_qd_pct"]["99"]

    specs = grid(["fifo", "pecsched", "pecsched/coord"],
                 scenarios=("azure_default", "churn"), seeds=(0, 1))
    cells = by_policy(run_sweep(specs, cache_dir="results/cache"))
    cells[("sim", "mistral_7b", "churn", 0)]["pecsched"]["reclaims"]

Overrides are (key, value) tuples so the spec stays frozen/hashable;
keys prefixed ``fleet_`` configure the churn layer (core/fleet.py) and
are stripped before the rest flow into `get_scenario`.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, replace
from typing import Dict, List, Sequence, Tuple

#: bump when summary structure or workload construction changes meaning —
#: every cached result keyed under the old version stops matching
SCHEMA_VERSION = 6        # 6: elastic-fleet churn — reclaims/
#                              evacuated_blocks/restarted_requests in
#                              metrics.summarize, fleet_* overrides change
#                              workload construction (FleetController)
#                           5: TTFT/TPOT/goodput/slo_tiers/busy_overflow_s
#                              in metrics.summarize + unified first-token
#                              stamping (migrating shorts stamp at decode
#                              start, not prefill completion)

BACKENDS = ("sim", "engine")

#: scenarios whose traces are fully pinned by (n_requests, seed) — the
#: runner must NOT recalibrate their arrival rate against cluster capacity
PINNED_SCENARIOS = ("smoke_mini", "csv")


@dataclass(frozen=True)
class ExperimentSpec:
    policy: str
    scenario: str = "azure_default"
    model: str = "mistral_7b"
    backend: str = "sim"                  # "sim" | "engine"
    seed: int = 0
    n_requests: int = 3000
    #: sim backend: short arrival rate = utilization x calibrated capacity
    utilization: float = 0.65
    #: extra scenario overrides, as sorted (key, value) pairs to stay frozen
    overrides: Tuple[Tuple[str, object], ...] = ()
    #: engine backend: virtual-clock mode ("analytic" keeps the cost-model
    #: timeline -> deterministic claims; "measured" uses real compute time)
    engine_clock: str = "analytic"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        if self.engine_clock not in ("analytic", "measured"):
            raise ValueError(f"bad engine_clock {self.engine_clock!r}")

    # ------------------------------------------------------------------
    def key(self) -> str:
        """Human-readable cell id (also the cache-file stem)."""
        pol = self.policy.replace("/", "-")
        return (f"{self.backend}.{self.model}.{self.scenario}.{pol}"
                f".n{self.n_requests}.s{self.seed}")

    def spec_hash(self) -> str:
        """Stable content hash over every field + SCHEMA_VERSION."""
        payload = {"schema": SCHEMA_VERSION, **asdict(self)}
        blob = json.dumps(payload, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def to_dict(self) -> Dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "ExperimentSpec":
        d = dict(d)
        if "overrides" in d:
            d["overrides"] = tuple((k, v) for k, v in d["overrides"])
        return cls(**d)

    def with_policy(self, policy: str) -> "ExperimentSpec":
        return replace(self, policy=policy)


def grid(policies: Sequence[str], *, scenarios: Sequence[str] = ("azure_default",),
         models: Sequence[str] = ("mistral_7b",), backends: Sequence[str] = ("sim",),
         seeds: Sequence[int] = (0,), **common) -> List[ExperimentSpec]:
    """Cartesian spec grid; `common` fixes the remaining fields."""
    return [ExperimentSpec(policy=p, scenario=sc, model=m, backend=b,
                           seed=s, **common)
            for b in backends for m in models for sc in scenarios
            for s in seeds for p in policies]

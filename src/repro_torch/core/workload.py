"""Experiment workload construction: the paper's §6.2 cluster setups and
saturation calibration (§6.6 runs at "the cluster's maximum capacity").
"""
from __future__ import annotations

import copy
from typing import Dict, List, Tuple

from repro_torch.configs import get_config
from repro_torch.core.cluster import ClusterConfig
from repro_torch.core.costmodel import ExecutionModel
from repro_torch.core.request import Request
from repro_torch.core.schedulers import FIFOPolicy
from repro_torch.core.simulator import Simulator
from repro_torch.core.trace import TraceConfig, generate_trace
from repro_torch.sp.planner import A100_40G

# paper §6.2: TP per model (following Sarathi-Serve/DistServe settings) and
# dedicated short-decode replica counts for PecSched
PAPER_SETUPS: Dict[str, Dict] = {
    "mistral_7b": {"tp": 1, "n_decode": 4},
    "phi3_14b": {"tp": 2, "n_decode": 4},
    "yi_34b": {"tp": 4, "n_decode": 1},
    "llama31_70b": {"tp": 4, "n_decode": 1},
}


def paper_cluster(model: str, *, n_nodes: int = 4, gpus_per_node: int = 8
                  ) -> Tuple[ClusterConfig, ExecutionModel]:
    setup = PAPER_SETUPS[model]
    cc = ClusterConfig(n_nodes=n_nodes, gpus_per_node=gpus_per_node,
                       tp=setup["tp"], gpu_mem_bytes=80e9, hw=A100_40G,
                       n_short_decode_replicas=setup["n_decode"])
    em = ExecutionModel(get_config(model), cc.replica_spec())
    return cc, em


def calibrate_short_capacity(cc: ClusterConfig, em: ExecutionModel, *,
                             n: int = 1500, seed: int = 7) -> float:
    """Short-only max sustainable throughput (RPS): flood a FIFO cluster and
    measure its completion rate."""
    tc = TraceConfig(n_requests=n, arrival_rps=1e5, seed=seed,
                     long_quantile=2.0)          # no longs
    reqs = generate_trace(tc)
    pol = FIFOPolicy(cc, em)
    Simulator(pol).run(copy.deepcopy(reqs))
    done = [r for r in pol.done_requests if not r.is_long]
    if not done:
        return 1.0
    span = max(r.finish for r in done) - min(r.arrival for r in done)
    return len(done) / max(span, 1e-9)


def experiment_trace(cc: ClusterConfig, em: ExecutionModel, *,
                     n_requests: int = 16000, utilization: float = 0.65,
                     seed: int = 0, long_quantile: float = 0.996,
                     long_low: int = 100_000, long_high: int = 400_000
                     ) -> Tuple[List[Request], float]:
    """Trace whose short load is `utilization` x the cluster's short-only
    capacity, with longs (§6.2-style resampling) layered on top.

    Default regime note (EXPERIMENTS.md §Simulator-calibration): the paper
    replays 100 K–500 K-token longs at 5 % of a real Azure arrival stream;
    on our simulated 32-GPU cluster that demand exceeds capacity by >10x and
    every policy degenerates to a pure backlog. We scale the long range /
    fraction so total demand is ~1.1x capacity — the stressed-but-flowing
    regime the paper's relative metrics (delay ratios, throughput ratios,
    preemption counts) are measured in. A paper-parameter stress variant is
    exposed via the kwargs (long_quantile=0.95, long_low=100_000,
    long_high=500_000).
    """
    cap = calibrate_short_capacity(cc, em)
    rps = cap * utilization / long_quantile
    tc = TraceConfig(n_requests=n_requests, arrival_rps=rps, seed=seed,
                     long_quantile=long_quantile, long_low=long_low,
                     long_high=long_high)
    return generate_trace(tc), cap

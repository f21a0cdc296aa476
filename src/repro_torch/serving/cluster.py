"""Real-execution mini cluster: the full policy stack driving actual PyTorch
ReplicaEngines (the port of the reference's ``serving/cluster.py``).

MiniCluster binds ANY `make_policy` policy to an `EngineBackend`, so the
scheduling brain is the same code the analytic simulator runs.  Virtual time
advances by measured compute (clock="measured"); clock="analytic" reuses the
cost-model timeline while still executing for real — the cross-backend
parity mode.  The cost model prices work with `hw`, the H100 SXM's datasheet
spec by default, and so does the gang planner.  A tight `target_prefill_s`
makes longs claim SP groups, which the backend gang-schedules over
`sp_devices` (by default every visible card) when it holds two or more.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cluster import ClusterConfig
from repro_torch.core.costmodel import ExecutionModel
from repro_torch.core.request import Phase, Request
from repro_torch.core.schedulers import make_policy
from repro_torch.core.simulator import Simulator
from repro_torch.hardware import H100_SXM
from repro_torch.serving.backend import EngineBackend
from repro_torch.sp.planner import HardwareSpec


@dataclass
class ServeRequest:
    rid: int
    arrival: float              # virtual seconds
    tokens: np.ndarray          # (S,) int32 prompt
    max_new: int = 8
    is_long: bool = False
    # runtime
    prefill_start: Optional[float] = None
    first_token: Optional[float] = None
    finish: Optional[float] = None
    generated: List[int] = field(default_factory=list)
    n_preemptions: int = 0


class MiniCluster:
    """n_engines general engines (+ 1 dedicated decode engine for the
    PecSched family, the paper's disaggregated pool) driven by any
    scheduling policy from `make_policy`, on `device`."""

    def __init__(self, cfg: ModelConfig, params, *, n_engines: int = 2,
                 policy: str = "pecsched", max_len: int = 512,
                 long_threshold: int = 128, layers_per_quantum: int = 2,
                 clock: str = "measured", seed: int = 0,
                 enable_sp: bool = True, sp_degree_cap: int = 0,
                 target_prefill_s: float = 15.0,
                 hw: HardwareSpec = H100_SXM, device="cuda",
                 sp_devices: Optional[Sequence] = None):
        self.cfg = cfg
        self.policy = policy
        self.long_threshold = long_threshold
        pecfam = policy.startswith("pecsched")
        self.cc = ClusterConfig(
            n_nodes=1, gpus_per_node=n_engines + (1 if pecfam else 0), tp=1,
            hw=hw, n_short_decode_replicas=1 if pecfam else 0,
            max_batch_tokens=max(2 * max_len, 256),
            max_coloc_tokens=max_len,
            max_decode_concurrency=8)
        self.em = ExecutionModel(cfg, self.cc.replica_spec(),
                                 target_prefill_s=target_prefill_s)
        self._tok: Dict[int, np.ndarray] = {}
        self.backend = EngineBackend(
            cfg, params, max_len=max_len,
            layers_per_quantum=layers_per_quantum, clock=clock,
            max_new_cap=1 << 30,                   # honour each max_new exactly
            token_provider=lambda r: self._tok.get(r.rid), seed=seed,
            enable_sp=enable_sp, sp_degree_cap=sp_degree_cap, device=device,
            sp_devices=sp_devices, hw=hw)
        self._pending: List[ServeRequest] = []
        self.done: List[ServeRequest] = []
        self.summary: Dict = {}
        self.policy_obj = None
        self.vclock = 0.0

    # ------------------------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        self._pending.append(req)

    # ------------------------------------------------------------------
    def run(self) -> None:
        """Serve everything submitted since the last run.  Engines are
        reused across runs; each run binds a fresh policy instance."""
        by_rid: Dict[int, ServeRequest] = {}
        reqs: List[Request] = []
        for sr in self._pending:
            toks = np.asarray(sr.tokens, np.int32)
            self._tok[sr.rid] = toks
            reqs.append(Request(
                rid=sr.rid, arrival=sr.arrival, input_len=int(toks.shape[0]),
                output_len=sr.max_new,
                is_long=sr.is_long or toks.shape[0] >= self.long_threshold))
            by_rid[sr.rid] = sr
        self._pending.clear()
        self.backend.reset()
        pol = make_policy(self.policy, self.cc, self.em)
        sim = Simulator(pol, backend=self.backend)
        self.summary = sim.run(reqs)
        self.policy_obj = pol
        self.vclock = sim.now
        for r in pol.all_requests:
            sr = by_rid[r.rid]
            sr.prefill_start = r.prefill_start
            sr.first_token = r.first_token
            sr.finish = r.finish
            sr.n_preemptions = r.n_preemptions
            sr.generated = list(self.backend.generated.get(r.rid, []))
            if r.phase == Phase.DONE:
                self.done.append(sr)

    # ------------------------------------------------------------------
    def metrics(self) -> Dict:
        shorts = [r for r in self.done if not r.is_long]
        longs = [r for r in self.done if r.is_long]
        qd = [r.prefill_start - r.arrival for r in shorts
              if r.prefill_start is not None]
        return {
            "policy": self.policy,
            "short_done": len(shorts),
            "long_done": len(longs),
            "short_qd_mean": float(np.mean(qd)) if qd else 0.0,
            "short_qd_p99": float(np.percentile(qd, 99)) if qd else 0.0,
            "long_jct_mean": (float(np.mean([r.finish - r.arrival
                                             for r in longs])) if longs else 0.0),
            "preemptions": sum(r.n_preemptions for r in self.done),
        }

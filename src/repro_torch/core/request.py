"""Request model and lifecycle for cluster-level scheduling (paper §3–§5)."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional


class Phase(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    PAUSED = "paused"          # long prefill suspended by preemption
    MIGRATING = "migrating"    # short KV -> decode replica (usually overlapped)
    DECODE = "decode"
    DONE = "done"
    STARVED = "starved"        # never served by simulation end (Priority)


@dataclass(slots=True)
class Request:
    rid: int
    arrival: float
    input_len: int
    output_len: int            # ground truth — NOT visible to the scheduler
    is_long: bool = False
    tenant: Optional[str] = None   # multi-tenant scenarios: originating tenant
    session: Optional[int] = None  # chat scenarios: multi-turn session id

    # --- prefix-cache identity (scenario-owned, scheduler-visible) ---
    # group id whose earlier requests computed this prompt's leading tokens
    # (session for chat, system-prompt id for shared_prefix); None = opaque
    prefix_group: Optional[int] = None
    prefix_len: int = 0            # leading tokens reusable from the group
    prefix_write: int = 0          # tokens this request leaves resident

    # --- SLO contract (scenario-owned, scheduler-visible) ---
    # tier name ("interactive" / "standard" / "batch"); None = no contract
    slo: Optional[str] = None
    ttft_target: Optional[float] = None   # seconds, arrival -> first token
    tpot_target: Optional[float] = None   # seconds per decoded token after 1st

    # --- runtime bookkeeping (simulator-owned) ---
    phase: Phase = Phase.QUEUED
    prefill_start: Optional[float] = None   # first time prefill work began
    # time the first output token is SERVED: for migrating shorts this is
    # when the first decode work lands on the pool (not prefill completion —
    # the engine only emits tokens once the KV migration has landed), for
    # in-place / colocated-inline decode and longs it coincides with prefill
    # completion.  Stamped policy-side so both backends agree byte-for-byte.
    first_token: Optional[float] = None
    finish: Optional[float] = None
    n_preemptions: int = 0                  # times THIS request was suspended
    prefill_remaining: float = 0.0          # seconds of prefill work left
    shed: bool = False                      # dropped by an SLO-aware policy
    replicas: List[int] = field(default_factory=list)

    @property
    def queueing_delay(self) -> Optional[float]:
        if self.prefill_start is None:
            return None
        return self.prefill_start - self.arrival

    @property
    def jct(self) -> Optional[float]:
        if self.finish is None:
            return None
        return self.finish - self.arrival

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (arrival -> first served output token)."""
        if self.first_token is None:
            return None
        return self.first_token - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        """Mean time per output token after the first (decode cadence)."""
        if self.finish is None or self.first_token is None:
            return None
        return (self.finish - self.first_token) / max(self.output_len - 1, 1)

    def slo_met(self) -> Optional[bool]:
        """Whether this completion honoured its tier contract; None when the
        request carries no SLO tier (untiered scenarios)."""
        if self.slo is None:
            return None
        if self.shed or self.finish is None:
            return False
        ok = True
        if self.ttft_target is not None:
            ok = ok and self.ttft is not None and self.ttft <= self.ttft_target
        if self.tpot_target is not None:
            ok = ok and self.tpot is not None and self.tpot <= self.tpot_target
        return ok

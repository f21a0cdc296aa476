"""Elastic-fleet churn: spot reclamation, KV evacuation, autoscale joins.

The paper evaluates PecSched on a fixed fleet; production spot-priced
clusters are not fixed.  `FleetController` injects replica *churn* into a
run as first-class simulator events (kind ``FLEET``), so the same policy
code that wins on a static cluster is exercised while replicas leave and
join mid-trace:

    notice   at t:  the provider announces reclamation of replica `rid`.
                    The replica leaves every placement set immediately
                    (``rep.reclaiming = True``) — no NEW work lands on it —
                    but whatever runs keeps running through the notice
                    window (the spot "grace period").
    reclaim  at t + notice_s:  the hardware is gone.  The policy evacuates
                    (``policy.on_reclaim``: cancel/restart, or migrate KV
                    at cost-model price), the backend parks real KV
                    (``backend.reclaim_replica``: gather -> host ->
                    scatter on the next home), the prefix-residency map
                    for the replica is dropped, and the replica retires.
    join     at t:  a new replica comes up (autoscale).  It appends with
                    the next dense rid — existing ``min(set)`` /
                    ``replicas[rid]`` selection keeps working — and enters
                    the placement sets via ``ClusterIndex.add_replica``.

Determinism contract: a controller with no reclamations and autoscaling
off is *inert* — it pushes no events and ``step()`` returns immediately —
so a zero-churn run produces a bit-identical decision log to a run with
no controller at all (pinned by ``tests/test_fleet.py``).

The autoscaler reuses the `RoleCoordinator`'s pressure signals (short
backlog in prefill batches vs. idle prefill-capable replicas) rather than
inventing new ones: the same observable quantities that drive role flips
drive scale-up, and the cooldown is priced in full-batch prefill times by
the same cost model.  Scale-up only: scale-*down* is what reclamation
waves already model, and a deliberate drain is identical to a reclaim
with a long notice window.

Worked example — a 20% reclamation wave at t=30 with a 5 s notice, then
autoscale allowed to backfill two replicas::

    from repro_torch.core.fleet import FleetConfig, FleetController, \
        reclamation_wave

    cfg = FleetConfig(
        reclamations=reclamation_wave(30.0, 0.20, policy.cc.n_replicas),
        notice_s=5.0, autoscale=True, max_joins=2, provision_s=20.0)
    sim = Simulator(policy, fleet=FleetController(cfg))
    res = sim.run(requests)
    res["reclaims"], res["evacuated_blocks"], res["restarted_requests"]
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.core.cluster import ReplicaState
from repro_torch.core.coordinator import RoleCoordinator


def reclamation_wave(t: float, frac: float,
                     n_replicas: int) -> Tuple[Tuple[float, int], ...]:
    """A simultaneous spot-reclamation wave hitting `frac` of the fleet at
    time `t`.  Targets the LOWEST rids — general replicas under every
    policy's layout (the dedicated decode pool sits at the tail), so the
    wave hits prefill capacity, the contended resource in the short-QD
    claims."""
    n = min(max(int(math.ceil(frac * n_replicas)), 0), n_replicas)
    return tuple((t, rid) for rid in range(n))


@dataclass(frozen=True)
class FleetConfig:
    #: (time, rid) reclamation injections; each fires a `notice` at t and
    #: the `reclaim` at t + notice_s
    reclamations: Tuple[Tuple[float, int], ...] = ()
    #: spot grace period between notice and reclaim (0 = no warning)
    notice_s: float = 0.0
    #: enable the pressure-driven scale-up loop
    autoscale: bool = False
    #: replicas the autoscaler may add over the whole run
    max_joins: int = 0
    #: role a joining replica comes up with
    join_role: str = "general"
    #: provisioning delay between the scale decision and the join event
    provision_s: float = 0.0
    #: scale up when short backlog exceeds idle prefill capacity by at
    #: least this many full prefill batches
    scale_up_backlog: int = 2
    #: autoscaler cooldown in full-batch prefill times (cost-model priced,
    #: same unit as the coordinator's hysteresis)
    cooldown_batches: float = 4.0


class _FleetEvent:
    """Payload for a ``FLEET`` heap entry.  Carries the `.wid`/`.canceled`
    protocol every non-ARRIVAL payload needs (`Simulator.push` registers
    entries by wid); wids are negative so they can never collide with
    `Work` wids, which count up from 0."""

    __slots__ = ("wid", "action", "rid", "role", "canceled")

    def __init__(self, wid: int, action: str, rid: int,
                 role: str = "general"):
        self.wid = wid
        self.action = action            # notice | reclaim | join
        self.rid = rid
        self.role = role
        self.canceled = False

    def __repr__(self) -> str:          # pragma: no cover - debugging aid
        return f"_FleetEvent({self.action}, rid={self.rid}, t@wid={self.wid})"


class FleetController:
    """Injects replica churn into a `Simulator` run and optionally scales
    the fleet back up under pressure.

    Lifecycle: construct with a `FleetConfig`, pass as
    ``Simulator(policy, fleet=controller)``.  The simulator calls
    ``bind(sim)`` once before the event loop (the controller schedules
    every configured reclamation there), routes ``FLEET`` events to
    ``on_event``, and calls ``step(t)`` before each dispatch pass (the
    autoscaler hook).
    """

    def __init__(self, config: Optional[FleetConfig] = None):
        self.config = config or FleetConfig()
        self._wids = itertools.count(-1, -1)    # -1, -2, ... (never a Work wid)
        self.sim = None
        self.policy = None
        self._coord: Optional[RoleCoordinator] = None
        self._cooldown_s = 0.0
        self._last_scale = -math.inf
        self._joins_left = 0
        self._inert = True
        # churn log: (t, action, rid) applied, for tests and reporting
        self.events: list = []

    # ------------------------------------------------------------------
    def bind(self, sim) -> None:
        cfg = self.config
        self.sim = sim
        self.policy = sim.policy
        policy = self.policy
        self._inert = not cfg.reclamations and not (
            cfg.autoscale and cfg.max_joins > 0)
        if self._inert:
            return                      # zero-churn: touch nothing
        for t, rid in cfg.reclamations:
            assert 0 <= rid < len(policy.replicas), \
                f"reclamation of unknown replica {rid}"
            sim.push(t, "FLEET",
                     _FleetEvent(next(self._wids), "notice", rid))
            # same-timestamp slot order is insertion order, so with
            # notice_s == 0 the notice still applies before the reclaim
            sim.push(t + max(cfg.notice_s, 0.0), "FLEET",
                     _FleetEvent(next(self._wids), "reclaim", rid))
        if cfg.autoscale and cfg.max_joins > 0 \
                and hasattr(policy, "short_queue_tokens"):
            # pressure signals come from the coordinator (backlog in
            # batches); policies without an incremental short-queue counter
            # (FIFO et al.) simply do not autoscale
            self._coord = RoleCoordinator(policy.cc, policy.em)
            batch_s = policy.em.prefill_time(
                policy.cc.max_batch_tokens, 1, sp_mode="local")
            self._cooldown_s = max(cfg.cooldown_batches * batch_s, 1e-6)
            self._joins_left = cfg.max_joins

    # ------------------------------------------------------------------
    def on_event(self, t: float, ev: _FleetEvent) -> None:
        policy = self.policy
        if ev.action == "notice":
            rep = policy.replicas[ev.rid]
            if rep.retired:             # pragma: no cover - double reclaim
                return
            rep.reclaiming = True       # leaves every placement set
            policy.on_reclaim_notice(t, rep)
        elif ev.action == "reclaim":
            rep = policy.replicas[ev.rid]
            if rep.retired:             # pragma: no cover - double reclaim
                return
            if not rep.reclaiming:      # pragma: no cover - defensive
                rep.reclaiming = True
            policy.on_reclaim(t, rep)               # evacuate / restart
            policy.backend.reclaim_replica(t, ev.rid)   # park real KV
            policy.index.prefix_residency.drop_replica(ev.rid)
            rep.retire(t)
            policy.reclaims += 1
        elif ev.action == "join":
            rid = len(policy.replicas)
            cc = policy.cc
            node = rid // max(cc.gpus_per_node // cc.tp, 1)
            rep = ReplicaState(rid, node, role=ev.role)
            rep.joined_at = t
            rep.role_since = t
            policy.index.add_replica(rep)
            on_join = getattr(policy.backend, "on_join", None)
            if on_join is not None:
                on_join(t, rep)
            policy.on_join(t, rep)
            policy.joins += 1
        self.events.append((t, ev.action, ev.rid))

    # ------------------------------------------------------------------
    def step(self, t: float) -> None:
        """Autoscale hook, called before each dispatch pass.  Scale up when
        the short backlog exceeds what the idle prefill-capable replicas
        can absorb, at most once per cooldown window."""
        if self._inert or self._coord is None or self._joins_left <= 0:
            return
        if t - self._last_scale < self._cooldown_s:
            return
        policy = self.policy
        backlog = self._coord.backlog_batches(policy)
        idle_prefill = len(policy.index.idle_prefill)
        if backlog - idle_prefill < self.config.scale_up_backlog:
            return
        self._last_scale = t
        self._joins_left -= 1
        self.sim.push(t + max(self.config.provision_s, 0.0), "FLEET",
                      _FleetEvent(next(self._wids), "join", -1,
                                  role=self.config.join_role))

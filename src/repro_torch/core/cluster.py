"""Cluster model: chips -> replicas -> nodes, plus replica runtime state.

Replica roles are DYNAMIC (§5.2 coordination): every replica carries a
`role` that the scheduling policy may change at runtime through
`ReplicaState.set_role`, which also keeps the per-role occupancy and busy
clocks the role-utilization metrics read (core/metrics.py).

    general       prefill + in-place decode + long SP groups + colocation
                  (the paper's "colocated" serving role)
    prefill       a decode-pool replica borrowed for short prefill during a
                  prefill surge; serves short prefill ONLY, so it can be
                  returned to the pool the moment it drains
    short_decode  dedicated short-decode pool (§5.2 disaggregation)

A static split (the pre-coordination behaviour) is simply a cluster whose
roles never change after `build_replicas`.  Role transitions are the
policy/coordinator's job (core/coordinator.py) and only happen at safe
points — see RoleCoordinator.

Scheduling-state queries are O(1) through a `ClusterIndex`: the scheduling
fields of `ReplicaState` (`role`, `work`, `long_rid`, `claimed_by`,
`draining`, `long_phase`, `decode_load`) are properties whose setters keep
the index's membership sets current, so dispatch passes read
incrementally-maintained sets instead of rescanning ``policy.replicas``
(O(R) per pass — the 1000-replica hot path).  `ClusterIndex.audit()`
recomputes every set from scratch and raises on drift; the simulator-scale
property suite runs it after every dispatch pass.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Set

from repro_torch.core.costmodel import ReplicaSpec
from repro_torch.sp.planner import TPU_V5E, HardwareSpec

#: every role a replica can hold; prefill-capable = can run short prefill
ROLES = ("general", "prefill", "short_decode")
PREFILL_CAPABLE = ("general", "prefill")


@dataclass
class ClusterConfig:
    n_nodes: int = 4
    gpus_per_node: int = 8
    tp: int = 4                         # chips per model replica
    gpu_mem_bytes: float = 80e9        # per chip
    hw: HardwareSpec = TPU_V5E
    n_short_decode_replicas: int = 2    # PecSched dedicated decode pool
    max_batch_tokens: int = 4096        # short prefill batch size per replica
    max_coloc_tokens: int = 2048        # colocation cap per replica (paper §5.2)
    max_decode_concurrency: int = 64    # per decode replica
    decode_batch_eff: int = 8           # effective batching for decode tput
    kv_block_size: int = 16             # paged-KV block (prefix-cache grain)
    prefix_cache_groups: int = 64       # resident prefix groups per replica

    @property
    def n_gpus(self) -> int:
        return self.n_nodes * self.gpus_per_node

    @property
    def n_replicas(self) -> int:
        return self.n_gpus // self.tp

    def replica_spec(self) -> ReplicaSpec:
        return ReplicaSpec(tp=self.tp, mem_bytes=self.tp * self.gpu_mem_bytes,
                           hw=self.hw)


class ReplicaState:
    """Per-replica scheduling state.  The fields the dispatch path filters
    on are properties so every mutation — policies, the coordinator, tests
    poking `rep.work` directly — flows through the attached `ClusterIndex`."""

    __slots__ = ("rid", "node", "_role", "_work", "_claimed_by", "_long_rid",
                 "_long_phase", "_coloc_tokens", "_decode_load", "busy_time",
                 "queue_tokens", "_draining", "role_since", "role_time",
                 "busy_by_role", "_index", "_reclaiming", "retired_at",
                 "joined_at")

    def __init__(self, rid: int, node: int, role: str = "general"):
        self.rid = rid
        self.node = node
        self._role = role               # general | prefill | short_decode
        self._work = None               # current Work or None
        self._claimed_by = None         # pending long request id
        # long-request occupancy (this replica is part of a long group)
        self._long_rid: Optional[int] = None
        self._long_phase: Optional[str] = None  # prefill | decode
        self._coloc_tokens = 0          # tokens of colocated short prefill
        self._decode_load = 0           # concurrent short decodes (decode role)
        self.busy_time = 0.0            # accumulated for idle-rate metric
        self.queue_tokens = 0           # local queue length in tokens (§6.2)
        # --- dynamic-role bookkeeping (coordinator + metrics) ---
        self._draining = False          # decode replica: admits no NEW decode
        #                                 batches; flips once decode_load == 0
        self.role_since = 0.0           # when the current role began
        self.role_time: Dict[str, float] = {}
        self.busy_by_role: Dict[str, float] = {}
        self._index: Optional["ClusterIndex"] = None
        # --- fleet elasticity (core/fleet.py) ---
        self._reclaiming = False        # reclamation notice: no NEW placements
        self.retired_at: Optional[float] = None   # left the fleet at this time
        self.joined_at = 0.0            # joined the fleet at this time

    def __repr__(self) -> str:          # pragma: no cover - debug aid
        return (f"ReplicaState(rid={self.rid}, node={self.node}, "
                f"role={self._role!r}, idle={self.idle})")

    # ---- indexed scheduling fields -----------------------------------
    @property
    def role(self) -> str:
        return self._role

    @role.setter
    def role(self, value: str) -> None:
        self._role = value
        if self._index is not None:
            self._index.update(self)

    @property
    def work(self):
        return self._work

    @work.setter
    def work(self, value) -> None:
        self._work = value
        if self._index is not None:
            self._index.avail_changed(self)

    @property
    def claimed_by(self) -> Optional[int]:
        return self._claimed_by

    @claimed_by.setter
    def claimed_by(self, value: Optional[int]) -> None:
        old = self._claimed_by
        self._claimed_by = value
        if self._index is not None:
            self._index.claim_changed(self, old, value)
            self._index.occupancy_changed(self)

    @property
    def long_rid(self) -> Optional[int]:
        return self._long_rid

    @long_rid.setter
    def long_rid(self, value: Optional[int]) -> None:
        self._long_rid = value
        if self._index is not None:
            self._index.occupancy_changed(self)

    @property
    def long_phase(self) -> Optional[str]:
        return self._long_phase

    @long_phase.setter
    def long_phase(self, value: Optional[str]) -> None:
        self._long_phase = value
        if self._index is not None:
            self._index.phase_changed(self)

    @property
    def draining(self) -> bool:
        return self._draining

    @draining.setter
    def draining(self, value: bool) -> None:
        self._draining = value
        if self._index is not None:
            self._index.draining_changed(self)

    @property
    def coloc_tokens(self) -> int:
        return self._coloc_tokens

    @coloc_tokens.setter
    def coloc_tokens(self, value: int) -> None:
        self._coloc_tokens = value
        if self._index is not None:
            self._index.coloc_changed(self)

    @property
    def decode_load(self) -> int:
        return self._decode_load

    @decode_load.setter
    def decode_load(self, value: int) -> None:
        old = self._decode_load
        self._decode_load = value
        if self._index is not None and self._role == "short_decode":
            self._index.pool_decode_load += value - old

    @property
    def idle(self) -> bool:
        return self._work is None and self._long_rid is None

    # ---- fleet elasticity --------------------------------------------
    @property
    def reclaiming(self) -> bool:
        return self._reclaiming

    @reclaiming.setter
    def reclaiming(self, value: bool) -> None:
        self._reclaiming = value
        if self._index is not None:
            self._index.update(self)

    @property
    def retired(self) -> bool:
        return self.retired_at is not None

    @property
    def available(self) -> bool:
        """Eligible for NEW placements: neither under a reclamation notice
        nor already retired.  Every placement-set predicate requires this,
        so a noticed replica drains naturally while the fleet routes new
        work elsewhere."""
        return not self._reclaiming and self.retired_at is None

    def retire(self, t: float) -> None:
        """Leave the fleet at time `t`.  The caller (FleetController) must
        have evacuated the replica first — retiring with work, long-group
        membership, a claim, or live decode lanes would strand state the
        index can no longer see."""
        assert self._work is None and self._long_rid is None \
            and self._claimed_by is None and self._decode_load == 0, \
            f"retire of non-evacuated replica {self.rid}"
        self.retired_at = t
        # close the live role-occupancy interval so metrics stop charging
        # this replica's role after it is gone
        self.role_time[self._role] = self.role_time.get(self._role, 0.0) \
            + max(t - self.role_since, 0.0)
        self.role_since = t
        if self._index is not None:
            self._index.update(self)

    # ------------------------------------------------------------------
    def set_role(self, t: float, new_role: str) -> str:
        """Transition to `new_role` at time `t`, closing the occupancy
        interval of the old role.  Returns the old role.  Callers (the
        coordinator) are responsible for only flipping at safe points."""
        assert new_role in ROLES, new_role
        old = self._role
        self.role_time[old] = self.role_time.get(old, 0.0) \
            + max(t - self.role_since, 0.0)
        self._role = new_role
        self.role_since = t
        self._draining = False
        if self._index is not None:
            self._index.update(self)
        return old

    def add_busy(self, dt: float) -> None:
        """Accumulate busy time, bucketed by the role it was served under."""
        self.busy_time += dt
        try:                            # hot: the role key exists after the
            self.busy_by_role[self._role] += dt     # first interval closes
        except KeyError:
            self.busy_by_role[self._role] = dt

    def role_occupancy(self, t_end: float) -> Dict[str, float]:
        """Seconds spent in each role up to `t_end` (closes the live
        interval without mutating state).  A retired replica's intervals
        were closed by `retire`, so nothing accrues past its departure."""
        out = dict(self.role_time)
        if self.retired_at is None:
            out[self._role] = out.get(self._role, 0.0) \
                + max(t_end - self.role_since, 0.0)
        return out

    def lifespan(self, t_end: float) -> float:
        """Seconds this replica was part of the fleet within [0, t_end] —
        the idle-rate denominator for elastic fleets."""
        end = t_end if self.retired_at is None else min(self.retired_at, t_end)
        return max(end - self.joined_at, 0.0)


class PrefixResidency:
    """Per-replica map of which prefix GROUPS have KV resident, and how many
    leading tokens of the group's context each replica holds — the
    dispatch-time cache-affinity signal (analytic twin of the engines'
    block-hash index).

    Residency is block-quantized (`block_size`, matching the paged pool's
    grain: only whole blocks are shareable) and bounded per replica to
    `max_groups` groups with LRU eviction — a replica's HBM does not hold
    unbounded stale prefixes, and neither does this map.  Deliberately NOT
    part of `ClusterIndex.expected()`/`audit()`: it is advisory routing
    state (a stale entry costs performance, never correctness), not a
    membership set derived from replica fields."""

    __slots__ = ("block_size", "max_groups", "_maps")

    def __init__(self, n_replicas: int, *, block_size: int = 16,
                 max_groups: int = 64):
        self.block_size = max(int(block_size), 1)
        self.max_groups = max(int(max_groups), 1)
        self._maps: Dict[int, "OrderedDict[int, int]"] = {
            rid: OrderedDict() for rid in range(n_replicas)}

    def _blocks(self, tokens: int) -> int:
        return (tokens // self.block_size) * self.block_size

    def cached_tokens(self, rid: int, group: Optional[int],
                      prefix_len: int) -> int:
        """Whole-block tokens of `group`'s prefix resident on `rid` that a
        request with `prefix_len` reusable tokens could actually skip."""
        if group is None or prefix_len <= 0:
            return 0
        m = self._maps.get(rid)
        if m is None:
            return 0
        have = m.get(group, 0)
        return self._blocks(min(have, prefix_len))

    def record(self, rid: int, group: Optional[int], tokens: int) -> None:
        """After a prefill on `rid`: the group's resident context grows to
        at least `tokens` (LRU-touch; bounded per replica)."""
        if group is None or tokens <= 0:
            return
        m = self._maps.setdefault(rid, OrderedDict())
        have = m.pop(group, 0)
        m[group] = max(have, self._blocks(tokens))
        while len(m) > self.max_groups:
            m.popitem(last=False)

    def best_replica(self, candidates, group: Optional[int],
                     prefix_len: int):
        """(replica id, cached tokens) maximizing the block-rounded hit over
        `candidates`; ties break to the lowest rid (the historical scan
        order).  (None, 0) when nothing is resident."""
        best_rid, best = None, 0
        for rid in sorted(candidates):
            c = self.cached_tokens(rid, group, prefix_len)
            if c > best:
                best_rid, best = rid, c
        return best_rid, best

    def drop_replica(self, rid: int) -> None:
        """Forget everything resident on `rid` — the analytic twin of the
        engine dropping its block-hash `cached` index when the replica is
        reclaimed.  Unknown rids are a no-op (a replica that never recorded
        residency has nothing to drop)."""
        self._maps.pop(rid, None)

    def add_replica(self, rid: int) -> None:
        """Start tracking a joining replica (empty residency)."""
        self._maps.setdefault(rid, OrderedDict())

    def clear(self) -> None:
        for m in self._maps.values():
            m.clear()


class ClusterIndex:
    """Incrementally-maintained membership sets over a replica list.

    Every set holds replica ids (ints), kept current by the `ReplicaState`
    property setters.  Dispatch paths read these instead of rescanning all
    replicas — the per-pass O(R) -> O(1) change that makes 1000-replica
    fleets simulable.  Sets and their predicates:

        idle_general    role == "general" and idle and unclaimed
        idle_prefill    role in PREFILL_CAPABLE and idle and unclaimed
        free_general    role == "general", in no long group, unclaimed
                        (busy with short work allowed — the long-claim pool)
        active_pool     role == "short_decode" and not draining
        draining_pool   role == "short_decode" and draining
        by_role[r]      every replica currently holding role r
        long_decode     long_phase == "decode" (colocation candidates)
        coloc_room      long_decode members with coloc_tokens headroom
                        (< max_coloc_tokens); == long_decode when no cap set
        claims[rid]     replicas claimed by pending long request `rid`

    plus `pool_decode_load`, the summed `decode_load` of the short_decode
    pool (the coordinator's decode-demand signal, O(1) instead of a sum).

    Selection order contract: callers that need the historical scan order
    (replica-list order == ascending rid) use `min(set)` / `sorted(set)`,
    which is identical because rids are dense and list-ordered.

    Elastic fleets (core/fleet.py) preserve that contract by never
    renumbering: a joining replica appends with rid == len(replicas), and a
    leaving replica is marked `retired` — dropped from every membership set
    but still list-addressable, so `self.replicas[rid]` and the dense-rid
    ordering stay valid for the survivors.  A replica under a reclamation
    notice (`reclaiming`) keeps its role but leaves every PLACEMENT set, so
    in-flight work drains while nothing new lands on it.
    """

    __slots__ = ("replicas", "by_role", "idle_general", "idle_prefill",
                 "free_general", "active_pool", "draining_pool",
                 "long_decode", "coloc_room",
                 "max_coloc_tokens", "claims", "pool_decode_load",
                 "n_queries", "n_rescans", "prefix_residency")

    def __init__(self, replicas: List[ReplicaState],
                 max_coloc_tokens: Optional[int] = None):
        self.replicas = replicas
        self.max_coloc_tokens = max_coloc_tokens
        self.by_role: Dict[str, Set[int]] = {r: set() for r in ROLES}
        self.idle_general: Set[int] = set()
        self.idle_prefill: Set[int] = set()
        self.free_general: Set[int] = set()
        self.active_pool: Set[int] = set()
        self.draining_pool: Set[int] = set()
        self.long_decode: Set[int] = set()
        self.coloc_room: Set[int] = set()
        self.claims: Dict[int, Set[int]] = {}
        self.pool_decode_load = 0
        self.n_queries = 0              # profile: index-backed lookups
        self.n_rescans = 0              # profile: O(R) fallback scans
        # Advisory cache-affinity map; policies that route on prefix
        # residency replace this with one sized from their ClusterConfig.
        # Excluded from expected()/audit() by design (see PrefixResidency).
        self.prefix_residency = PrefixResidency(len(replicas))
        for rep in replicas:
            rep._index = self
            if rep._claimed_by is not None:     # pragma: no cover - defensive
                self.claims.setdefault(rep._claimed_by, set()).add(rep.rid)
            if rep._role == "short_decode":
                self.pool_decode_load += rep._decode_load
            self.update(rep)

    # ------------------------------------------------------------------
    # Specialized transitions: each setter touches only the sets its field
    # can affect.  `work` flips ~200K times per 10K-request replay, so the
    # difference between these few set ops and the full `update` recompute
    # is a first-order term in dispatch throughput.  `audit()` checks the
    # specializations cover their fields' full footprint.
    def avail_changed(self, rep: ReplicaState) -> None:
        """`work` changed: only the idle sets (idle ∧ unclaimed) move."""
        rid = rep.rid
        if rep._work is None and rep._long_rid is None \
                and rep._claimed_by is None and rep.available:
            role = rep._role
            if role == "general":
                self.idle_general.add(rid)
                self.idle_prefill.add(rid)
            elif role == "prefill":
                self.idle_prefill.add(rid)
        else:
            self.idle_general.discard(rid)
            self.idle_prefill.discard(rid)

    def set_work_many(self, reps: List[ReplicaState], w) -> None:
        """Batch ``rep.work = w`` over a gang (SP long prefill pause/resume
        touches every group member): one call with the idle-set transitions
        inlined, instead of a property-setter round-trip per replica."""
        ig, ip = self.idle_general, self.idle_prefill
        if w is None:
            for rep in reps:
                rep._work = None
                if rep._long_rid is None and rep._claimed_by is None \
                        and rep.available:
                    role = rep._role
                    if role == "general":
                        ig.add(rep.rid)
                        ip.add(rep.rid)
                    elif role == "prefill":
                        ip.add(rep.rid)
        else:
            for rep in reps:
                rep._work = w
                rid = rep.rid
                ig.discard(rid)
                ip.discard(rid)

    def occupancy_changed(self, rep: ReplicaState) -> None:
        """`long_rid` or `claimed_by` changed: idle sets + free_general."""
        self.avail_changed(rep)
        if rep._role == "general" and rep._long_rid is None \
                and rep._claimed_by is None and rep.available:
            self.free_general.add(rep.rid)
        else:
            self.free_general.discard(rep.rid)

    def phase_changed(self, rep: ReplicaState) -> None:
        """`long_phase` changed: only the colocation-candidate sets move."""
        if rep._long_phase == "decode" and rep.retired_at is None:
            self.long_decode.add(rep.rid)
            if rep.available and (self.max_coloc_tokens is None
                                  or rep._coloc_tokens < self.max_coloc_tokens):
                self.coloc_room.add(rep.rid)
            else:
                self.coloc_room.discard(rep.rid)
        else:
            self.long_decode.discard(rep.rid)
            self.coloc_room.discard(rep.rid)

    def coloc_changed(self, rep: ReplicaState) -> None:
        """`coloc_tokens` changed: only headroom membership moves."""
        if rep._long_phase == "decode" and rep.available and (
                self.max_coloc_tokens is None
                or rep._coloc_tokens < self.max_coloc_tokens):
            self.coloc_room.add(rep.rid)
        else:
            self.coloc_room.discard(rep.rid)

    def draining_changed(self, rep: ReplicaState) -> None:
        """`draining` changed: only the active/draining pool split moves.
        A reclaiming/retired replica joins NEITHER pool: the coordinator
        must not count it as capacity nor flip its role once drained."""
        rid = rep.rid
        if rep._role == "short_decode" and rep.available:
            if rep._draining:
                self.active_pool.discard(rid)
                self.draining_pool.add(rid)
            else:
                self.active_pool.add(rid)
                self.draining_pool.discard(rid)
        else:
            self.active_pool.discard(rid)
            self.draining_pool.discard(rid)

    def update(self, rep: ReplicaState) -> None:
        """Recompute `rep`'s membership in every set (O(#sets), called from
        the role setters — any other mutation takes a specialized
        transition above)."""
        rid = rep.rid
        role = rep._role
        avail = rep.available
        for r, members in self.by_role.items():
            if r == role and rep.retired_at is None:
                members.add(rid)
            else:
                members.discard(rid)
        idle_unclaimed = (rep._work is None and rep._long_rid is None
                         and rep._claimed_by is None and avail)
        if role == "general" and idle_unclaimed:
            self.idle_general.add(rid)
        else:
            self.idle_general.discard(rid)
        if role in PREFILL_CAPABLE and idle_unclaimed:
            self.idle_prefill.add(rid)
        else:
            self.idle_prefill.discard(rid)
        if role == "general" and rep._long_rid is None \
                and rep._claimed_by is None and avail:
            self.free_general.add(rid)
        else:
            self.free_general.discard(rid)
        if role == "short_decode" and not rep._draining and avail:
            self.active_pool.add(rid)
        else:
            self.active_pool.discard(rid)
        if role == "short_decode" and rep._draining and avail:
            self.draining_pool.add(rid)
        else:
            self.draining_pool.discard(rid)
        self.phase_changed(rep)

    def add_replica(self, rep: ReplicaState) -> None:
        """A new replica joins the fleet (autoscale-up).  It appends to the
        SAME list object every policy holds as `self.replicas`, with the
        next dense rid, so existing `min(set)`/`sorted(set)` selection and
        `replicas[rid]` addressing keep working unchanged."""
        assert rep.rid == len(self.replicas), \
            f"joining rid {rep.rid} must extend the dense rid space " \
            f"(expected {len(self.replicas)})"
        self.replicas.append(rep)
        rep._index = self
        self.prefix_residency.add_replica(rep.rid)
        if rep._role == "short_decode":
            self.pool_decode_load += rep._decode_load
        self.update(rep)

    def claim_changed(self, rep: ReplicaState, old: Optional[int],
                      new: Optional[int]) -> None:
        if old is not None:
            members = self.claims.get(old)
            if members is not None:
                members.discard(rep.rid)
                if not members:
                    del self.claims[old]
        if new is not None:
            self.claims.setdefault(new, set()).add(rep.rid)

    # ------------------------------------------------------------------
    def expected(self) -> Dict[str, object]:
        """Brute-force recomputation of every set from the replica list."""
        exp: Dict[str, object] = {
            "by_role": {r: set() for r in ROLES},
            "idle_general": set(), "idle_prefill": set(),
            "free_general": set(), "active_pool": set(),
            "draining_pool": set(),
            "long_decode": set(), "coloc_room": set(),
            "claims": {}, "pool_decode_load": 0,
        }
        for rep in self.replicas:
            if rep.retired_at is not None:
                # a retired replica is a member of nothing except any
                # lingering claim bookkeeping (which retire() forbids)
                continue
            avail = rep.available
            exp["by_role"][rep._role].add(rep.rid)
            idle_unclaimed = (rep._work is None and rep._long_rid is None
                             and rep._claimed_by is None and avail)
            if rep._role == "general" and idle_unclaimed:
                exp["idle_general"].add(rep.rid)
            if rep._role in PREFILL_CAPABLE and idle_unclaimed:
                exp["idle_prefill"].add(rep.rid)
            if rep._role == "general" and rep._long_rid is None \
                    and rep._claimed_by is None and avail:
                exp["free_general"].add(rep.rid)
            if rep._role == "short_decode" and not rep._draining and avail:
                exp["active_pool"].add(rep.rid)
            if rep._role == "short_decode" and rep._draining and avail:
                exp["draining_pool"].add(rep.rid)
            if rep._long_phase == "decode":
                exp["long_decode"].add(rep.rid)
                if avail and (self.max_coloc_tokens is None
                              or rep._coloc_tokens < self.max_coloc_tokens):
                    exp["coloc_room"].add(rep.rid)
            if rep._claimed_by is not None:
                exp["claims"].setdefault(rep._claimed_by, set()).add(rep.rid)
            if rep._role == "short_decode":
                exp["pool_decode_load"] += rep._decode_load
        return exp

    def audit(self) -> None:
        """Assert the incremental sets equal a from-scratch rescan (the
        correctness bar for every optimization built on this index)."""
        exp = self.expected()
        got = {"by_role": self.by_role, "idle_general": self.idle_general,
               "idle_prefill": self.idle_prefill,
               "free_general": self.free_general,
               "active_pool": self.active_pool,
               "draining_pool": self.draining_pool,
               "long_decode": self.long_decode,
               "coloc_room": self.coloc_room, "claims": self.claims,
               "pool_decode_load": self.pool_decode_load}
        for key, want in exp.items():
            assert got[key] == want, \
                f"ClusterIndex drift in {key}: {got[key]!r} != {want!r}"


def build_replicas(cc: ClusterConfig, *, dedicated_decode: bool) -> List[ReplicaState]:
    reps = []
    per_node = cc.gpus_per_node // cc.tp
    for i in range(cc.n_replicas):
        reps.append(ReplicaState(rid=i, node=i // max(per_node, 1)))
    if dedicated_decode:
        for i in range(min(cc.n_short_decode_replicas, len(reps) - 1)):
            reps[len(reps) - 1 - i].role = "short_decode"
    return reps

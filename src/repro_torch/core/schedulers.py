"""Cluster scheduling policies: FIFO, Reservation, Priority (the paper's §2.1
baselines) and PecSched (§5) with its ablations /PE /Dis /CoL /FSP (§6.4).

Policy classes vs the paper's sections and artifacts:

================== ======================= ===============================
class / variant     paper section           figure / table it reproduces
================== ======================= ===============================
FIFOPolicy          §2.1 (vLLM-style)       Fig.2 (HOL blocking), Figs.9-11
                                            baselines
FIFOPolicy          §3.2 "without longs"    Fig.2 no-long comparison arm
 (admit_long=False)
ReservationPolicy   §2.1 (Llumnix-style)    Table 1 (idle rate), Fig.3
PriorityPolicy      §2.1 (Past-Future)      Table 2 (long starvation)
PecSchedPolicy      §5 (full system)        Figs.9-11 (overall), Table 6/7
 pecsched/pe        §6.4 no preemption      Fig.12 ablation
 pecsched/dis       §6.4 no disaggregation  Fig.13 ablation
 pecsched/col       §6.4 no colocation      Table 6 ablation
 pecsched/fsp       §6.4 ring-only SP       Fig.14 + Table 3/6 ablation
 pecsched/coord     §5.2 load-adaptive      coordination-vs-static claim
                    role coordination       cells (bursty / diurnal)
 pecsched/cache     beyond-paper (vLLM-v1   prefix-cache hit-rate / TTFT
  /cache_greedy     prefix caching): cache- claim cells (chat_multiturn,
                    affinity routing +      shared_prefix) + the greedy
                    discounted prefill      affinity-vs-balance ablation
PecSchedSLOPolicy   beyond-paper (TetriSched slo_* claim cells (slo_tiered):
 pecsched/slo       -style plan-ahead):     goodput + per-tier attainment
                    slack order, shed,      under MMPP bursts
                    long-claim retraction
PredSJFPolicy       beyond-paper (ELIS /    prediction-robustness sweep
 sjf_pred[:pred]    Beyond-Prediction):     (EXPERIMENTS.md §Prediction-
 tail_aware[:pred]  predicted-SJF + decode- robustness) + pred_* claims
                    lane preemption
================== ======================= ===============================

Dispatch contract with the driver: the Simulator applies every event at a
timestamp (policy.on_arrival / policy.on_done), then calls policy.dispatch(t)
ONCE for that timestamp. Policies start work via `_start` (which submits the
Work to the bound ExecutionBackend) and revoke in-flight work via
`self.backend.cancel(work)` — O(1) removal from the event heap, no dead Work
lingering until its timestamp.

Policies never execute anything and never push events themselves: the
backend decides when (SimBackend: at the analytic `duration`) and how
(EngineBackend: real JAX engines, measured compute) a Work completes.  The
same policy object therefore drives both the 100 K-request analytic sweeps
and the real-engine mini cluster, unmodified.
"""
from __future__ import annotations

import heapq
import itertools
import math
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.cluster import (PREFILL_CAPABLE, ClusterConfig, ClusterIndex,
                                PrefixResidency, ReplicaState, build_replicas)
from repro_torch.core.coordinator import CoordinatorConfig, RoleCoordinator
from repro_torch.core.costmodel import ExecutionModel
from repro_torch.core.predictor import Predictor, make_predictor
from repro_torch.core.request import Phase, Request
from repro_torch.core.simulator import Work


class BasePolicy:
    name = "base"

    def __init__(self, cc: ClusterConfig, em: ExecutionModel, *,
                 dedicated_decode: bool = False,
                 predictor: Optional[Predictor] = None):
        self.cc = cc
        self.em = em
        self.replicas = build_replicas(cc, dedicated_decode=dedicated_decode)
        #: incrementally-maintained idle/role/claim sets over the replicas;
        #: every dispatch path reads these instead of O(R) rescans
        self.index = ClusterIndex(self.replicas,
                                  max_coloc_tokens=cc.max_coloc_tokens)
        self._wid = itertools.count()
        self.sim = None
        self.backend = None
        #: output-length predictor (core/predictor.py) — the ONLY sanctioned
        #: path to output-length information at decision time; policies that
        #: want it go through `predict_output`, never `Request.output_len`
        self.predictor = predictor
        self.done_requests: List[Request] = []
        self.all_requests: List[Request] = []
        #: streaming-metrics accumulator (core/metrics.py).  None (default)
        #: = retained mode: every Request is kept in all_/done_requests and
        #: summarize reads them, byte-identical to the historical contract.
        #: Set via enable_streaming_metrics() for bounded-memory replays:
        #: per-request stats fold into typed numpy buffers at completion
        #: and the request lists stay empty.
        self.metrics_acc = None
        self.preemption_events = 0          # total suspensions (paper Table 3/6)
        self.decode_preemption_events = 0   # decode-lane evictions (sjf_pred)
        # --- elastic-fleet counters (core/fleet.py; metrics.summarize) ---
        self.reclaims = 0                   # replicas reclaimed mid-run
        self.evacuated_blocks = 0           # KV blocks migrated off reclaimed
        #                                     replicas (cost-model block grain)
        self.restarted_requests = 0         # stranded work restarted from queue
        self.joins = 0                      # autoscale joins applied mid-run
        self.per_request_sched: Dict[int, float] = {}
        # cross-backend parity harness: when enabled, every placement,
        # preemption and role-flip decision is appended as a tuple so two
        # backends' runs can be compared event-for-event (tests/test_backends)
        self.record_decisions = False
        self.decision_log: List[tuple] = []
        # role-transition log: (t, rid, old_role, new_role) per flip — the
        # coordinator appends via _flip_role; metrics reads it
        self.role_log: List[tuple] = []

    # ------------------------------------------------------------------
    def bind(self, backend) -> None:
        self.backend = backend
        self.sim = backend.sim

    def on_arrival(self, t: float, req: Request) -> None:
        raise NotImplementedError

    def on_done(self, t: float, work: Work) -> None:
        raise NotImplementedError

    def dispatch(self, t: float) -> None:
        raise NotImplementedError

    def needs_dispatch(self, t: float) -> bool:
        """Could dispatch(t) possibly act right now?  The simulator skips
        the dispatch pass when this is False (dirty-dispatch elision), so a
        subclass override MUST be proven no-op-equivalent: False only when
        its dispatch body provably places/preempts/flips nothing.  The base
        answer is the always-safe True."""
        return True

    def enable_streaming_metrics(self) -> "BasePolicy":
        """Switch to streaming metrics: per-request stats accumulate into
        numpy buffers at completion instead of retaining Request lists —
        the memory-flat mode for 1M-request replays.  Call before run()."""
        from repro_torch.core.metrics import MetricsAccumulator
        self.metrics_acc = MetricsAccumulator(self.em)
        return self

    def _record_arrival(self, req: Request) -> None:
        if self.metrics_acc is None:
            self.all_requests.append(req)
        else:
            self.metrics_acc.arrive(req)

    def _complete_request(self, req: Request) -> None:
        if self.metrics_acc is None:
            self.done_requests.append(req)
        else:
            self.metrics_acc.complete(req)

    # ------------------------------------------------------------------
    def _start(self, t: float, kind: str, reqs: List[Request],
               rep_ids: List[int], duration: float, *, colocated=False,
               sp_mode: str = "local") -> Work:
        w = Work(wid=next(self._wid), kind=kind, replica_ids=rep_ids,
                 requests=reqs, start=t, duration=duration, colocated=colocated,
                 sp_mode=sp_mode)
        if colocated:
            tok_share = sum(r.input_len for r in reqs) // max(len(rep_ids), 1)
            for rid in rep_ids:
                self.replicas[rid].coloc_tokens += tok_share
        else:
            reps = [self.replicas[rid] for rid in rep_ids]
            for rep in reps:
                assert rep._work is None, f"replica {rep.rid} busy"
            self.index.set_work_many(reps, w)
        self._emit(w)
        return w

    def _emit(self, w: Work) -> None:
        if self.record_decisions:
            self.decision_log.append(
                ("start", w.kind, tuple(w.replica_ids),
                 tuple(r.rid for r in w.requests)))
        self.backend.submit(w)

    def _release(self, work: Work, *, busy: Optional[float] = None) -> None:
        if work.colocated:
            tok_share = sum(r.input_len for r in work.requests) \
                // max(len(work.replica_ids), 1)
            for rid in work.replica_ids:
                rep = self.replicas[rid]
                rep.coloc_tokens = max(0, rep.coloc_tokens - tok_share)
            return
        dt = busy if busy is not None else work.duration
        rids = work.replica_ids
        if len(rids) == 1:                   # hot path: short/decode work
            rep = self.replicas[rids[0]]
            rep.busy_time += dt
            bbr = rep.busy_by_role
            try:
                bbr[rep._role] += dt
            except KeyError:
                bbr[rep._role] = dt
            if rep._work is work:
                self.index.set_work_many((rep,), None)
            return
        cleared = []
        for rid in rids:
            rep = self.replicas[rid]
            if rep._work is work:
                cleared.append(rep)
            # add_busy inlined: SP gang pause/resume releases run this loop
            # tens of thousands of times per replay
            rep.busy_time += dt
            role = rep._role
            bbr = rep.busy_by_role
            try:
                bbr[role] += dt
            except KeyError:
                bbr[role] = dt
        if cleared:
            self.index.set_work_many(cleared, None)

    def predict_output(self, req: Request,
                       quantile: Optional[float] = None) -> Optional[float]:
        """Scheduler-visible output-length estimate for `req` (tokens):
        the predictor's point estimate, or its `quantile` when hedging.
        Returns None when the policy carries no predictor."""
        if self.predictor is None:
            return None
        if quantile is not None:
            return max(self.predictor.quantile(req, quantile), 1.0)
        return max(self.predictor.predict(req), 1.0)

    def _idle_general(self, *, unclaimed=True) -> List[ReplicaState]:
        if unclaimed:
            # index-backed: ascending rid == the replica-list scan order
            self.index.n_queries += 1
            return [self.replicas[i] for i in sorted(self.index.idle_general)]
        self.index.n_rescans += 1
        return [r for r in self.replicas if r.role == "general" and r.idle]

    def _flip_role(self, t: float, rep: ReplicaState, new_role: str) -> str:
        """Apply a coordinator role flip: transition the replica, record it
        in the transition (and parity) logs, notify the backend so real
        engines can verify the safe point actually held."""
        old = rep.set_role(t, new_role)
        self.role_log.append((t, rep.rid, old, new_role))
        if self.record_decisions:
            self.decision_log.append(("role", rep.rid, old, new_role))
        if self.backend is not None:
            self.backend.role_change(t, rep.rid, old, new_role)
        return old

    def _batch_shorts(self, queue: deque, max_tokens: int) -> List[Request]:
        batch, tok = [], 0
        while queue and tok + queue[0].input_len <= max_tokens:
            r = queue.popleft()
            batch.append(r)
            tok += r.input_len
        if not batch and queue:       # single oversize short still runs alone
            batch.append(queue.popleft())
        return batch

    # ------------------------------------------------------------------
    # Elastic-fleet hooks (called by core/fleet.py's FleetController).
    # None of these run on a churn-free trace, so a policy that never sees
    # churn behaves bit-identically to one predating these hooks.
    # ------------------------------------------------------------------
    def _kv_blocks(self, tokens: int) -> int:
        """Cost-model KV footprint of `tokens` in paged-cache blocks."""
        return -(-int(tokens) // max(self.cc.kv_block_size, 1))

    def _requeue_front(self, req: Request) -> None:
        """Put a restarted request back at the FRONT of the policy's queue
        (it already waited its turn once).  Subclasses route to their own
        queue structure."""
        raise NotImplementedError

    def _restart_requests(self, t: float, reqs: List[Request]) -> None:
        """Restart-from-scratch arm of graceful degradation: the stranded
        requests lose their compute (the replica's KV dies with it) and
        requeue at the front in original order."""
        for r in reversed(reqs):
            r.phase = Phase.QUEUED
            r.prefill_start = None
            r.first_token = None
            self.restarted_requests += 1
            self._requeue_front(r)

    def on_reclaim_notice(self, t: float, rep: ReplicaState) -> None:
        """A reclamation notice landed on `rep`.  The index already dropped
        it from every placement set, so the default is to let in-flight
        work drain through the notice window; subclasses may act earlier."""

    def on_reclaim(self, t: float, rep: ReplicaState) -> None:
        """Vacate `rep` NOW — its reclamation deadline fired.  After this
        returns the replica must hold no work, no long-group membership, no
        claim, and no decode load (FleetController retires it next).  The
        default covers policies whose entire occupancy is `rep.work`:
        cancel it (gang-wide) and restart its requests."""
        w = rep.work
        if w is not None and not w.canceled:
            self.backend.cancel(w)
            self._release(w, busy=max(t - w.start, 0.0))
            self._restart_requests(t, w.requests)

    def on_join(self, t: float, rep: ReplicaState) -> None:
        """A new replica joined (autoscale-up).  The index has already
        admitted it to the placement sets, which is all most policies need;
        subclasses with construction-time capacity snapshots refresh them
        here."""

    # ------------------------------------------------------------------
    def finalize(self, t: float) -> None:
        pass

    def summary(self, t_end: float) -> Dict:
        from repro_torch.core.metrics import summarize
        return summarize(self, t_end)


# ===========================================================================
# Baselines. All run prefill+decode on the same replicas (no disaggregation)
# and use ring-attention SP for long requests (§6.2 comparison setup).
# ===========================================================================
class FIFOPolicy(BasePolicy):
    """vLLM-style FIFO: strict arrival order; long requests block the head."""
    name = "fifo"

    def __init__(self, cc, em, *, admit_long=True):
        super().__init__(cc, em)
        self.queue: deque = deque()
        self.admit_long = admit_long

    def on_arrival(self, t, req):
        self._record_arrival(req)
        if req.is_long and not self.admit_long:
            return
        self.queue.append(req)

    def on_done(self, t, work):
        self._release(work)
        # monolithic work (prefill + decode in one Work): reconstruct the
        # first-token time from the memoized decode price so TTFT is defined
        # for the baselines too — same expressions `_run_short_batch` /
        # `_run_long` priced the work with, so first_token >= prefill_start
        # holds on the analytic clock of either backend
        if work.kind == "long_full":
            for r in work.requests:
                r.first_token = t - self.em.decode_time(
                    r.output_len, r.input_len, batch=1)
        else:
            reqs = work.requests
            tokens = sum(r.input_len for r in reqs)
            max_out = max(r.output_len for r in reqs)
            dec = self.em.decode_time(max_out, tokens // len(reqs),
                                      batch=len(reqs))
            for r in reqs:
                r.first_token = t - dec
        for r in work.requests:
            r.phase = Phase.DONE
            r.finish = t
            self._complete_request(r)

    def _run_short_batch(self, t, reqs, rep: ReplicaState):
        tokens = sum(r.input_len for r in reqs)
        max_out = max(r.output_len for r in reqs)
        d = (self.em.prefill_time(tokens, 1, sp_mode="local")
             + self.em.decode_time(max_out, tokens // len(reqs),
                                   batch=len(reqs)))
        for r in reqs:
            r.phase = Phase.PREFILL
            r.prefill_start = t
        self._start(t, "short_full", reqs, [rep.rid], d)

    def _run_long(self, t, req, reps: List[ReplicaState]):
        R = len(reps)
        d = (self.em.prefill_time(req.input_len, R, sp_mode="ring")
             + self.em.decode_time(req.output_len, req.input_len, batch=1))
        req.phase = Phase.PREFILL
        req.prefill_start = t
        self._start(t, "long_full", [req], [r.rid for r in reps], d,
                    sp_mode="ring")

    def needs_dispatch(self, t):
        return bool(self.queue)

    def dispatch(self, t):
        idle = self.index.idle_general
        while self.queue:
            head = self.queue[0]
            if head.is_long:
                R = self.em.replicas_needed(head.input_len)
                if len(idle) < R:
                    return                      # head-of-line blocking
                self.queue.popleft()
                # ascending rid == rid-order scan + stable node sort (node
                # is monotonic in rid), i.e. the same-node preference
                reps = [self.replicas[i] for i in sorted(idle)[:R]]
                self._run_long(t, head, reps)
            else:
                if not idle:
                    return
                batch = self._batch_shorts(self.queue, self.cc.max_batch_tokens)
                # FIFO: batch must not skip over a long head; _batch_shorts only
                # pulls consecutive heads, preserving order.
                self._run_short_batch(t, batch, self.replicas[min(idle)])

    def _batch_shorts(self, queue, max_tokens):
        batch, tok = [], 0
        while queue and not queue[0].is_long and \
                tok + queue[0].input_len <= max_tokens:
            r = queue.popleft()
            batch.append(r)
            tok += r.input_len
        if not batch and queue and not queue[0].is_long:
            batch.append(queue.popleft())
        return batch

    def _requeue_front(self, req):
        self.queue.appendleft(req)


class ReservationPolicy(FIFOPolicy):
    """Llumnix-style reservation: a dedicated replica set sized for 500 K-token
    requests serves longs; the rest serve shorts (§6.2)."""
    name = "reservation"

    def __init__(self, cc, em, *, concurrent_longs: int = 3):
        super().__init__(cc, em)
        # §6.2: pre-allocate GPUs capable of serving 500K-token requests;
        # sized for a few concurrent longs (this is what drives the paper's
        # high reservation idle rates, Table 1).
        R = min(em.replicas_needed(500_000) * concurrent_longs,
                max(cc.n_replicas // 2, 1))
        self.reserved = set(r.rid for r in self.replicas[:R])
        self.short_queue: deque = deque()
        self.long_queue: deque = deque()

    def on_arrival(self, t, req):
        self._record_arrival(req)
        (self.long_queue if req.is_long else self.short_queue).append(req)

    def needs_dispatch(self, t):
        return bool(self.short_queue or self.long_queue)

    def dispatch(self, t):
        # long side (reserved replicas are always general and never claimed,
        # so idle membership is exactly the idle_general index)
        while self.long_queue:
            avail = self.index.idle_general & self.reserved
            head = self.long_queue[0]
            # the reserved pool is sized to *hold* a 500K request; a request
            # never demands more replicas than the pool provides
            R = min(self.em.replicas_needed(head.input_len), len(self.reserved))
            if len(avail) < R:
                break
            self.long_queue.popleft()
            self._run_long(t, head,
                           [self.replicas[i] for i in sorted(avail)[:R]])
        # short side
        while self.short_queue:
            avail = self.index.idle_general - self.reserved
            if not avail:
                break
            batch = self._batch_shorts(self.short_queue, self.cc.max_batch_tokens)
            self._run_short_batch(t, batch, self.replicas[min(avail)])

    def _batch_shorts(self, queue, max_tokens):
        batch, tok = [], 0
        while queue and tok + queue[0].input_len <= max_tokens:
            r = queue.popleft()
            batch.append(r)
            tok += r.input_len
        if not batch and queue:
            batch.append(queue.popleft())
        return batch

    def _requeue_front(self, req):
        (self.long_queue if req.is_long else self.short_queue).appendleft(req)

    def on_reclaim(self, t, rep):
        super().on_reclaim(t, rep)
        # the reserved long pool shrinks with the fleet; never let it empty
        # while general capacity remains, or longs would starve forever
        self.reserved.discard(rep.rid)
        if not self.reserved:
            cands = [r.rid for r in self.replicas
                     if r.available and r.rid != rep.rid
                     and r.role == "general"]
            if cands:
                self.reserved.add(min(cands))


class PriorityPolicy(FIFOPolicy):
    """Past-Future-style priority: shorts get strict priority; longs run only
    when no short is waiting — which starves them (§3.2 Table 2)."""
    name = "priority"

    def __init__(self, cc, em):
        super().__init__(cc, em)
        self.short_queue: deque = deque()
        self.long_queue: deque = deque()

    def on_arrival(self, t, req):
        self._record_arrival(req)
        (self.long_queue if req.is_long else self.short_queue).append(req)

    def needs_dispatch(self, t):
        return bool(self.short_queue or self.long_queue)

    def dispatch(self, t):
        idle = self.index.idle_general
        while self.short_queue:
            if not idle:
                return
            batch = ReservationPolicy._batch_shorts(self, self.short_queue,
                                                    self.cc.max_batch_tokens)
            self._run_short_batch(t, batch, self.replicas[min(idle)])
        while self.long_queue and not self.short_queue:
            head = self.long_queue[0]
            R = self.em.replicas_needed(head.input_len)
            if len(idle) < R:
                return
            self.long_queue.popleft()
            self._run_long(t, head,
                           [self.replicas[i] for i in sorted(idle)[:R]])

    def finalize(self, t):
        for r in self.long_queue:
            r.phase = Phase.STARVED

    def _requeue_front(self, req):
        (self.long_queue if req.is_long else self.short_queue).appendleft(req)


# ===========================================================================
# PecSched (§5) with ablation flags
# ===========================================================================
@dataclass
class LongState:
    req: Request
    rep_ids: List[int]
    phase: str = "prefill"              # prefill | decode
    #: placement order (monotonic per policy) — preemption tie-breaks on it
    #: so victim selection over an unordered set reproduces the historical
    #: first-max-in-`longs`-insertion-order scan exactly
    seq: int = 0
    paused: bool = False
    remaining: float = 0.0              # seconds of work left when paused
    decode_remaining: float = 0.0
    sp_mode: str = "ring"               # SP mode its prefill runs under


class PecSchedPolicy(BasePolicy):
    """Preemptive scheduling + prefill/decode disaggregation & colocation +
    fast SP. Ablations: preemption (/PE), disagg (/Dis), coloc (/CoL),
    fastsp (/FSP) — each flag False reproduces the paper's variant.

    ``coordination="adaptive"`` (the `pecsched/coord` policy name) replaces
    the static construction-time prefill/decode split with a
    `RoleCoordinator` that re-evaluates the split at dispatch time from
    observable pressure and flips replica roles at safe points (§5.2
    coordinated colocation/disaggregation).  Read in coordination terms,
    the existing ablations are "coordination off" in one direction each:
    /Dis pins every replica colocated (no decode pool, ever), /CoL pins the
    split fully disaggregated (no colocation with long decode), and the
    default static PecSched pins the pool size at construction."""
    name = "pecsched"

    def __init__(self, cc, em, *, preemption=True, disagg=True, coloc=True,
                 fastsp=True, coordination: str = "static",
                 coordinator_config: Optional[CoordinatorConfig] = None):
        if coordination not in ("static", "adaptive"):
            raise ValueError(f"bad coordination mode {coordination!r}")
        self.preemption = preemption
        self.disagg = disagg
        self.coloc = coloc
        self.fastsp = fastsp
        self.coordination = coordination
        super().__init__(cc, em, dedicated_decode=disagg)
        if not any(r.role == "short_decode" for r in self.replicas):
            self.disagg = False
        self.coordinator: Optional[RoleCoordinator] = None
        if coordination == "adaptive" and self.disagg:
            self.coordinator = RoleCoordinator(cc, em, coordinator_config)
        self.short_queue: deque = deque()
        self.short_queue_tokens = 0              # incremental backlog signal
        self.long_queue: deque = deque()
        self.longs: Dict[int, LongState] = {}    # rid -> state
        self._long_seq = 0                       # LongState.seq source
        # incrementally-maintained preemption views over `longs`: rebuilding
        # the victim list per dispatch pass was an O(live longs) scan on the
        # hottest path (saturated short pressure dispatches every batch)
        self._paused: Dict[int, LongState] = {}  # suspended longs
        self._victims: Dict[int, LongState] = {} # preemptable: unpaused and
        #                                          prefill (or decode w/o CoL)
        self.decode_queue: deque = deque()       # shorts waiting for decode pool
        suffix = []
        if not preemption:
            suffix.append("PE")
        if not disagg:
            suffix.append("Dis")
        if not coloc:
            suffix.append("CoL")
        if not fastsp:
            suffix.append("FSP")
        base = "pecsched/coord" if coordination == "adaptive" else "pecsched"
        self.name = base + ("/" + "".join(suffix) if suffix else "")

    # ------------------------------------------------------------------
    def on_arrival(self, t, req):
        self._record_arrival(req)
        if req.is_long:
            self.long_queue.append(req)
        else:
            self.short_queue.append(req)
            self.short_queue_tokens += req.input_len

    def _batch_shorts(self, queue, max_tokens):
        batch = super()._batch_shorts(queue, max_tokens)
        if queue is self.short_queue:
            self.short_queue_tokens -= sum(r.input_len for r in batch)
        return batch

    def _decode_pool_active(self) -> bool:
        """Is there a decode replica that accepts NEW migrations?  Draining
        replicas finish their in-flight load but take nothing new; with the
        pool empty (coordinator borrowed everything), completions decode in
        place — the colocated path — so nothing waits on an empty pool."""
        return bool(self.index.active_pool)

    # ------------------------------------------------------------------
    def on_done(self, t, work):
        if work.kind == "short_prefill":
            self._release(work)
            if self.disagg and self._decode_pool_active():
                # KV streams to the decode replica DURING prefill (overlapped,
                # §5.2) — only a negligible tail remains at completion.
                # first_token is deliberately NOT stamped here: a migrating
                # short serves its first token only when decode work lands on
                # the pool (_drain_decode_queue), which is also the moment
                # real engines admit the parked KV and can emit — so TTFT
                # means the same thing on SimBackend and EngineBackend.
                for r in work.requests:
                    r.phase = Phase.MIGRATING
                    self.decode_queue.append(r)
                self._drain_decode_queue(t)
            else:
                # /Dis: decode continues on the same replicas (holds them) —
                # the first token really is served at prefill completion
                tokens = sum(r.input_len for r in work.requests)
                max_out = max(r.output_len for r in work.requests)
                d = self.em.decode_time(
                    max_out, tokens // len(work.requests),
                    batch=len(work.requests))
                for r in work.requests:
                    r.first_token = t
                    r.phase = Phase.DECODE
                self._start(t, "short_decode_inplace", work.requests,
                            work.replica_ids, d)
        elif work.kind == "short_decode_inplace":
            self._release(work)
            self._finish_requests(t, work.requests)
        elif work.kind == "short_decode":
            n = len(work.requests)
            for rid in work.replica_ids:
                rep = self.replicas[rid]
                rep.decode_load = rep._decode_load - n
                rep.add_busy(work.duration)
            self._finish_requests(t, work.requests)
            self._drain_decode_queue(t)
        elif work.kind == "short_prefill_coloc":
            self._release(work)
            if self.disagg and self._decode_pool_active():
                # migrating: first_token stamps when decode lands (see above)
                for r in work.requests:
                    r.phase = Phase.MIGRATING
                    self.decode_queue.append(r)
                self._drain_decode_queue(t)
            else:
                for r in work.requests:
                    r.first_token = t
                self.backend.decode_inline(work)
                self._finish_requests(t, work.requests, decode_inline_at=t)
        elif work.kind == "long_prefill":
            self._release(work)
            req = work.requests[0]
            st = self.longs[req.rid]
            req.first_token = t
            st.phase = "decode"
            if self.coloc:              # long decode not preemptable w/ CoL
                self._victims.pop(req.rid, None)
            for rid in st.rep_ids:
                self.replicas[rid].long_phase = "decode"
            d = self.em.decode_time(req.output_len, req.input_len, batch=1) \
                / max(len(st.rep_ids), 1)
            req.phase = Phase.DECODE
            st.decode_remaining = d
            self._start(t, "long_decode", [req], st.rep_ids, d)
        elif work.kind == "long_decode":
            self._release(work)
            req = work.requests[0]
            st = self.longs.pop(req.rid)
            self._victims.pop(req.rid, None)
            for rid in st.rep_ids:
                rep = self.replicas[rid]
                rep.long_rid = None
                rep.long_phase = None
            req.phase = Phase.DONE
            req.finish = t
            self._complete_request(req)
        else:
            raise ValueError(work.kind)

    def _finish_requests(self, t, reqs, decode_inline_at=None):
        for r in reqs:
            if decode_inline_at is not None:
                # /Dis colocated path: decode modeled inline
                t = decode_inline_at + self.em.decode_time(
                    r.output_len, r.input_len, batch=8)
            r.phase = Phase.DONE
            r.finish = t
            self._complete_request(r)

    # ------------------------------------------------------------------
    def _drain_decode_queue(self, t):
        dq = self.decode_queue
        if not dq:
            return
        pool = self.index.active_pool
        if not pool:
            return
        reps = self.replicas
        mdc = self.cc.max_decode_concurrency
        while dq:
            # least-loaded active replica, rid tie-break — the same pick the
            # historical rid-sorted list + stable load sort made, without
            # rebuilding and re-sorting a list per emitted batch
            best = None
            for i in pool:
                k = (reps[i]._decode_load, i)
                if best is None or k < best:
                    best = k
            rep = reps[best[1]]
            cap = mdc - best[0]
            if cap <= 0:
                return
            batch = []
            while dq and len(batch) < cap:
                batch.append(dq.popleft())
            max_out = max(r.output_len for r in batch)
            avg_in = sum(r.input_len for r in batch) // len(batch)
            d = self.em.decode_time(max_out, avg_in, batch=len(batch))
            for r in batch:
                # first token serves NOW: the migration has landed and the
                # decode batch starts — the backend-consistent TTFT stamp
                # for the migrating-short path
                if r.first_token is None:
                    r.first_token = t
                r.phase = Phase.DECODE
            rep.decode_load += len(batch)
            w = Work(wid=next(self._wid), kind="short_decode",
                     replica_ids=[rep.rid], requests=batch, start=t, duration=d)
            self._emit(w)

    # ------------------------------------------------------------------
    def _start_short_prefill(self, t, batch, rep_ids, *, colocated=False):
        tokens = sum(r.input_len for r in batch)
        # §5.2: tokens balanced across the replicas of the group
        d = self.em.prefill_time(tokens // max(len(rep_ids), 1), 1,
                                 sp_mode="local")
        for r in batch:
            r.phase = Phase.PREFILL
            if r.prefill_start is None:
                r.prefill_start = t
        kind = "short_prefill_coloc" if colocated else "short_prefill"
        self._start(t, kind, batch, rep_ids, d, colocated=colocated)

    def _price_long_prefill(self, head, R, sp, rep_ids) -> float:
        """Cost of `head`'s gang prefill on `rep_ids`.  Hook: the cache-aware
        subclass discounts resident prefixes here; the base price is the
        historical expression, byte-identical (same memo key)."""
        return self.em.prefill_time(head.input_len, R, sp_mode=sp)

    def _order_long_candidates(self, t, head, cands):
        """Hook: claim-order preference over the busy/end-sorted candidate
        list.  The cache-aware subclass steers a long's claim toward the
        replica holding its session's resident context; the base keeps the
        historical order untouched."""
        return cands

    def _pause_long(self, t, st: LongState):
        """Suspend a running long prefill (or decode under /CoL)."""
        if self.record_decisions:
            self.decision_log.append(("preempt", st.req.rid, st.phase))
        for rid in st.rep_ids:
            rep = self.replicas[rid]
            w = rep.work
            if w is not None and not w.canceled:
                self.backend.cancel(w)
                elapsed = t - w.start
                if w.kind == "long_prefill":
                    st.remaining = max(w.duration - elapsed, 0.0)
                else:
                    st.decode_remaining = max(w.duration - elapsed, 0.0)
                self._release(w, busy=elapsed)
        st.paused = True
        self._victims.pop(st.req.rid, None)
        self._paused[st.req.rid] = st
        st.req.phase = Phase.PAUSED
        st.req.n_preemptions += 1
        self.preemption_events += 1

    def _resume_long(self, t, st: LongState):
        st.paused = False
        del self._paused[st.req.rid]
        if st.phase == "prefill" or not self.coloc:
            self._victims[st.req.rid] = st
        if st.phase == "prefill":
            st.req.phase = Phase.PREFILL
            self._start(t, "long_prefill", [st.req], st.rep_ids, st.remaining,
                        sp_mode=st.sp_mode)
        else:
            st.req.phase = Phase.DECODE
            self._start(t, "long_decode", [st.req], st.rep_ids,
                        st.decode_remaining)

    # ------------------------------------------------------------------
    def needs_dispatch(self, t):
        if self.short_queue or self.long_queue or self._paused:
            return True
        if self.decode_queue and not self.index.active_pool:
            return True                 # stranded migrants (churn fallback)
        if self.coordinator is not None:
            # with empty queues the coordinator can only act on borrowed
            # replicas (return them) or draining ones (complete the drain);
            # borrowing itself requires a short backlog, covered above
            idx = self.index
            if idx.by_role["prefill"]:
                return True
            if idx.draining_pool:
                return True
        return False

    def dispatch(self, t):
        if self.coordinator is not None:
            # re-evaluate the prefill/decode split BEFORE placement, so a
            # replica borrowed this pass serves this pass's backlog
            self.coordinator.step(t, self)
        # gate each sub-pass on the state it drains: most passes have work
        # for only one of them, and a skipped call costs nothing
        if self.decode_queue and not self.index.active_pool:
            self._decode_stranded_inplace(t)
        if self.long_queue:
            self._dispatch_longs(t)
        if self.short_queue:
            self._dispatch_shorts(t)
        if self._paused:
            self._resume_paused(t)

    def _dispatch_longs(self, t):
        idx = self.index
        reps = self.replicas
        em = self.em
        while self.long_queue:
            head = self.long_queue[0]
            R = min(em.replicas_needed(head.input_len),
                    len(idx.by_role["general"]))
            claim_set = idx.claims.get(head.rid, ())
            if len(claim_set) >= R:
                # fast wait-path: the claim is complete, so most passes just
                # poll for the claimed work draining — an order-insensitive
                # walk of the raw set, no sorted rebuild per pass
                for i in claim_set:
                    if reps[i]._work is not None:
                        return           # wait for claimed work to drain
            # Claim R replicas up-front: idle ones, then ones finishing their
            # current short work (§5: a long "only waits for the ongoing short
            # requests to complete their prefill phases"). Claimed replicas
            # admit no NEW work; the long starts once all R drain.
            claimed = [reps[i] for i in sorted(claim_set)]
            if len(claimed) < R:
                # free_general in ascending rid, then a stable busy/end sort:
                # identical order to the historical full-list scan + sort
                cands = [reps[i] for i in sorted(idx.free_general)]
                cands.sort(key=lambda r: (r._work is not None,
                                          r._work.end if r._work else 0.0))
                cands = self._order_long_candidates(t, head, cands)
                for r in cands:
                    if len(claimed) >= R:
                        break
                    r.claimed_by = head.rid
                    claimed.append(r)
            if len(claimed) < R:
                return                   # wait for claimed work to drain
            for r in claimed:
                if r._work is not None:
                    return               # wait for claimed work to drain
            self.long_queue.popleft()
            for r in claimed:
                r.claimed_by = None
                r.long_rid = head.rid
                r.long_phase = "prefill"
            sp = "fastsp" if self.fastsp else "ring"
            rep_ids = [r.rid for r in claimed]
            d = self._price_long_prefill(head, R, sp, rep_ids)
            head.phase = Phase.PREFILL
            head.prefill_start = t
            self._long_seq += 1
            st = LongState(req=head, rep_ids=rep_ids,
                           sp_mode=sp, seq=self._long_seq)
            self.longs[head.rid] = st
            self._victims[head.rid] = st
            self._start(t, "long_prefill", [head], st.rep_ids, d, sp_mode=sp)

    def _dispatch_shorts(self, t):
        idx = self.index
        while self.short_queue:
            placed = False
            # 1) idle prefill-capable replica (general or borrowed from the
            # decode pool; not claimed, not in a long group) — min rid is
            # the first hit of the historical rid-order scan
            if idx.idle_prefill:
                rid0 = min(idx.idle_prefill)
                batch = self._batch_shorts(self.short_queue,
                                           self.cc.max_batch_tokens)
                self._start_short_prefill(t, batch, [rid0])
                placed = True
            # 2) colocate with long decode (§5.2) — `coloc_room` is the
            # index-maintained headroom set (long decode, under the coloc
            # cap), so the saturated no-candidate pass is an O(1) check
            elif self.coloc and idx.coloc_room:
                cands = [self.replicas[i] for i in sorted(idx.coloc_room)]
                cap = sum(self.cc.max_coloc_tokens - r.coloc_tokens
                          for r in cands)
                batch = self._batch_shorts(self.short_queue, cap)
                self._start_short_prefill(t, batch,
                                          [r.rid for r in cands],
                                          colocated=True)
                placed = True
            if not placed and self.preemption:
                # 3) preempt a running long prefill (decode too under /CoL).
                # §5: the long resumes as soon as the preempting short
                # prefills complete — a later short wave must preempt AGAIN
                # (each suspension counted, per Table 3/6 semantics). This
                # also bounds long starvation under sustained short pressure.
                # `_victims` is the incrementally-maintained eligible set;
                # (gang size, -seq) picks the first-placed largest gang —
                # the same victim the historical `longs`-order scan chose.
                if self._victims:
                    st = max(self._victims.values(),
                             key=lambda s: (len(s.rep_ids), -s.seq))
                    self._pause_long(t, st)
                    cap = self.cc.max_batch_tokens * len(st.rep_ids)
                    batch = self._batch_shorts(self.short_queue, cap)
                    self._start_short_prefill(t, batch, st.rep_ids)
                    placed = True
            if not placed:
                return

    def _resume_paused(self, t):
        # a paused long resumes the moment its replicas are free — new shorts
        # must go through a fresh preemption (counted) to take them back.
        if not self._paused:
            return
        # seq order == `longs` insertion order restricted to the paused
        # subset, so the resume (and decision-log) order is unchanged;
        # paused gangs are disjoint, so resuming one never blocks another
        reps = self.replicas
        for st in sorted(self._paused.values(), key=lambda s: s.seq):
            for r in st.rep_ids:
                if reps[r]._work is not None:
                    break
            else:
                self._resume_long(t, st)

    def finalize(self, t):
        for r in self.long_queue:
            if r.prefill_start is None:
                r.phase = Phase.STARVED

    # ------------------------------------------------------------------
    # Elastic-fleet hooks (core/fleet.py): vacate a reclaimed replica.
    # ------------------------------------------------------------------
    def _requeue_front(self, req):
        if req.is_long:
            self.long_queue.appendleft(req)
        else:
            self.short_queue.appendleft(req)
            self.short_queue_tokens += req.input_len

    def on_reclaim(self, t, rep):
        # pending long claim: release it — the long re-claims survivors
        if rep.claimed_by is not None:
            rep.claimed_by = None
        if rep.long_rid is not None:
            # member of a long gang (running or paused): cancel the gang and
            # reform it on the survivors, or restart the long from scratch
            self._evacuate_long(t, self.longs[rep.long_rid], rep)
        elif rep.work is not None and not rep.work.canceled:
            # short prefill / in-place decode: restart from the queue front
            w = rep.work
            self.backend.cancel(w)
            self._release(w, busy=max(t - w.start, 0.0))
            self._restart_requests(t, w.requests)
        if rep._decode_load > 0:
            self._evacuate_decode(t, rep)
        # colocated shorts riding on this replica's long decode (if any)
        # complete on the colocation group's survivors; their release path
        # only touches coloc_tokens, which stays addressable after retire.

    def _evacuate_long(self, t, st: LongState, rep: ReplicaState):
        """Drop `rep` from its long gang.  Survivors resume from migrated
        KV (the reclaimed shard's blocks cross the interconnect at cost-
        model prices); a gang with no survivors restarts the request from
        the long queue.  Deliberately NOT a scheduler preemption: forced
        churn is counted in `reclaims`/`restarted_requests`, never in the
        paper's Table 3/6 suspension counts."""
        req = st.req
        if not st.paused:
            # suspend exactly like _pause_long, minus the preemption count
            for rid in st.rep_ids:
                r2 = self.replicas[rid]
                w = r2.work
                if w is not None and not w.canceled:
                    self.backend.cancel(w)
                    elapsed = max(t - w.start, 0.0)
                    if w.kind == "long_prefill":
                        st.remaining = max(w.duration - elapsed, 0.0)
                    else:
                        st.decode_remaining = max(w.duration - elapsed, 0.0)
                    self._release(w, busy=elapsed)
        rep.long_rid = None
        rep.long_phase = None
        survivors = [i for i in st.rep_ids if i != rep.rid]
        R_old = len(st.rep_ids)
        if not survivors:
            self._restart_long(t, st)
            return
        if st.phase == "prefill":
            # progress so far -> tokens whose KV lives on the gang; the
            # reclaimed replica's 1/R_old shard migrates to the survivors
            full = self.em.prefill_time(req.input_len, R_old,
                                        sp_mode=st.sp_mode)
            frac = 1.0 - min(max(st.remaining / full, 0.0), 1.0) \
                if full > 0 else 0.0
            shard = int(frac * req.input_len) // R_old
            st.remaining = st.remaining * R_old / len(survivors) \
                + self.em.migration_time(shard)
        else:
            # decode phase: the full prompt's KV is live across the gang
            shard = req.input_len // R_old
            st.decode_remaining = st.decode_remaining * R_old \
                / len(survivors) + self.em.migration_time(shard)
        if shard > 0:
            self.evacuated_blocks += self._kv_blocks(shard)
        st.rep_ids = survivors
        if not st.paused:
            st.paused = True
            self._victims.pop(req.rid, None)
            self._paused[req.rid] = st
            req.phase = Phase.PAUSED
        # survivors are free now; the post-reclaim dispatch pass resumes
        # the reformed gang through the ordinary _resume_paused path

    def _restart_long(self, t, st: LongState):
        req = st.req
        self.longs.pop(req.rid, None)
        self._victims.pop(req.rid, None)
        self._paused.pop(req.rid, None)
        for i in st.rep_ids:
            r = self.replicas[i]
            if r.long_rid == req.rid:
                r.long_rid = None
                r.long_phase = None
        req.phase = Phase.QUEUED
        req.prefill_start = None
        req.first_token = None
        self.restarted_requests += 1
        self.long_queue.appendleft(req)

    def _evacuate_decode(self, t, rep: ReplicaState):
        """Revoke in-flight short-decode batches on a reclaimed pool
        replica: their KV parks and re-admits on a surviving pool replica
        (counted in `evacuated_blocks`), and the batches re-queue at the
        migration queue's front.  Decode works never set `rep.work`, so
        this walks the pending-event table — reclaims are rare."""
        pending = [e[1] for e in self.sim._work_entries.values()
                   if e[1] is not None and not e[2]
                   and getattr(e[1], "kind", None) == "short_decode"
                   and rep.rid in e[1].replica_ids]
        for w in pending:
            self.backend.cancel(w)
            rep.decode_load = max(0, rep._decode_load - len(w.requests))
            rep.add_busy(max(t - w.start, 0.0))
            for r in reversed(w.requests):
                self.evacuated_blocks += self._kv_blocks(r.input_len)
                r.phase = Phase.MIGRATING
                self.restarted_requests += 1
                self.decode_queue.appendleft(r)
        rep.decode_load = 0

    def _decode_stranded_inplace(self, t):
        """Churn fallback: a reclamation wave killed the LAST active decode
        replica while migrated shorts sat in `decode_queue` — there is no
        pool to land on and (unlike the prefill-completion path, which
        falls back to in-place decode the moment the pool is inactive) no
        completion event will ever pick them up.  Decode them in place on
        idle generals, the /Dis colocated semantics.  Unreachable in
        zero-churn runs: the queue is only non-empty when the pool is
        saturated, and a saturated replica is never drained enough for the
        coordinator to flip it away."""
        dq = self.decode_queue
        idx = self.index
        mdc = self.cc.max_decode_concurrency
        while dq and idx.idle_general:
            rep = self.replicas[min(idx.idle_general)]
            batch = [dq.popleft() for _ in range(min(len(dq), mdc))]
            max_out = max(r.output_len for r in batch)
            avg_in = sum(r.input_len for r in batch) // len(batch)
            d = self.em.decode_time(max_out, avg_in, batch=len(batch))
            for r in batch:
                if r.first_token is None:
                    r.first_token = t
                r.phase = Phase.DECODE
            self._start(t, "short_decode_inplace", batch, [rep.rid], d)


# ===========================================================================
# Prefix-cache-aware PecSched (beyond-paper: vLLM-v1 prefix caching as a
# cluster-level routing signal — the ROADMAP's "cache-affinity at
# millions-of-users scale" item).
# ===========================================================================
class PecSchedCachePolicy(PecSchedPolicy):
    """PecSched + block-granular prefix-cache affinity.

    Two additions over the base policy, both driven by a `PrefixResidency`
    map (the analytic twin of the engines' block-hash index, sized from the
    ClusterConfig's paged-KV grain):

    * **Routing** — among idle prefill-capable replicas, a short batch goes
      to the replica holding the most whole-block resident tokens of the
      head request's prefix group (session context for `chat_multiturn`,
      system prompt for `shared_prefix`); load balance breaks ties and
      takes over when nothing is resident.
    * **Pricing** — a placed request's resident prefix skips its own
      prefill compute: the batch duration is discounted per request via
      `ExecutionModel.prefill_time(..., cached_tokens=...)`, and long gang
      prefills discount against the gang's best resident copy.

    Decisions read only policy-side state (the residency map), so the sim
    and engine backends make identical choices — the cross-backend parity
    contract holds for this policy unmodified.

    ``greedy=True`` is the affinity-vs-balance ablation
    (`pecsched/cache_greedy`): the router follows residency wherever it
    lives, holding the queue for a BUSY replica that has the head's prefix
    rather than balancing onto an idle one.  Under bursty arrivals this
    must lose on p99 short queueing delay — the claims suite pins that
    tension as a falsifiable cell.
    """

    name = "pecsched/cache"

    def __init__(self, cc, em, *, greedy: bool = False, **kw):
        super().__init__(cc, em, **kw)
        self.greedy = greedy
        self.residency = PrefixResidency(
            len(self.replicas), block_size=cc.kv_block_size,
            max_groups=cc.prefix_cache_groups)
        # expose on the index so examples/diagnostics find it where the
        # advisory default lives (ClusterIndex.prefix_residency)
        self.index.prefix_residency = self.residency
        #: dispatch-time prefix-cache counters; metrics.summarize reads
        #: them into prefix_hit_rate / prefill_flops_saved
        self.prefix_stats = {"lookups": 0, "hits": 0, "hit_tokens": 0,
                             "flops_saved": 0.0}
        self.name = "pecsched/cache_greedy" if greedy else "pecsched/cache"

    # ---- affinity signal ----------------------------------------------
    def _affinity_candidates(self) -> List[int]:
        """Prefill-capable replicas the greedy router may wait for: any
        role in PREFILL_CAPABLE that is not claimed and not in a long
        gang — busy-with-short is exactly what greedy waits out."""
        out = []
        reps = self.replicas
        for role in PREFILL_CAPABLE:
            for rid in self.index.by_role[role]:
                r = reps[rid]
                if r._claimed_by is None and r._long_rid is None:
                    out.append(rid)
        return out

    def _lookup(self, rid: int, req: Request) -> int:
        """Counted residency probe for one placed request on `rid`."""
        if req.prefix_group is None or req.prefix_len <= 0:
            return 0
        stats = self.prefix_stats
        stats["lookups"] += 1
        c = self.residency.cached_tokens(rid, req.prefix_group,
                                         req.prefix_len)
        if c > 0:
            stats["hits"] += 1
            stats["hit_tokens"] += c
            stats["flops_saved"] += self.em.prefill_flops(c)
        return c

    # ---- pricing ------------------------------------------------------
    def _start_short_prefill(self, t, batch, rep_ids, *, colocated=False):
        if colocated or len(rep_ids) != 1:
            # coloc / preemption-gang paths split tokens across replicas;
            # residency is per replica, so they keep the base price (and
            # leave no resident prefix behind — KV migrates off)
            super()._start_short_prefill(t, batch, rep_ids,
                                         colocated=colocated)
            return
        rid = rep_ids[0]
        em = self.em
        res = self.residency
        tokens = 0
        d = 0.0
        for r in batch:
            tokens += r.input_len
            c = self._lookup(rid, r)
            if c > 0:
                # per-request saving: this request's full-length price
                # minus its suffix-only price (both memoized)
                d -= (em.prefill_time(r.input_len, 1, sp_mode="local")
                      - em.prefill_time(r.input_len, 1, sp_mode="local",
                                        cached_tokens=c))
            # record AFTER the lookup: a later request in this batch can
            # hit what an earlier one just wrote (the engines' per-request
            # admit order does exactly this)
            res.record(rid, r.prefix_group, r.prefix_write)
        d += em.prefill_time(tokens, 1, sp_mode="local")
        d = max(d, em.prefill_time(tokens, 1, sp_mode="local") * 1e-3)
        for r in batch:
            r.phase = Phase.PREFILL
            if r.prefill_start is None:
                r.prefill_start = t
        self._start(t, "short_prefill", batch, rep_ids, d)

    def _price_long_prefill(self, head, R, sp, rep_ids) -> float:
        # the gang's best resident copy discounts the prefill; the grown
        # context lands on the gang's home replica (rep_ids[0])
        c = 0
        if head.prefix_group is not None and head.prefix_len > 0:
            stats = self.prefix_stats
            stats["lookups"] += 1
            c = max(self.residency.cached_tokens(rid, head.prefix_group,
                                                 head.prefix_len)
                    for rid in rep_ids)
            if c > 0:
                stats["hits"] += 1
                stats["hit_tokens"] += c
                stats["flops_saved"] += self.em.prefill_flops(c)
        self.residency.record(rep_ids[0], head.prefix_group,
                              head.prefix_write)
        return self.em.prefill_time(head.input_len, R, sp_mode=sp,
                                    cached_tokens=c)

    # ---- routing ------------------------------------------------------
    def _peek_batch(self, queue, max_tokens) -> List[Request]:
        """The batch `_batch_shorts` WOULD pop, without popping — same
        consecutive-heads walk, same single-oversize fallback."""
        out, tok = [], 0
        for r in queue:
            if tok + r.input_len > max_tokens:
                break
            out.append(r)
            tok += r.input_len
        if not out and queue:
            out.append(queue[0])
        return out

    def _batch_affinity(self, rid: int, batch) -> int:
        """Resident whole-block tokens this batch could reuse on `rid`."""
        res = self.residency
        return sum(res.cached_tokens(rid, r.prefix_group, r.prefix_len)
                   for r in batch
                   if r.prefix_group is not None and r.prefix_len > 0)

    def _order_long_candidates(self, t, head, cands):
        # steer the long's claim toward its session's resident context —
        # but only when the reuse pays: a busy replica's residual drain
        # time is weighed against the prefill compute the resident prefix
        # would skip.  With nothing resident anywhere the keys collapse to
        # (wait, busy, end) == the base busy/end order exactly.
        if head.prefix_group is None or head.prefix_len <= 0:
            return cands
        res = self.residency
        em = self.em
        full = em.prefill_time(head.input_len, 1, sp_mode="local")

        def key(r):
            c = res.cached_tokens(r.rid, head.prefix_group, head.prefix_len)
            saved = 0.0
            if c > 0:
                saved = full - em.prefill_time(head.input_len, 1,
                                               sp_mode="local",
                                               cached_tokens=c)
            wait = max(0.0, r._work.end - t) if r._work is not None else 0.0
            return (wait - saved, r._work is not None,
                    r._work.end if r._work else 0.0)

        return sorted(cands, key=key)

    def _dispatch_shorts(self, t):
        idx = self.index
        while self.short_queue:
            placed = False
            if idx.idle_prefill:
                peek = self._peek_batch(self.short_queue,
                                        self.cc.max_batch_tokens)
                # affinity score = resident tokens the WHOLE batch reuses
                # (head-only scoring lets mixed-session batches drag every
                # non-head session's residency to a new replica each turn)
                rid0, best = None, 0
                for rid in sorted(idx.idle_prefill):
                    a = self._batch_affinity(rid, peek)
                    if a > best:
                        rid0, best = rid, a
                if self.greedy:
                    bb_rid, bb = None, best
                    for rid in self._affinity_candidates():
                        if rid in idx.idle_prefill:
                            continue
                        a = self._batch_affinity(rid, peek)
                        if a > bb:
                            bb_rid, bb = rid, a
                    if bb_rid is not None:
                        # cache-greedy: the best copy lives on a busy
                        # replica — hold the whole queue for it (this HOL
                        # wait is the ablation's p99 tax under burst)
                        return
                if rid0 is None:
                    rid0 = min(idx.idle_prefill)   # balance: base pick
                batch = self._batch_shorts(self.short_queue,
                                           self.cc.max_batch_tokens)
                self._start_short_prefill(t, batch, [rid0])
                placed = True
            elif self.coloc and idx.coloc_room:
                cands = [self.replicas[i] for i in sorted(idx.coloc_room)]
                cap = sum(self.cc.max_coloc_tokens - r.coloc_tokens
                          for r in cands)
                batch = self._batch_shorts(self.short_queue, cap)
                self._start_short_prefill(t, batch,
                                          [r.rid for r in cands],
                                          colocated=True)
                placed = True
            if not placed and self.preemption:
                if self._victims:
                    st = max(self._victims.values(),
                             key=lambda s: (len(s.rep_ids), -s.seq))
                    self._pause_long(t, st)
                    cap = self.cc.max_batch_tokens * len(st.rep_ids)
                    batch = self._batch_shorts(self.short_queue, cap)
                    self._start_short_prefill(t, batch, st.rep_ids)
                    placed = True
            if not placed:
                return


# ===========================================================================
# SLO-aware plan-ahead PecSched (beyond-paper: TetriSched-style planning).
# Same execution machinery as PecSched; what changes is WHEN work runs —
# the short backlog is slack-ordered against per-tier TTFT contracts and
# placed into a discretized future window before any replica is touched.
# ===========================================================================
class PecSchedSLOPolicy(PecSchedPolicy):
    """PecSched + plan-ahead scheduling against per-request SLO tiers.

    Three behaviours layer on the base policy, all decided policy-side (so
    both backends replay identical decision logs):

    * **slack ordering** — `_replan` re-sorts the short backlog earliest-
      deadline-first (deadline = arrival + TTFT target; untiered requests
      sort last by arrival, so untiered traces degrade exactly to base
      FIFO order).
    * **plan-ahead window** — the backlog is placed into a discretized
      future window (`plan_slots` slots, each one full-batch prefill wide
      at cost-model prices).  The placement is fluid: aggregate prefill
      rate = number of prefill-capable replicas, planned start = queued
      work ahead / rate.  A batch-tier request whose planned *start* falls
      beyond the window means every slot is already spoken for — the
      cluster is provably oversubscribed — and it is shed (``Request.shed``,
      terminal STARVED, logged as ``("shed", rid, t)``) instead of rotting
      in the queue and dragging attainment for work that could still meet
      its contract.
    * **retraction** — when a contracted request's planned completion
      busts its deadline, the plan is *urgent*: `_dispatch_longs` retracts
      planned-but-unstarted long claims (claims hold replicas idle while
      the gang drains) and admits no new longs until the burst clears,
      logged as ``("retract", long_rid, t)``.  Started longs are never
      retracted — preemption (inherited) already handles those.
    """
    name = "pecsched/slo"

    def __init__(self, cc, em, *, plan_slots: int = 8,
                 urgent_slack_slots: float = 1.0, **kw):
        super().__init__(cc, em, **kw)
        self.name = "pecsched/slo"
        #: slot width = one full-batch local prefill at cost-model prices —
        #: derived, so one config spans the 32-GPU sim cluster and the
        #: CPU-engine cluster without retuning
        self.slot_width = em.prefill_time(cc.max_batch_tokens, 1,
                                          sp_mode="local")
        self.plan_slots = plan_slots
        self.urgent_slack = urgent_slack_slots * self.slot_width
        self._est: Dict[int, float] = {}      # rid -> prefill estimate (s)
        self._plan_dirty = True
        self._plan_t = -math.inf
        self._urgent = False
        self.shed_events = 0
        self.plan_retractions = 0

    # ------------------------------------------------------------------
    def on_arrival(self, t, req):
        super().on_arrival(t, req)
        self._plan_dirty = True

    @staticmethod
    def _deadline(r: Request) -> float:
        return (r.arrival + r.ttft_target
                if r.ttft_target is not None else math.inf)

    def _service_est(self, r: Request) -> float:
        e = self._est.get(r.rid)
        if e is None:
            e = self._est[r.rid] = self.em.prefill_time(r.input_len, 1,
                                                        sp_mode="local")
        return e

    def _replan(self, t):
        """Rebuild the plan: slack-order the backlog, place it into the
        window, shed what provably cannot fit, flag urgency.  Gated on new
        arrivals (`_plan_dirty`) or plan age ≥ one slot — between those,
        the previous plan's order still holds."""
        if not (self._plan_dirty or t - self._plan_t >= self.slot_width):
            return
        self._plan_dirty = False
        self._plan_t = t
        self._urgent = False
        if not self.short_queue:
            return
        idx = self.index
        rate = max(len(idx.by_role["general"]) + len(idx.by_role["prefill"]),
                   1)
        window = self.plan_slots * self.slot_width
        keep: deque = deque()
        shed: List[Request] = []
        offset = 0.0                    # queued prefill seconds ahead
        for r in sorted(self.short_queue,
                        key=lambda r: (self._deadline(r), r.arrival, r.rid)):
            need = self._service_est(r)
            start = offset / rate       # fluid start within the window
            if start > window and r.slo == "batch":
                shed.append(r)
                continue
            deadline = self._deadline(r)
            if (deadline < math.inf
                    and t + start + need + self.urgent_slack > deadline):
                self._urgent = True
            offset += need
            keep.append(r)
        self.short_queue = keep
        self.short_queue_tokens = sum(r.input_len for r in keep)
        for r in shed:
            r.shed = True
            r.phase = Phase.STARVED
            self.shed_events += 1
            self._est.pop(r.rid, None)
            if self.record_decisions:
                self.decision_log.append(("shed", r.rid, t))
            self._complete_request(r)

    # ------------------------------------------------------------------
    def dispatch(self, t):
        if not self.short_queue:
            # urgency exists only on behalf of queued short work; without a
            # replan tick this would otherwise block longs forever
            self._urgent = False
        self._replan(t)
        super().dispatch(t)

    def _dispatch_longs(self, t):
        if self._urgent:
            # A contracted short misses its TTFT deadline under the current
            # plan: claimed replicas sit idle waiting for a long gang to
            # assemble — retract those placements and stop admitting longs
            # until the plan clears.  Claims belong to still-queued longs
            # only (popped at start), so nothing running is disturbed.
            idx = self.index
            for long_rid in sorted(idx.claims):
                for i in sorted(idx.claims.get(long_rid, ())):
                    self.replicas[i].claimed_by = None
                self.plan_retractions += 1
                if self.record_decisions:
                    self.decision_log.append(("retract", long_rid, t))
            return
        super()._dispatch_longs(t)

    def on_reclaim(self, t, rep):
        super().on_reclaim(t, rep)
        # restarted work re-entered the backlog and the prefill-capable
        # replica count changed — the plan must rebuild before it is read
        self._plan_dirty = True


# ===========================================================================
# Prediction-aware scheduling (beyond-paper: ELIS / Beyond-Prediction).
# Keys decisions off *predicted* output length — PecSched's observable-input
# counterpoint — with decode-lane preemption when the prediction was short.
# ===========================================================================
class PredSJFPolicy(BasePolicy):
    """Predicted-shortest-job-first with decode-lane preemption.

    Disaggregated like PecSched (prefill on general replicas, decode on the
    dedicated decode pool) but the *order* of the one ready queue is
    predicted total cost: ``prefill_time(input) + decode_time(predict(req))``
    priced by the calibrated ExecutionModel.  Longs are never preempted —
    the policy's whole bet is that prediction makes preemption unnecessary,
    which is exactly what the robustness sweep stresses as σ grows.

    Decode runs per-request on a pool lane with a *budgeted* round
    (`Work.token_budget` = predicted remaining tokens).  The execution world
    ends the round early at EOS; if instead the budget exhausts first the
    prediction was short, and the lane is preempted at that step boundary:
    the request's KV is parked (SimBackend prices the park+restore swap as
    two KV migrations; EngineBackend really parks the slot's blocks, see
    serving/backend.py), the budget escalates geometrically, and the request
    re-queues for a lane.  `tail_aware` (subclass) hedges by *budgeting*
    against a high quantile of the predictive distribution while keeping
    the point-estimate ordering — identical queueing decisions to
    `sjf_pred`, strictly fewer evictions at the same σ.

    Scheduler-visible information: `req.input_len` (observable) and
    `self.predictor` via `predict_output`.  `req.output_len` appears only in
    execution-side pricing (work durations / EOS detection), exactly where
    the analytic backend stands in for real engines.
    """

    name = "sjf_pred"

    #: geometric budget escalation after a decode-lane eviction (×2 keeps
    #: total evictions per request logarithmic in the underprediction ratio)
    ESCALATION = 2.0

    #: quantile the subclass hedges against; None = point estimate
    quantile: Optional[float] = None

    def __init__(self, cc, em, *, predictor_spec: str = "noisy0.6",
                 quantile: Optional[float] = None):
        super().__init__(cc, em, dedicated_decode=True,
                         predictor=make_predictor(predictor_spec))
        if quantile is not None:
            self.quantile = quantile
        base = "tail_aware" if self.quantile is not None else "sjf_pred"
        self.name = f"{base}:{predictor_spec}"
        self._reqs: Dict[int, Request] = {}
        self._pred: Dict[int, float] = {}       # rid -> predicted output
        self._ready: List[tuple] = []           # heap of (cost, rid)
        self._decode_ready: List[tuple] = []    # heap of (cost, rid)
        #: rid -> [tokens_done, round_budget, rounds] decode-lane state
        #: (a plain list: the lane hooks touch it per decode round)
        self._dstate: Dict[int, List] = {}
        self._n_general = sum(1 for r in self.replicas
                              if r.role in PREFILL_CAPABLE) or 1
        self._decode_pool = ([r for r in self.replicas
                              if r.role == "short_decode"]
                             or list(self.replicas))
        self._batch_eff = max(1, self.cc.decode_batch_eff)
        #: free decode-lane slots across the pool; kept exact by the round
        #: start/finish hooks so the dispatch gate is O(1).  _lane_free > 0
        #: iff some pool replica has decode_load < max_decode_concurrency —
        #: exactly _dispatch_decode's placement condition.
        self._lane_free = len(self._decode_pool) \
            * self.cc.max_decode_concurrency

    # ---- predicted cost (the decision side) ---------------------------
    def _lane_decode_time(self, output_len: float, context_len: int) -> float:
        """Per-lane decode pricing: continuous batching gives each stream
        its own completion time, but iterations share the replica with the
        other lanes — price at the model's effective batch width so lane
        throughput matches what batched decode pricing would grant."""
        return self.em.decode_time(output_len, context_len, self._batch_eff)

    def _total_cost(self, req: Request, pred_out: float) -> float:
        if req.is_long:
            R = max(1, min(self.em.replicas_needed(req.input_len),
                           self._n_general))
            t = self.em.prefill_time(req.input_len, R, sp_mode="ring")
        else:
            t = self.em.prefill_time(req.input_len, 1, sp_mode="local")
        return t + self._lane_decode_time(pred_out, req.input_len)

    def _push_decode(self, req: Request) -> None:
        st = self._dstate[req.rid]
        cost = self._lane_decode_time(st[1], req.input_len + st[0])
        heapq.heappush(self._decode_ready, (cost, req.rid))

    def _forget(self, rid: int) -> None:
        """Drop the per-request lookup state of a completed request — keeps
        the policy's own dicts flat over million-request replays."""
        self._reqs.pop(rid, None)
        self._pred.pop(rid, None)

    # ---- event hooks --------------------------------------------------
    def on_arrival(self, t, req):
        self._record_arrival(req)
        self._reqs[req.rid] = req
        # ordering always uses the point estimate (so `tail_aware` makes the
        # same queueing decisions as `sjf_pred`); the quantile hedges only
        # the decode-lane *budget*, where underprediction costs an eviction
        point = self.predict_output(req, None)
        self._pred[req.rid] = (self.predict_output(req, self.quantile)
                               if self.quantile is not None else point)
        heapq.heappush(self._ready, (self._total_cost(req, point), req.rid))

    def on_done(self, t, work):
        if work.kind == "pred_decode":
            self._decode_round_done(t, work)
            return
        self._release(work)
        if work.kind == "long_full":
            for r in work.requests:
                # monolithic long: reconstruct first-token time from the
                # memoized decode price (same expression _dispatch_prefill
                # used), as in FIFOPolicy.on_done
                r.first_token = t - self.em.decode_time(
                    r.output_len, r.input_len, batch=1)
                r.phase = Phase.DONE
                r.finish = t
                self._complete_request(r)
                self.predictor.observe(r, r.output_len)
                self._forget(r.rid)
            return
        # short_prefill done: hand off to a decode lane with the predicted
        # remaining budget.  first_token stamps when the first decode round
        # actually starts (_start_decode_round) — the KV has migrated to the
        # lane by then, so TTFT is backend-consistent here too.
        for r in work.requests:
            r.phase = Phase.MIGRATING
            self._dstate[r.rid] = [
                1,                                          # tokens done
                max(1, int(round(self._pred[r.rid])) - 1),  # round budget
                0,                                          # rounds run
            ]
            self._push_decode(r)

    # ---- decode lanes -------------------------------------------------
    def _start_decode_round(self, t, req: Request, rep: ReplicaState):
        st = self._dstate[req.rid]
        done, budget = st[0], st[1]
        ctx = req.input_len + done
        # execution side: the lane stops at EOS if truth runs out before the
        # scheduled budget — the analytic clock prices exactly the tokens
        # that actually run, mirroring what real engines would do
        run = min(budget, max(req.output_len - done, 0))
        d = self._lane_decode_time(run, ctx)
        if st[2] > 0:
            # re-admission after an eviction: park + restore of the
            # accumulated KV, priced as two migrations over the interconnect
            d += 2.0 * self.em.migration_time(ctx)
            if self.record_decisions:
                self.decision_log.append(("pred_readmit", req.rid, t))
        rep.decode_load += 1
        self._lane_free -= 1
        if req.first_token is None:     # first round: first token serves now
            req.first_token = t
        req.phase = Phase.DECODE
        w = Work(wid=next(self._wid), kind="pred_decode",
                 replica_ids=[rep.rid], requests=[req], start=t, duration=d,
                 token_budget=budget)
        self._emit(w)

    def _decode_round_done(self, t, work: Work):
        req = work.requests[0]
        rep = self.replicas[work.replica_ids[0]]
        rep.decode_load = max(0, rep._decode_load - 1)
        self._lane_free += 1
        rep.add_busy(work.duration)
        st = self._dstate[req.rid]
        if st[0] + st[1] >= req.output_len:
            # EOS fired inside this round — the one place the true length
            # becomes observable; feed it back to online predictors
            req.phase = Phase.DONE
            req.finish = t
            self._complete_request(req)
            self.predictor.observe(req, req.output_len)
            del self._dstate[req.rid]
            self._forget(req.rid)
            return
        # budget exhausted first: the prediction was short.  Decode-lane
        # preemption — evict at this step boundary, escalate, re-queue.
        budget = st[1]
        st[0] += budget
        st[2] += 1
        st[1] = max(budget + 1, int(budget * self.ESCALATION))
        self.decode_preemption_events += 1
        req.n_preemptions += 1
        if self.record_decisions:
            self.decision_log.append(("pred_evict", req.rid, t))
        self._push_decode(req)

    # ---- dispatch -----------------------------------------------------
    def needs_dispatch(self, t):
        # mirror of dispatch's two sub-pass gates: a pass with no idle
        # prefill replica and no free decode-lane slot provably places
        # nothing (see _dispatch_prefill / _dispatch_decode early-outs), so
        # under saturation most event batches skip the pass entirely
        return bool((self._ready and self.index.idle_prefill)
                    or (self._decode_ready and self._lane_free))

    def dispatch(self, t):
        # inline the sub-pass guards: under saturation most passes can act
        # on only one (or neither) of the two ready heaps
        if self._ready and self.index.idle_prefill:
            self._dispatch_prefill(t)
        if self._decode_ready and self._lane_free:
            self._dispatch_decode(t)

    def _dispatch_prefill(self, t):
        avail = self.index.idle_prefill     # live view, index-maintained
        ready = self._ready
        if not avail or not ready:
            return
        holdback = []
        reqs, em = self._reqs, self.em
        max_tok = self.cc.max_batch_tokens
        heappop = heapq.heappop
        while ready:
            if not avail:
                break
            cost, rid = heappop(ready)
            req = reqs[rid]
            if req.is_long:
                R = max(1, min(em.replicas_needed(req.input_len),
                               self._n_general))
                if len(avail) < R:
                    # not enough replicas for the gang *now*: skip the long
                    # without blocking cheaper work behind it (no HOL)
                    holdback.append((cost, rid))
                    continue
                # ascending rid == the historical rid scan + stable node sort
                rep_ids = sorted(avail)[:R]
                d = (em.prefill_time(req.input_len, R, sp_mode="ring")
                     + em.decode_time(req.output_len, req.input_len,
                                      batch=1))
                req.phase = Phase.PREFILL
                req.prefill_start = t
                self._start(t, "long_full", [req], rep_ids, d, sp_mode="ring")
                continue
            # shorts: pull the next-cheapest shorts into one prefill batch
            batch, tok = [req], req.input_len
            while ready and tok < max_tok:
                nxt = reqs[ready[0][1]]
                if nxt.is_long or tok + nxt.input_len > max_tok:
                    break
                heappop(ready)
                batch.append(nxt)
                tok += nxt.input_len
            for r in batch:
                r.phase = Phase.PREFILL
                r.prefill_start = t
            d = em.prefill_time(tok, 1, sp_mode="local")
            rid0 = min(avail)
            self._start(t, "short_prefill", batch, [rid0], d)
        for item in holdback:
            heapq.heappush(ready, item)

    def _dispatch_decode(self, t):
        cap = self.cc.max_decode_concurrency
        while self._decode_ready:
            # least-loaded lane with headroom, rid tie-break — the same
            # replica the historical filter + (load, rid) sort selected
            rep = best = None
            for r in self._decode_pool:
                load = r._decode_load
                if load < cap and (best is None or (load, r.rid) < best):
                    best = (load, r.rid)
                    rep = r
            if rep is None:
                return
            _, rid = heapq.heappop(self._decode_ready)
            self._start_decode_round(t, self._reqs[rid], rep)

    def finalize(self, t):
        for _, rid in self._ready:
            r = self._reqs[rid]
            if r.prefill_start is None:
                r.phase = Phase.STARVED

    # ---- elastic-fleet hooks ------------------------------------------
    def on_reclaim(self, t, rep):
        # prefill-side work: restart through the ready heap (re-predicted —
        # an online predictor may have learned since the first admission)
        w = rep.work
        if w is not None and not w.canceled:
            self.backend.cancel(w)
            self._release(w, busy=max(t - w.start, 0.0))
            for r in reversed(w.requests):
                r.phase = Phase.QUEUED
                r.prefill_start = None
                r.first_token = None
                self.restarted_requests += 1
                point = self.predict_output(r, None)
                heapq.heappush(self._ready,
                               (self._total_cost(r, point), r.rid))
        # in-flight decode-lane rounds on this replica: evict at the churn
        # boundary; st[2] += 1 makes the re-admission price the park+restore
        # migration — the resume-from-migrated-KV arm
        pending = [e[1] for e in self.sim._work_entries.values()
                   if e[1] is not None and not e[2]
                   and getattr(e[1], "kind", None) == "pred_decode"
                   and rep.rid in e[1].replica_ids]
        for w in pending:
            self.backend.cancel(w)
            req = w.requests[0]
            rep.decode_load = max(0, rep._decode_load - 1)
            self._lane_free += 1
            rep.add_busy(max(t - w.start, 0.0))
            st = self._dstate[req.rid]
            st[2] += 1
            self.evacuated_blocks += self._kv_blocks(req.input_len + st[0])
            req.phase = Phase.MIGRATING
            self._push_decode(req)
        # shrink the construction-time capacity snapshots
        if rep.role in PREFILL_CAPABLE:
            self._n_general = max(1, self._n_general - 1)
        if any(r.rid == rep.rid for r in self._decode_pool):
            self._lane_free -= self.cc.max_decode_concurrency \
                - rep._decode_load
            self._decode_pool = [r for r in self._decode_pool
                                 if r.rid != rep.rid]
        rep.decode_load = 0
        if not self._decode_pool:
            # last lane replica reclaimed: decode falls back onto whatever
            # survives rather than stranding the decode-ready heap
            self._decode_pool = [r for r in self.replicas if r.available]
            self._lane_free = sum(
                self.cc.max_decode_concurrency - r._decode_load
                for r in self._decode_pool)

    def on_join(self, t, rep):
        self._n_general += 1 if rep.role in PREFILL_CAPABLE else 0
        if rep.role == "short_decode":
            self._decode_pool.append(rep)
            self._lane_free += self.cc.max_decode_concurrency


class TailAwarePolicy(PredSJFPolicy):
    """Beyond-Prediction hedging: budget decode lanes against a high
    quantile of the predictive distribution.  Ordering stays on the point
    estimate (same queueing decisions as `sjf_pred`); only the part that
    matters under error changes — decode budgets overshoot instead of
    undershooting, trading reserved lane budget for decode-lane evictions."""

    name = "tail_aware"
    quantile = 0.9

    def __init__(self, cc, em, *, predictor_spec: str = "noisy0.6",
                 quantile: float = 0.9):
        super().__init__(cc, em, predictor_spec=predictor_spec,
                         quantile=quantile)


# every name make_policy accepts — the canonical policy matrix consumed by
# examples, launchers and the cross-backend test sweeps.  `sjf_pred` and
# `tail_aware` also accept a predictor suffix (``sjf_pred:oracle``,
# ``sjf_pred:noisy1.2``, ``tail_aware:history``, ``sjf_pred:adversarial``);
# the bare names default to the mid-σ classifier `noisy0.6`.
POLICY_NAMES = ("fifo", "fifo_noshort", "reservation", "priority", "pecsched",
                "pecsched/pe", "pecsched/dis", "pecsched/col", "pecsched/fsp",
                "pecsched/coord", "pecsched/cache", "pecsched/cache_greedy",
                "pecsched/slo", "sjf_pred", "tail_aware")


def make_policy(name: str, cc: ClusterConfig, em: ExecutionModel) -> BasePolicy:
    """Build a scheduling policy by its canonical name.

    ``name`` is any entry of :data:`POLICY_NAMES` (case-insensitive):
    the paper's baselines (``fifo``, ``fifo_noshort``, ``reservation``,
    ``priority``), ``pecsched`` and its single-mechanism ablations
    (``pecsched/pe`` no preemption, ``/dis`` no disaggregation, ``/col``
    no colocation, ``/fsp`` no fast-SP), and the extension policies
    (``/coord``, ``/cache``, ``/cache_greedy``, ``/slo``, ``sjf_pred``,
    ``tail_aware``).  Predictor-driven policies take an optional
    ``:<spec>`` suffix naming the output-length predictor —
    ``oracle``, ``noisy<sigma>``, ``history`` or ``adversarial`` (see
    ``repro_torch.core.predictor``); the bare names default to ``noisy0.6``.
    Human-readable descriptions of all of these live in
    ``docs/POLICIES.md`` (drift-gated against :data:`POLICY_NAMES`).

    The returned policy drives *either* backend — the simulator and the
    real-engine serving stack share this one decision brain.  Worked
    example (simulated smoke trace)::

        from repro_torch.configs import get_config
        from repro_torch.core import (ClusterConfig, ExecutionModel, Simulator,
                                make_policy)
        from repro_torch.core.scenarios import get_scenario

        cc = ClusterConfig(n_nodes=1, gpus_per_node=4, tp=1,
                           n_short_decode_replicas=1)
        em = ExecutionModel(get_config("mistral_7b"), cc.replica_spec())
        reqs = get_scenario("smoke_mini", n_requests=42, seed=0)
        policy = make_policy("sjf_pred:noisy1.2", cc, em)
        summary = Simulator(policy).run(reqs)
        print(summary["short_qd_pct"]["99"])   # p99 short queueing delay

    Raises ``ValueError`` on a name outside the registry.
    """
    name = name.lower()
    if name == "fifo":
        return FIFOPolicy(cc, em)
    if name == "fifo_noshort":  # Fig.2 "without long requests" arm
        return FIFOPolicy(cc, em, admit_long=False)
    if name == "reservation":
        return ReservationPolicy(cc, em)
    if name == "priority":
        return PriorityPolicy(cc, em)
    if name == "pecsched":
        return PecSchedPolicy(cc, em)
    if name == "pecsched/pe":
        return PecSchedPolicy(cc, em, preemption=False)
    if name == "pecsched/dis":
        return PecSchedPolicy(cc, em, disagg=False)
    if name == "pecsched/col":
        return PecSchedPolicy(cc, em, coloc=False)
    if name == "pecsched/fsp":
        return PecSchedPolicy(cc, em, fastsp=False)
    if name == "pecsched/coord":  # §5.2 load-adaptive role coordination
        return PecSchedPolicy(cc, em, coordination="adaptive")
    if name == "pecsched/cache":  # prefix-cache affinity routing + pricing
        return PecSchedCachePolicy(cc, em)
    if name == "pecsched/cache_greedy":  # affinity-vs-balance ablation
        return PecSchedCachePolicy(cc, em, greedy=True)
    if name == "pecsched/slo":  # SLO plan-ahead: slack order + shed + retract
        return PecSchedSLOPolicy(cc, em)
    if name == "sjf_pred" or name.startswith("sjf_pred:"):
        spec = name.partition(":")[2] or "noisy0.6"
        return PredSJFPolicy(cc, em, predictor_spec=spec)
    if name == "tail_aware" or name.startswith("tail_aware:"):
        spec = name.partition(":")[2] or "noisy0.6"
        return TailAwarePolicy(cc, em, predictor_spec=spec)
    raise ValueError(name)

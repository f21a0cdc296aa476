"""Discrete-event cluster simulator for LLM inference scheduling.

Reproduces the paper's evaluation methodology (§6): requests replayed from an
Azure-style trace onto a cluster of model replicas; each policy (FIFO,
Reservation, Priority, PecSched + ablations) decides placement; execution
times come from the roofline cost model (costmodel.py) — the same formulas
the dry-run roofline analysis uses, so simulator and compiled-artifact
analysis share one source of truth.

Event kinds: ARRIVAL(request), DONE(work), FLEET(churn: reclamation
notice/deadline or autoscale join, routed to the attached FleetController —
core/fleet.py); anything else is backend-internal (engine quanta). Policies
expose on_event hooks and a dispatch() pass.

The event loop is built for 100 K+-request traces:

* **Slotted heap** (`EventHeap`): the binary heap orders distinct
  timestamps only; each timestamp owns an ordered slot of events. Pushing
  a second event at an existing time is a dict append, not a heap sift.
* **Cheap cancellation**: `Simulator.cancel(work)` nulls the pending DONE
  entry in O(1) — the dead `Work` (and the Request lists it holds) is
  garbage-collectable immediately instead of lingering in the heap until
  its timestamp pops.
* **Batched same-timestamp dispatch**: all events at one timestamp are
  applied before a single `policy.dispatch()` pass, so simultaneous
  completions trigger one placement scan, not one per event.
* **Profile counters**: `Simulator.profile()` reports events, pushes,
  cancels, dispatch passes, peak heap size, wall/policy time and events/sec
  (surfaced by `benchmarks/simulator_scale.py --profile` and
  `examples/trace_replay.py --profile`).
"""
from __future__ import annotations

import heapq
import time as _time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.request import Request

# heap entry: a mutable [kind, payload, popped] triple; cancellation nulls
# the payload in place (payload None == dead entry, skipped on pop), and
# pop_batch marks entries popped so a late cancel() can't corrupt counters
Entry = list


class EventHeap:
    """Timestamp-slotted event heap with O(1) cancellation.

    `_times` is a heap of distinct timestamps; `_slots[t]` is the ordered
    list of entries scheduled at `t` (push order == dispatch order, so the
    old (t, seq) tie-break semantics are preserved within a slot).
    """

    def __init__(self):
        self._times: List[float] = []
        self._slots: Dict[float, List[Entry]] = {}
        self.n_live = 0
        self.n_pushed = 0
        self.n_canceled = 0
        self.peak_slots = 0

    def __len__(self) -> int:
        return self.n_live

    def push(self, t: float, kind: str, payload) -> Entry:
        entry: Entry = [kind, payload, False]
        slot = self._slots.get(t)
        if slot is None:
            self._slots[t] = [entry]
            heapq.heappush(self._times, t)
        else:
            slot.append(entry)
        self.n_live += 1
        self.n_pushed += 1
        if len(self._slots) > self.peak_slots:
            self.peak_slots = len(self._slots)
        return entry

    def load(self, items: Iterable[Tuple[float, str, object]]) -> None:
        """Bulk-load (t, kind, payload) triples; heapifies once instead of
        sifting per push — the fast path for seeding a trace's arrivals."""
        for t, kind, payload in items:
            entry: Entry = [kind, payload, False]
            slot = self._slots.get(t)
            if slot is None:
                self._slots[t] = [entry]
            else:
                slot.append(entry)
            self.n_live += 1
            self.n_pushed += 1
        self._times = list(self._slots.keys())
        heapq.heapify(self._times)
        if len(self._slots) > self.peak_slots:
            self.peak_slots = len(self._slots)

    def cancel(self, entry: Entry) -> bool:
        if entry[1] is None or entry[2]:     # dead, or already dispatched
            return False
        entry[0] = "CANCELED"
        entry[1] = None
        self.n_live -= 1
        self.n_canceled += 1
        return True

    def pop_batch(self, limit: Optional[float] = None
                  ) -> Optional[Tuple[float, List[Entry]]]:
        """Pop ALL events at the earliest live timestamp.  With `limit`,
        pop only if that timestamp is <= limit — otherwise return None and
        leave the heap untouched (the lazy-arrival loop peeks this way to
        interleave trace arrivals without materializing them as entries)."""
        while self._times:
            if limit is not None and self._times[0] > limit:
                return None
            t = heapq.heappop(self._times)
            slot = self._slots.pop(t)
            live = slot                 # common case: no canceled entries,
            for e in slot:              # hand back the slot list itself
                if e[1] is None:
                    live = [x for x in slot if x[1] is not None]
                    break
            if live:
                for e in live:
                    e[2] = True
                self.n_live -= len(live)
                return t, live
        return None

    def unpop(self, t: float, entries: List[Entry]) -> None:
        """Reinstate a popped batch unprocessed (horizon truncation): the
        events become pending again instead of silently vanishing, so a
        truncated replay keeps its in-flight completions inspectable."""
        for e in entries:
            e[2] = False
        slot = self._slots.get(t)
        if slot is None:
            self._slots[t] = list(entries)
            heapq.heappush(self._times, t)
        else:                               # pragma: no cover - defensive
            slot.extend(entries)
        self.n_live += len(entries)


@dataclass(slots=True)
class Work:
    wid: int
    kind: str                   # short_prefill|short_decode|short_full|
    #                             long_prefill|long_decode|long_full
    replica_ids: List[int]
    requests: List[Request]
    start: float
    duration: float
    colocated: bool = False
    canceled: bool = False
    #: SP mode the policy planned this Work with ("local" | "ring" |
    #: "fastsp").  Analytic backends already priced it into `duration`;
    #: the engine backend uses it to decide whether a multi-replica
    #: long_prefill executes as a gang-scheduled shard_map SP prefill
    #: (fastsp) or on a single replica (ring/local).
    sp_mode: str = "local"
    #: decode-lane round budget (tokens) for `pred_decode` work: the
    #: scheduler's *predicted* remaining output length.  Execution stops at
    #: EOS if truth is shorter; if truth is longer the lane is evicted at
    #: this step boundary and the request re-queued (decode-lane preemption).
    token_budget: Optional[int] = None

    @property
    def end(self) -> float:
        return self.start + self.duration


class Simulator:
    """Shared event-loop driver for every execution backend.

    ``Simulator(policy)`` replays analytically (SimBackend, the default);
    ``Simulator(policy, backend=EngineBackend(...))`` drives the same policy
    over real JAX engines.  The loop itself is backend-agnostic: ARRIVAL and
    DONE events go to the policy, any other kind (engine quanta) goes to
    ``backend.on_event``.
    """

    def __init__(self, policy: "BasePolicy", backend=None, *,
                 elide_dispatch: bool = True, fleet=None):
        from repro_torch.core.backend import SimBackend
        self.policy = policy
        self.backend = backend if backend is not None else SimBackend()
        #: optional FleetController (core/fleet.py): injects replica churn
        #: (reclamation notices/deadlines, autoscale joins) as FLEET events
        #: and steps its autoscaler before each dispatch pass.  None — and
        #: an inert controller — leave the event stream untouched.
        self.fleet = fleet
        self.heap = EventHeap()
        self._work_entries: Dict[int, Entry] = {}   # wid -> pending entry
        self.now = 0.0
        self.sched_time = 0.0           # wall-clock spent in policy decisions
        self.run_time = 0.0             # wall-clock of the whole run()
        self.n_dispatches = 0           # dispatch passes actually run
        self.n_events = 0               # events applied (arrivals + dones)
        self.last_arrival = 0.0
        #: dirty-dispatch elision: skip the dispatch pass after a batch that
        #: changed nothing a policy could act on.  False = the brute-force
        #: reference driver (dispatch after EVERY batch) the decision-log
        #: property suite compares against.
        self.elide_dispatch = elide_dispatch
        self.n_elided_quantum = 0       # skipped: pure backend-quantum batch
        self.n_elided_idle = 0          # skipped: policy.needs_dispatch False
        #: arrivals applied straight off the lazy stream (never heap
        #: entries); counted as logical pushes so the accounting identity
        #: events + cancels == pushes holds either way arrivals are fed
        self.n_stream_arrivals = 0

    # ------------------------------------------------------------------
    def push(self, t: float, kind: str, payload) -> Entry:
        entry = self.heap.push(t, kind, payload)
        if kind != "ARRIVAL":
            # one pending entry per Work at a time (its DONE or its next
            # backend-internal quantum) — cancel() kills whichever is live
            self._work_entries[payload.wid] = entry
        return entry

    def cancel(self, work: Work) -> bool:
        """Cancel a pending DONE. O(1); the dead entry never dispatches and
        drops its payload reference immediately."""
        work.canceled = True
        entry = self._work_entries.pop(work.wid, None)
        return self.heap.cancel(entry) if entry is not None else False

    # ------------------------------------------------------------------
    def run(self, requests: "Iterable[Request]", *,
            horizon: Optional[float] = None) -> Dict:
        """Replay `requests` to completion (or to `horizon`).

        Arrivals are fed LAZILY: instead of materializing every request as
        a heap entry up front (1M entries for a 1M-request trace), the loop
        walks an arrival-sorted stream next to the heap and merges the two
        — at equal timestamps arrivals apply first, exactly the slot order
        the old bulk `heap.load` produced.  A list input is sorted here
        (stable, so same-time order is preserved); any other iterable must
        already be arrival-sorted — generators make the replay memory-flat,
        since a completed request with no retaining policy list is
        garbage-collected immediately.

        Horizon semantics: the first event batch strictly past `horizon` is
        pushed back into the heap unprocessed (`EventHeap.unpop`, with the
        unconsumed arrivals bulk-loaded alongside it), so a truncated
        replay does NOT silently drop in-flight completions — they stay
        pending in `self.heap` for inspection, and `self.now` stops at the
        last applied timestamp <= horizon.
        """
        wall0 = _time.perf_counter()
        if isinstance(requests, (list, tuple)):
            requests = sorted(requests, key=lambda r: r.arrival)
            self.last_arrival = requests[-1].arrival if requests else 0.0
        self.backend.bind(self)
        self.policy.bind(self.backend)
        if self.fleet is not None:
            self.fleet.bind(self)
        fleet = self.fleet
        fleet_event = fleet.on_event if fleet is not None else None
        fleet_step = fleet.step if fleet is not None else None
        on_arrival, on_done = self.policy.on_arrival, self.policy.on_done
        dispatch = self.policy.dispatch
        needs_dispatch = self.policy.needs_dispatch
        elide = self.elide_dispatch
        backend_event = self.backend.on_event
        finish = self.backend.finish if self.backend.needs_finish else None
        arr_iter = iter(requests)
        next_req = next(arr_iter, None)
        arrivals: List[Request] = []
        while True:
            t_arr = next_req.arrival if next_req is not None else None
            batch = self.heap.pop_batch(limit=t_arr)
            if batch is None:
                if next_req is None:
                    break                   # heap drained, trace consumed
                t, entries = t_arr, ()
            else:
                t, entries = batch
            del arrivals[:]
            while next_req is not None and next_req.arrival <= t:
                if next_req.arrival < t:
                    raise ValueError(
                        "run() requires arrival-sorted requests (got "
                        f"arrival {next_req.arrival} after time {t})")
                arrivals.append(next_req)
                next_req = next(arr_iter, None)
            if horizon is not None and t > horizon:
                if entries:
                    self.heap.unpop(t, entries)
                rest = [(r.arrival, "ARRIVAL", r) for r in arrivals]
                rest.extend((r.arrival, "ARRIVAL", r) for r in arr_iter)
                if next_req is not None:
                    rest.append((next_req.arrival, "ARRIVAL", next_req))
                self.heap.load(rest)
                break
            self.now = t
            if arrivals and t > self.last_arrival:
                self.last_arrival = t       # generator input: track inline
            t0 = _time.perf_counter()
            n_policy_events = len(arrivals)
            self.n_stream_arrivals += n_policy_events
            self.n_events += n_policy_events
            for r in arrivals:
                on_arrival(t, r)
            for entry in entries:
                kind, payload = entry[0], entry[1]
                if payload is None:         # canceled mid-batch (legacy path)
                    continue
                if kind == "ARRIVAL":       # reinstated post-horizon entries
                    on_arrival(t, payload)
                    n_policy_events += 1
                elif kind == "DONE":
                    self._work_entries.pop(payload.wid, None)
                    if payload.canceled:    # legacy flag-only cancellation
                        continue
                    if finish is not None:
                        finish(t, payload)
                    on_done(t, payload)
                    n_policy_events += 1
                elif kind == "FLEET":       # churn: notice/reclaim/join
                    self._work_entries.pop(payload.wid, None)
                    if payload.canceled:    # pragma: no cover - defensive
                        continue
                    fleet_event(t, payload)
                    # churn moves policy-visible state (queues refill with
                    # restarted work, index sets shrink/grow), so the batch
                    # must NOT be elided as a pure backend quantum
                    n_policy_events += 1
                else:                       # backend-internal (engine quantum)
                    self._work_entries.pop(payload.wid, None)
                    if payload.canceled:
                        continue
                    backend_event(t, kind, payload)
                self.n_events += 1
            # dirty-dispatch elision: a pure backend-quantum batch moved no
            # policy-visible state; an event batch that left every queue
            # empty (needs_dispatch False) provably has nothing to place
            if elide and n_policy_events == 0:
                self.n_elided_quantum += 1
            elif elide and not needs_dispatch(t):
                self.n_elided_idle += 1
            else:
                if fleet_step is not None:
                    # autoscaler decisions piggyback on dispatch passes:
                    # fleet pressure only moves on policy-visible events,
                    # so elided batches cannot hide a scale-up trigger
                    fleet_step(t)
                dispatch(t)
                self.n_dispatches += 1
            self.sched_time += _time.perf_counter() - t0
        self.policy.finalize(self.now)
        self.run_time = _time.perf_counter() - wall0
        return self.policy.summary(self.now)

    # ------------------------------------------------------------------
    def profile(self) -> Dict:
        """Event-loop counter report (cheap ints, always collected)."""
        index = getattr(self.policy, "index", None)
        return {
            "events": self.n_events,
            "pushes": self.heap.n_pushed + self.n_stream_arrivals,
            "cancels": self.heap.n_canceled,
            "dispatch_passes": self.n_dispatches,
            # dirty-dispatch elision: batches whose dispatch pass was skipped
            # because nothing policy-visible changed (pure backend quanta) or
            # the policy proved itself idle (needs_dispatch False)
            "dispatch_elided_quantum": self.n_elided_quantum,
            "dispatch_elided_idle": self.n_elided_idle,
            "events_per_dispatch": self.n_events / max(self.n_dispatches, 1),
            "peak_heap_slots": self.heap.peak_slots,
            # cluster-index effectiveness: set-backed lookups vs O(R) rescans
            "index_queries": getattr(index, "n_queries", 0),
            "index_rescans": getattr(index, "n_rescans", 0),
            "wall_s": self.run_time,
            "policy_s": self.sched_time,
            "loop_s": self.run_time - self.sched_time,
            "events_per_sec": self.n_events / max(self.run_time, 1e-9),
        }


def format_profile(p: Dict) -> str:
    return ("events={events} pushes={pushes} cancels={cancels} "
            "dispatch_passes={dispatch_passes} "
            "elided(quantum/idle)={dispatch_elided_quantum}/"
            "{dispatch_elided_idle} "
            "events/dispatch={events_per_dispatch:.2f} "
            "peak_heap_slots={peak_heap_slots} "
            "index(queries/rescans)={index_queries}/{index_rescans} "
            "wall={wall_s:.2f}s "
            "(policy {policy_s:.2f}s / loop {loop_s:.2f}s) "
            "events/sec={events_per_sec:,.0f}".format(**p))

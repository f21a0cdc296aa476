"""Load-adaptive prefill/decode role coordination (paper §5.2, the
*coordinated* half of colocation-and-disaggregation).

`PecSchedPolicy` historically fixed the prefill/decode split once at
construction (`dedicated_decode=` partitions replicas statically).  Under
bursty or diurnal arrivals that static split is exactly the
underutilization §5.2 warns about: the decode pool idles through prefill
surges and saturates through decode surges.  The `RoleCoordinator` turns
the split into a dispatch-time decision: it watches observable pressure
signals and flips replica roles between

    short_decode -> prefill   borrow a *drained* decode replica for short
                              prefill during a prefill surge
    prefill -> short_decode   return a borrowed replica when decode
                              pressure rises or the surge is over

Pressure signals (all policy-observable, so decisions replay identically
on the analytic simulator and the real-engine backend — the parity bar
PR 2 set for policies):

    * short-queue backlog, in prefill batches (`cc.max_batch_tokens`)
    * decode demand: queued migrations + in-flight decode load, against
      the active pool's `cc.max_decode_concurrency` capacity
    * in-flight long prefill seconds, priced by the cost model (the
      policy's own Work durations)

Safe points (the coordinator NEVER flips a replica mid-work):

    * a decode replica flips out only when `decode_load == 0`; a loaded
      candidate is marked `draining` (it accepts no new decode batches)
      and flips when its last decode completes
    * the last non-draining pool replica may only start draining when the
      migration queue is empty — afterwards short prefill completions
      decode in place (the colocated path), so nothing ever waits on an
      empty pool
    * a borrowed replica returns only when idle

Hysteresis: at most one transition *initiation* per `hysteresis_s`
window, so adversarial arrival patterns (square waves) bound the flip
rate at ~duration/hysteresis_s instead of thrashing roles per event.  The
default window is cost-model derived (a few full prefill batches), so the
same coordinator config scales from the 32-GPU simulated cluster to the
CPU-sized engine cluster.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class CoordinatorConfig:
    #: floor on the decode pool size.  0 lets the pool empty entirely —
    #: completions then decode in place, the colocated §5.2 path — which
    #: only pays off when in-place decode is cheap relative to pooled
    #: decode; the default keeps one pooled replica, so borrowing never
    #: trades batched decode for serial in-place decode behind prefills
    min_decode: int = 1
    #: borrow when the short backlog exceeds the idle prefill-capable
    #: replicas by at least this many full batches
    borrow_margin: int = 1
    #: ... or when in-flight long prefills hold at least this many
    #: full-batch prefill times of general capacity (cost-model priced)
    #: while ANY short queues — a BIG long eats prefill capacity for many
    #: batch-times, so even a shallow backlog behind one is worth a
    #: borrow; the threshold is deliberately high (a real SP-group-scale
    #: prefill, not every long) so shallow-backlog borrows do not dilute
    #: the deep-surge wins the backlog watermark captures
    long_pressure_batches: float = 32.0
    #: borrowing must leave the remaining active pool with headroom:
    #: demand <= borrow_headroom * remaining capacity
    borrow_headroom: float = 0.75
    #: return a borrowed replica when decode demand exceeds this fraction
    #: of the active pool's capacity
    return_hi: float = 0.75
    #: hysteresis window in units of full-batch prefill times (cost-model
    #: priced); the absolute floor below
    hysteresis_batches: float = 1.0
    hysteresis_min_s: float = 1e-6


class RoleCoordinator:
    """Dispatch-time role coordination for a disaggregated PecSched policy.

    Owns no replica state: it reads the policy's queues/replicas and applies
    flips through `policy._flip_role` (which records the transition log and
    notifies the execution backend).  `step(t, policy)` is called by the
    policy at the top of every dispatch pass.
    """

    def __init__(self, cc, em, config: Optional[CoordinatorConfig] = None):
        self.cc = cc
        self.em = em
        self.config = config or CoordinatorConfig()
        self._mdc = cc.max_decode_concurrency
        batch_s = em.prefill_time(cc.max_batch_tokens, 1, sp_mode="local")
        self.hysteresis_s = max(self.config.hysteresis_batches * batch_s,
                                self.config.hysteresis_min_s)
        self.long_pressure_s = self.config.long_pressure_batches * batch_s
        self._last_initiation = -math.inf
        self.n_initiations = 0

    # ------------------------------------------------------------------
    # pressure signals
    # ------------------------------------------------------------------
    def backlog_batches(self, policy) -> int:
        """Short backlog in full prefill batches (incrementally counted)."""
        return -(-policy.short_queue_tokens // self.cc.max_batch_tokens) \
            if policy.short_queue_tokens > 0 else 0

    def decode_demand(self, policy) -> int:
        """Queued migrations + in-flight decode load across the pool
        (the pool-wide load is an O(1) index aggregate)."""
        return len(policy.decode_queue) + policy.index.pool_decode_load

    def inflight_long_prefill_s(self, t: float, policy) -> float:
        """Cost-model seconds of long prefill currently holding general
        replicas (paused suspensions count their remaining estimate)."""
        total = 0.0
        for st in policy.longs.values():
            if st.phase != "prefill":
                continue
            if st.paused:
                total += st.remaining
            else:
                w = policy.replicas[st.rep_ids[0]].work
                if w is not None:
                    total += max(w.end - t, 0.0)
        return total

    # ------------------------------------------------------------------
    def step(self, t: float, policy) -> List[Tuple[int, str, str]]:
        """Complete pending drains, then consider at most one new
        transition.  Returns the flips applied this step as
        (rid, old_role, new_role) tuples."""
        idx = policy.index
        if idx.draining_pool:
            flips = self._complete_drains(t, policy)
        else:
            flips = []
        if t - self._last_initiation >= self.hysteresis_s:
            flip = self._consider_transition(t, policy)
            if flip is not None:
                self._last_initiation = t
                self.n_initiations += 1
                if flip[2] is not None:         # drain marks flip later
                    flips.append(flip)
        if flips and policy.decode_queue:
            policy._drain_decode_queue(t)
        return flips

    # ------------------------------------------------------------------
    def _complete_drains(self, t: float, policy) -> List[Tuple[int, str, str]]:
        flips = []
        idx = policy.index
        if not idx.draining_pool:
            return flips
        # the rid-order snapshot walks each candidate once, like the old
        # full replica scan did (membership may change as drains
        # cancel/flip).  backlog is loop-invariant: the walk only flips
        # roles / cancels drains, neither of which moves short_queue_tokens
        backlog = self.backlog_batches(policy)
        draining = sorted(idx.draining_pool)
        for rid in draining:
            rep = policy.replicas[rid]
            if not (rep._draining and rep._role == "short_decode"
                    and rep._decode_load == 0):
                continue
            if backlog == 0:
                # the surge that motivated the drain is over — cancel the
                # drain instead of flipping out and straight back
                rep.draining = False
                continue
            # rep is draining, so it is not in active_pool: the remaining
            # active capacity is exactly the live active set's
            remaining_cap = self._mdc * len(idx.active_pool)
            demand = len(policy.decode_queue) + idx.pool_decode_load
            if policy.decode_queue and remaining_cap == 0:
                # queued migrations with no other active pool replica —
                # cancel the drain instead of stranding them
                rep.draining = False
                continue
            if (demand > self.config.return_hi * remaining_cap
                    and t - self._last_initiation >= self.hysteresis_s):
                # decode pressure is high AND the return branch is eligible
                # to fire this very step: completing the flip would be
                # reversed immediately — rejoin the pool instead of logging
                # a same-timestamp flip/unflip pair
                rep.draining = False
                continue
            old = policy._flip_role(t, rep, "prefill")
            flips.append((rep.rid, old, "prefill"))
        return flips

    def _consider_transition(self, t: float, policy
                             ) -> Optional[Tuple[int, str, Optional[str]]]:
        """One borrow or return initiation; (rid, old, new) for an applied
        flip, (rid, old, None) for a drain mark, None for no-op."""
        cfg = self.config
        idx = policy.index
        borrowed = idx.by_role["prefill"]
        backlog = self.backlog_batches(policy)
        if not borrowed and backlog == 0 and cfg.borrow_margin > 0:
            # nothing to return, and borrowing needs a short backlog (the
            # watermark cannot fire at backlog 0 with a positive margin,
            # and the long-pressure signal requires backlog >= 1)
            return None
        active = idx.active_pool
        demand = len(policy.decode_queue) + idx.pool_decode_load
        active_cap = len(active) * self._mdc

        # ---- return first: decode pressure outranks prefill pressure ----
        if borrowed and (demand > cfg.return_hi * active_cap or backlog == 0):
            for rid in sorted(borrowed):            # rid-order scan as before
                rep = policy.replicas[rid]
                if rep.work is None:                # safe point: idle
                    old = policy._flip_role(t, rep, "short_decode")
                    return (rep.rid, old, "short_decode")
            return None                             # busy: retry next window

        # ---- borrow: prefill surge with decode headroom -----------------
        if len(active) <= cfg.min_decode or not active:
            return None
        idle_prefill = len(idx.idle_prefill)
        surging = backlog - idle_prefill >= cfg.borrow_margin
        if not surging and backlog >= 1:
            # the long-pressure signal walks in-flight longs — priced only
            # when the cheap backlog watermark alone has not fired
            surging = self.inflight_long_prefill_s(t, policy) \
                >= self.long_pressure_s
        if not surging:
            return None
        remaining_cap = (len(active) - 1) * self._mdc
        if demand > cfg.borrow_headroom * remaining_cap and remaining_cap > 0:
            return None
        # candidate: the highest-rid active replica (deterministic; the
        # static split puts the pool at the tail, so this unwinds it LIFO)
        cand = policy.replicas[max(active)]
        if remaining_cap == 0 and (demand > 0 or cand.decode_load > 0
                                   or policy.decode_queue):
            # emptying the pool entirely is only safe when nothing is
            # queued, loaded, or mid-drain
            return None
        if cand.decode_load == 0 and not policy.decode_queue:
            old = policy._flip_role(t, cand, "prefill")
            return (cand.rid, old, "prefill")
        if len(active) > 1:
            cand.draining = True                    # flips once drained
            return (cand.rid, cand.role, None)
        return None

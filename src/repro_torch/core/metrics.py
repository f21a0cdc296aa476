"""Metric aggregation matching the paper's reported quantities.

`summarize` is the single summary producer for every backend and every
harness (simulator sweeps, engine runs, the experiments subsystem, the
benchmark figures).  Its output is **JSON-stable**: every key is a string,
every value is a JSON-native scalar/dict/list, so a summary survives a
``json.dumps``/``loads`` round trip unchanged — the experiments result
cache and the claims ledger depend on that (tests/test_metrics.py).

Percentile dicts therefore use string keys ("1", "25", ..., "99"); use
`pct(summary_field, p)` to read one without caring whether the dict came
straight from `summarize` or through a JSON cache file.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.core.request import Phase, Request

PCTS = (1, 25, 50, 75, 99)


def pct(pct_dict: Optional[Dict], p) -> Optional[float]:
    """Read percentile `p` from a summary percentile dict (string keys)."""
    if pct_dict is None:
        return None
    return pct_dict[str(p)]


def _pct_dict(values: np.ndarray) -> Dict[str, Optional[float]]:
    if not len(values):
        return {str(p): None for p in PCTS}
    # one vectorized percentile call (one sort) instead of a full pass per
    # percentile — numerically identical to per-p calls, since each quantile
    # is interpolated from the same sorted array
    qs = np.percentile(values, PCTS)
    return {str(p): float(q) for p, q in zip(PCTS, qs)}


class _Buf:
    """Growable float64 buffer: amortized O(1) append into a typed numpy
    array, no per-value Python objects — the streaming-metrics container."""

    __slots__ = ("_a", "n")

    def __init__(self, cap: int = 256):
        self._a = np.empty(cap, dtype=np.float64)
        self.n = 0

    def add(self, v: float) -> None:
        a = self._a
        if self.n == a.shape[0]:
            self._a = a = np.concatenate(
                [a, np.empty(a.shape[0], dtype=np.float64)])
        a[self.n] = v
        self.n += 1

    def view(self) -> np.ndarray:
        return self._a[:self.n]


def _mean_sorted(values: np.ndarray) -> Optional[float]:
    """Order-canonical mean: summing the sorted array makes the result a
    function of the value *multiset* only, so the streaming path (completion
    order) and the retained path (arrival order) produce byte-identical
    means instead of agreeing to ulps."""
    if not len(values):
        return None
    return float(np.sort(values).sum() / len(values))


class MetricsAccumulator:
    """Streaming summary state: per-request statistics fold into typed
    buffers at completion time, so `summarize` never needs the retained
    `all_requests`/`done_requests` lists — the memory-flat metrics path for
    million-request replays (`BasePolicy.enable_streaming_metrics`).

    `pending` holds arrived-but-uncompleted requests (bounded by what is
    queued/in flight, which the policy retains anyway); completed requests
    leave no reference behind."""

    def __init__(self, em=None):
        self.em = em
        self.pending: Dict[int, Request] = {}
        self.n_short = 0
        self.n_long = 0
        self.short_done = 0
        self.long_done = 0
        self.short_qd = _Buf()
        self.short_slow = _Buf()
        self.long_jct = _Buf()
        self.long_slow = _Buf()
        self.long_prefill_start = _Buf()    # NaN == never began service
        self.min_short_arrival = math.inf
        self.max_short_finish = -math.inf
        self.tenants: Dict[str, Dict] = {}
        # --- SLO / goodput state (PecSched SLO extension) ---
        self.ttft = _Buf()                  # completed, first token served
        self.tpot = _Buf()                  # completed, >= 1 decode step
        self.min_arrival = math.inf         # all requests (goodput span)
        self.max_finish = -math.inf         # all completions (goodput span)
        self.good_done = 0                  # completions honouring their SLO
        self.shed = 0                       # requests dropped by the policy
        self.tiers: Dict[str, Dict] = {}    # tier -> n/completed/shed/attained

    def _tier(self, name: str) -> Dict:
        t = self.tiers.get(name)
        if t is None:
            t = self.tiers[name] = {"n": 0, "completed": 0, "shed": 0,
                                    "attained": 0}
        return t

    def _tenant(self, name: str) -> Dict:
        t = self.tenants.get(name)
        if t is None:
            t = self.tenants[name] = {
                "n": 0, "completed": 0, "qd": _Buf(), "jct": _Buf(),
                "min_arrival": math.inf, "max_finish": -math.inf}
        return t

    def arrive(self, req: Request) -> None:
        self.pending[req.rid] = req
        if req.is_long:
            self.n_long += 1
        else:
            self.n_short += 1
            if req.arrival < self.min_short_arrival:
                self.min_short_arrival = req.arrival
        if req.arrival < self.min_arrival:
            self.min_arrival = req.arrival
        if req.slo is not None:
            self._tier(req.slo)["n"] += 1
        if req.tenant is not None:
            t = self._tenant(req.tenant)
            t["n"] += 1
            if req.arrival < t["min_arrival"]:
                t["min_arrival"] = req.arrival

    def complete(self, req: Request) -> None:
        self.pending.pop(req.rid, None)
        jct = req.jct
        slow = None
        if self.em is not None and jct is not None:
            ideal = _ideal_service_time(self.em, req)
            if ideal and ideal > 0:
                slow = max(jct / ideal, 0.0)
        if req.is_long:
            self.long_done += 1
            if jct is not None:
                self.long_jct.add(jct)
            if slow is not None:
                self.long_slow.add(slow)
            ps = req.prefill_start
            self.long_prefill_start.add(math.nan if ps is None else ps)
        else:
            self.short_done += 1
            qd = req.queueing_delay
            if qd is not None:
                self.short_qd.add(qd)
            if slow is not None:
                self.short_slow.add(slow)
            if req.finish is not None and req.finish > self.max_short_finish:
                self.max_short_finish = req.finish
        ttft = req.ttft
        if ttft is not None:
            self.ttft.add(ttft)
        if req.finish is not None and req.first_token is not None:
            self.tpot.add(req.tpot)
        if req.finish is not None and req.finish > self.max_finish:
            self.max_finish = req.finish
        completed = req.phase == Phase.DONE and req.finish is not None
        if completed and req.slo_met() is not False:
            self.good_done += 1
        if req.shed:
            self.shed += 1
        if req.slo is not None:
            tier = self._tier(req.slo)
            if completed:
                tier["completed"] += 1
                if req.slo_met():
                    tier["attained"] += 1
            if req.shed:
                tier["shed"] += 1
        if req.tenant is not None:
            t = self._tenant(req.tenant)
            qd = req.queueing_delay
            if qd is not None:
                t["qd"].add(qd)
            if req.phase == Phase.DONE and req.finish is not None:
                t["completed"] += 1
                if req.finish > t["max_finish"]:
                    t["max_finish"] = req.finish
                if jct is not None:
                    t["jct"].add(jct)


def _summarize_streaming(policy, acc: MetricsAccumulator,
                         t_end: float) -> Dict:
    """The streaming twin of `summarize`: same fields, same JSON-stable
    contract, read from the accumulator's buffers plus the still-pending
    requests (which are the only Request objects left to inspect).  Counts
    and percentiles are exactly the retained-mode values; order-sensitive
    float means agree to ulps (completion order vs arrival order)."""
    last_arrival = getattr(policy.sim, "last_arrival", t_end) \
        if policy.sim else t_end
    pend = list(acc.pending.values())
    pend_qd = [r.queueing_delay for r in pend
               if not r.is_long and r.queueing_delay is not None]
    qd = acc.short_qd.view()
    if pend_qd:
        qd = np.concatenate([qd, np.asarray(pend_qd, dtype=np.float64)])
    short_slow = acc.short_slow.view()
    long_slow = acc.long_slow.view()
    # starved longs (paper Table 2): completed ones from the recorded
    # prefill-start buffer (NaN = never served), pending ones directly
    ps = acc.long_prefill_start.view()
    n_starved = int(np.count_nonzero(np.isnan(ps) | (ps > last_arrival)))
    n_starved += sum(1 for r in pend if r.is_long
                     and (r.prefill_start is None
                          or r.prefill_start > last_arrival))
    if acc.short_done and acc.n_short:
        short_rps = acc.short_done / max(
            acc.max_short_finish - acc.min_short_arrival, 1e-9)
    else:
        short_rps = 0.0
    long_jct = acc.long_jct.view()
    # TTFT over everything served so far: completed from the buffer, plus
    # pending requests whose first token already landed (mirrors qd above)
    ttft = acc.ttft.view()
    pend_ttft = [r.ttft for r in pend if r.ttft is not None]
    if pend_ttft:
        ttft = np.concatenate([ttft, np.asarray(pend_ttft,
                                                dtype=np.float64)])
    tpot = acc.tpot.view()
    span = acc.max_finish - acc.min_arrival
    goodput = acc.good_done / max(span, 1e-9) if acc.good_done else 0.0
    out = {
        "policy": policy.name,
        "t_end": float(t_end),
        "n_short": acc.n_short, "n_long": acc.n_long,
        "short_completed": acc.short_done,
        "long_completed": acc.long_done,
        "short_qd_pct": _pct_dict(qd),
        "short_qd_mean": _mean_sorted(qd),
        "short_rps": short_rps,
        "long_jct_mean": (_mean_sorted(long_jct)
                          if acc.long_done else None),
        "long_jct_p99": (float(np.percentile(long_jct, 99))
                         if acc.long_done else None),
        "ttft_mean": _mean_sorted(ttft),
        "ttft_pct": _pct_dict(ttft),
        "tpot_mean": _mean_sorted(tpot),
        "tpot_pct": _pct_dict(tpot),
        "goodput": goodput,
        "slo_shed": acc.shed,
        "short_slowdown_pct": _pct_dict(short_slow),
        "short_slowdown_mean": _mean_sorted(short_slow),
        "long_slowdown_mean": _mean_sorted(long_slow),
        "long_starved_frac": (n_starved / acc.n_long
                              if acc.n_long else 0.0),
        "preemptions": int(getattr(policy, "preemption_events", 0)),
        "decode_preemptions": int(
            getattr(policy, "decode_preemption_events", 0)),
        "gpu_idle_rate": _idle_rate(policy, t_end),
        "busy_overflow_s": 0.0,     # refined by _role_breakdown below
        "role_flips": len(getattr(policy, "role_log", ())),
        "reclaims": int(getattr(policy, "reclaims", 0)),
        "evacuated_blocks": int(getattr(policy, "evacuated_blocks", 0)),
        "restarted_requests": int(getattr(policy, "restarted_requests", 0)),
        "joins": int(getattr(policy, "joins", 0)),
    }
    out.update(_prefix_cache_fields(policy))
    roles = _role_breakdown(policy, t_end)
    if roles is not None:
        out.update(roles)
    if acc.tiers:
        out["slo_tiers"] = {
            tier: {"n": t["n"], "completed": t["completed"],
                   "shed": t["shed"], "attained": t["attained"],
                   "attainment": (t["attained"] / t["n"]
                                  if t["n"] else 0.0)}
            for tier, t in sorted(acc.tiers.items())}
    if acc.tenants:
        pend_tenant_qd: Dict[str, List[float]] = {}
        for r in pend:
            if r.tenant is not None and r.queueing_delay is not None:
                pend_tenant_qd.setdefault(r.tenant, []).append(
                    r.queueing_delay)
        per_tenant: Dict[str, Dict] = {}
        for tenant, t in sorted(acc.tenants.items()):
            tqd = t["qd"].view()
            extra = pend_tenant_qd.get(tenant)
            if extra:
                tqd = np.concatenate(
                    [tqd, np.asarray(extra, dtype=np.float64)])
            span = (t["max_finish"] - t["min_arrival"]
                    if t["completed"] else 0.0)
            per_tenant[tenant] = {
                "n": t["n"],
                "completed": t["completed"],
                "qd_mean": _mean_sorted(tqd),
                "qd_pct": _pct_dict(tqd),
                "rps": (t["completed"] / max(span, 1e-9)
                        if t["completed"] else 0.0),
                "jct_mean": (_mean_sorted(t["jct"].view())
                             if t["completed"] else None),
            }
        out["per_tenant"] = per_tenant
    return out


def summarize(policy, t_end: float) -> Dict:
    acc = getattr(policy, "metrics_acc", None)
    if acc is not None:
        return _summarize_streaming(policy, acc, t_end)
    reqs: List[Request] = policy.all_requests
    last_arrival = getattr(policy.sim, "last_arrival", t_end) if policy.sim else t_end
    shorts = [r for r in reqs if not r.is_long]
    longs = [r for r in reqs if r.is_long]
    short_done = [r for r in shorts if r.phase == Phase.DONE]
    long_done = [r for r in longs if r.phase == Phase.DONE]

    qd = np.array([r.queueing_delay for r in shorts
                   if r.queueing_delay is not None])
    short_slow = _slowdowns(policy, short_done)
    long_slow = _slowdowns(policy, long_done)
    # TTFT spans completed AND pending-but-served requests (like qd above);
    # TPOT needs a finish time, so it is completion-only
    ttft = np.array([r.ttft for r in reqs if r.ttft is not None])
    tpot = np.array([r.tpot for r in reqs
                     if r.finish is not None and r.first_token is not None])
    completed = [r for r in reqs
                 if r.phase == Phase.DONE and r.finish is not None]
    # goodput: completions that honoured their SLO tier contract (untiered
    # requests count as trivially satisfied) per second of workload span
    n_good = sum(1 for r in completed if r.slo_met() is not False)
    finished = [r.finish for r in reqs if r.finish is not None]
    span = (max(finished) - min(r.arrival for r in reqs)
            if finished and reqs else 0.0)
    goodput = n_good / max(span, 1e-9) if n_good else 0.0
    out = {
        "policy": policy.name,
        "t_end": float(t_end),
        "n_short": len(shorts), "n_long": len(longs),
        "short_completed": len(short_done),
        "long_completed": len(long_done),
        # paper Fig 2/3/9/12: percentile queueing delays of short requests
        "short_qd_pct": _pct_dict(qd),
        "short_qd_mean": _mean_sorted(qd),
        # paper Fig 10/13: short throughput (RPS over the shorts' span —
        # first arrival to last short completion; long-drain tail excluded)
        "short_rps": _short_rps(shorts, short_done),
        # paper Fig 11/14: average JCT of long requests
        "long_jct_mean": (_mean_sorted(np.array([r.jct for r in long_done]))
                          if long_done else None),
        "long_jct_p99": (float(np.percentile([r.jct for r in long_done], 99))
                         if long_done else None),
        # SLO extension: time-to-first-token / time-per-output-token, plus
        # goodput — completions weighted by SLO satisfaction per second —
        # and how many requests the policy deliberately shed
        "ttft_mean": _mean_sorted(ttft),
        "ttft_pct": _pct_dict(ttft),
        "tpot_mean": _mean_sorted(tpot),
        "tpot_pct": _pct_dict(tpot),
        "goodput": goodput,
        "slo_shed": sum(1 for r in reqs if r.shed),
        # normalized slowdown = JCT / ideal unloaded service time (cost-model
        # ideal: dedicated replicas, zero queueing) — the tail-aware metric
        # that makes 7B and 70B clusters comparable on one axis
        "short_slowdown_pct": _pct_dict(short_slow),
        "short_slowdown_mean": _mean_sorted(short_slow),
        "long_slowdown_mean": _mean_sorted(long_slow),
        # paper Table 2: starvation of longs — a long is starved if it never
        # began service while requests were still arriving (the post-trace
        # drain phase would not exist in continuous operation)
        "long_starved_frac": (float(np.mean([
            r.prefill_start is None or r.prefill_start > last_arrival
            for r in longs])) if longs else 0.0),
        # paper Table 3/6: total suspensions of long requests
        "preemptions": int(getattr(policy, "preemption_events", 0)),
        # prediction-robustness sweep: decode-lane evictions — a budgeted
        # decode round exhausted before EOS, i.e. one counted misprediction
        # (0 for every policy without a predictor)
        "decode_preemptions": int(
            getattr(policy, "decode_preemption_events", 0)),
        # paper Table 1: GPU idle rate (Eq. 1)
        "gpu_idle_rate": _idle_rate(policy, t_end),
        # busy-time accounted beyond the occupancy actually available — a
        # non-zero value means double-counted add_busy / broken accounting
        # that the idle-rate and utilization clamps would otherwise swallow
        # silently (refined by _role_breakdown below)
        "busy_overflow_s": 0.0,
        # §5.2 coordination: replica role flips performed by the coordinator
        # (0 for every static policy)
        "role_flips": len(getattr(policy, "role_log", ())),
        # elastic-fleet churn (core/fleet.py): replicas reclaimed, KV blocks
        # evacuated at cost-model price, and requests restarted from scratch
        # because their work was stranded on a reclaimed replica (all 0 on a
        # static fleet)
        "reclaims": int(getattr(policy, "reclaims", 0)),
        "evacuated_blocks": int(getattr(policy, "evacuated_blocks", 0)),
        "restarted_requests": int(getattr(policy, "restarted_requests", 0)),
        "joins": int(getattr(policy, "joins", 0)),
    }
    # prefix-cache routing (pecsched/cache): dispatch-time lookups/hits and
    # the prefill FLOPs the resident prefixes skipped (0 for cache-free
    # policies — the claims cells compare against exactly that zero)
    out.update(_prefix_cache_fields(policy))
    roles = _role_breakdown(policy, t_end)
    if roles is not None:
        out.update(roles)
    slo_tiers = _slo_tiers(reqs)
    if slo_tiers is not None:
        out["slo_tiers"] = slo_tiers
    per_tenant = _per_tenant(shorts + longs)
    if per_tenant is not None:
        out["per_tenant"] = per_tenant
    return out


def _slo_tiers(reqs: List[Request]) -> Optional[Dict[str, Dict]]:
    """Per-tier SLO accounting for tiered workloads (slo_tiered scenario);
    None when no request carries a tier, keeping untiered summaries
    unchanged.  `attainment` is attained over *arrived* (not completed) —
    shed and unfinished requests are honest misses."""
    tiers: Dict[str, Dict] = {}
    for r in reqs:
        if r.slo is None:
            continue
        t = tiers.setdefault(r.slo, {"n": 0, "completed": 0, "shed": 0,
                                     "attained": 0})
        t["n"] += 1
        if r.phase == Phase.DONE and r.finish is not None:
            t["completed"] += 1
            if r.slo_met():
                t["attained"] += 1
        if r.shed:
            t["shed"] += 1
    if not tiers:
        return None
    return {tier: {**t, "attainment": (t["attained"] / t["n"]
                                       if t["n"] else 0.0)}
            for tier, t in sorted(tiers.items())}


def _prefix_cache_fields(policy) -> Dict:
    """Prefix-cache counters, identical in the retained and streaming
    paths (they read policy-side dispatch counters, not request lists)."""
    ps = getattr(policy, "prefix_stats", None)
    if not ps:
        return {"prefix_lookups": 0, "prefix_hits": 0,
                "prefix_hit_rate": 0.0, "prefill_flops_saved": 0.0}
    lookups = int(ps.get("lookups", 0))
    hits = int(ps.get("hits", 0))
    return {
        "prefix_lookups": lookups,
        "prefix_hits": hits,
        "prefix_hit_rate": (hits / lookups) if lookups else 0.0,
        "prefill_flops_saved": float(ps.get("flops_saved", 0.0)),
    }


def _role_breakdown(policy, t_end: float) -> Optional[Dict]:
    """Role-occupancy timeline + utilization-by-role (§5.2 coordination).

    `role_occupancy` is the fraction of total replica-time spent in each
    role; `role_utilization` is busy-time over occupancy per role —
    together they show WHERE the coordinator moved capacity and whether
    the moved capacity was actually used.  `role_timeline` (the flip log,
    [t, rid, old, new] rows) appears only when flips occurred, keeping
    static-policy summaries small.

    Utilization is capped at 1.0 for display, but the cap is NOT silent:
    `busy_overflow_s` totals the busy-seconds accounted beyond each role's
    actual occupancy, so a double-counted `add_busy` (or any broken busy
    accounting) surfaces as a non-zero overflow instead of vanishing into
    the clamp (tests/test_metrics.py pins this).  The decode pool is the
    one deliberate exception: `short_decode` replicas run CONCURRENT
    decode rounds (lane-seconds, not wall-seconds), so that role's busy
    legitimately exceeds occupancy and is excluded — a healthy run reports
    overflow 0.0."""
    replicas = getattr(policy, "replicas", None)
    if not replicas or t_end <= 0 or not hasattr(replicas[0], "role_occupancy"):
        return None
    occ: Dict[str, float] = {}
    busy: Dict[str, float] = {}
    for r in replicas:
        for role, secs in r.role_occupancy(t_end).items():
            occ[role] = occ.get(role, 0.0) + secs
        for role, secs in r.busy_by_role.items():
            busy[role] = busy.get(role, 0.0) + secs
    # elastic fleets: a replica only accounts for the time it existed
    # (join -> reclaim), so churned runs aren't charged phantom occupancy
    total = sum((r.lifespan(t_end) if hasattr(r, "lifespan") else t_end)
                for r in replicas)
    if total <= 0:                      # pragma: no cover - degenerate
        return None
    overflow = sum(max(busy.get(role, 0.0) - occ.get(role, 0.0), 0.0)
                   for role in set(busy) | set(occ)
                   if role != "short_decode")
    out: Dict = {
        "busy_overflow_s": overflow,
        "role_occupancy": {role: secs / total
                           for role, secs in sorted(occ.items())},
        "role_utilization": {role: min(busy.get(role, 0.0) / secs, 1.0)
                             for role, secs in sorted(occ.items()) if secs > 0},
    }
    role_log = getattr(policy, "role_log", ())
    if role_log:
        out["role_timeline"] = [[float(t), int(rid), old, new]
                                for (t, rid, old, new) in role_log]
    return out


def _short_rps(shorts: List[Request], short_done: List[Request]) -> float:
    done = [r for r in short_done if r.finish is not None]
    if not done or not shorts:
        return 0.0
    start = min(r.arrival for r in shorts)
    end = max(r.finish for r in done)
    return len(done) / max(end - start, 1e-9)


def _idle_rate(policy, t_end: float) -> float:
    replicas = getattr(policy, "replicas", None) or []
    if t_end <= 0 or not replicas:
        return 0.0
    total_busy = sum(r.busy_time for r in replicas)
    # lifespan-weighted denominator: reclaimed/joined replicas only count
    # while they exist (static fleets: lifespan == t_end, as before)
    total = sum((r.lifespan(t_end) if hasattr(r, "lifespan") else t_end)
                for r in replicas)
    if total <= 0:                      # pragma: no cover - degenerate
        return 0.0
    # floored at 0 for display; over-counted busy-time (negative idle) is
    # surfaced via `busy_overflow_s` rather than silently swallowed —
    # per-role overflow is a superset of this aggregate (busy_by_role sums
    # to busy_time, occupancy sums to t_end per replica)
    return max(0.0, 1.0 - total_busy / total)


def _ideal_service_time(em, req: Request) -> Optional[float]:
    """Unloaded service time for one request under the cost model: dedicated
    replica(s), zero queueing.  Longs get their SP group, shorts one replica."""
    if em is None:
        return None
    if req.is_long:
        R = em.replicas_needed(req.input_len)
        t = em.prefill_time(req.input_len, R, sp_mode="fastsp")
    else:
        t = em.prefill_time(req.input_len, 1, sp_mode="local")
    return t + em.decode_time(req.output_len, req.input_len, batch=1)


def _slowdowns(policy, done: List[Request]) -> np.ndarray:
    em = getattr(policy, "em", None)
    if em is None:
        return np.array([])
    vals = []
    for r in done:
        if r.jct is None:
            continue
        ideal = _ideal_service_time(em, r)
        if ideal and ideal > 0:
            vals.append(max(r.jct / ideal, 0.0))
    return np.array(vals)


def _per_tenant(reqs: List[Request]) -> Optional[Dict[str, Dict]]:
    """Per-tenant breakdown for tagged workloads (multi_tenant scenario);
    None when no request carries a tenant tag, keeping untagged summaries
    byte-identical to before."""
    tenants: Dict[str, List[Request]] = {}
    for r in reqs:
        if r.tenant is not None:
            tenants.setdefault(r.tenant, []).append(r)
    if not tenants:
        return None
    out: Dict[str, Dict] = {}
    for tenant, rs in sorted(tenants.items()):
        done = [r for r in rs if r.phase == Phase.DONE and r.finish is not None]
        qd = np.array([r.queueing_delay for r in rs
                       if r.queueing_delay is not None])
        span = (max(r.finish for r in done) - min(r.arrival for r in rs)
                if done else 0.0)
        out[tenant] = {
            "n": len(rs),
            "completed": len(done),
            "qd_mean": _mean_sorted(qd),
            "qd_pct": _pct_dict(qd),
            "rps": len(done) / max(span, 1e-9) if done else 0.0,
            "jct_mean": (_mean_sorted(np.array([r.jct for r in done]))
                         if done else None),
        }
    return out


# ---------------------------------------------------------------------------
# Cross-seed aggregation (experiments subsystem: per-seed confidence bands)
# ---------------------------------------------------------------------------
def ci95(values: Sequence[float]) -> Dict[str, Optional[float]]:
    """Mean with a normal-approximation 95 % confidence half-width.

    For n == 1 the half-width is 0 (a single seed pins the point estimate,
    the band collapses); empty input yields all-None."""
    vals = [v for v in values if v is not None]
    if not vals:
        return {"mean": None, "lo": None, "hi": None, "half": None, "n": 0}
    mean = float(np.mean(vals))
    if len(vals) == 1:
        return {"mean": mean, "lo": mean, "hi": mean, "half": 0.0, "n": 1}
    half = 1.96 * float(np.std(vals, ddof=1)) / math.sqrt(len(vals))
    return {"mean": mean, "lo": mean - half, "hi": mean + half,
            "half": half, "n": len(vals)}


#: scalar summary fields worth aggregating across seeds
AGGREGATE_KEYS = ("short_qd_mean", "short_rps", "long_jct_mean",
                  "long_starved_frac", "preemptions", "gpu_idle_rate",
                  "short_slowdown_mean", "long_slowdown_mean",
                  "decode_preemptions", "role_flips",
                  "prefix_hit_rate", "prefill_flops_saved",
                  "ttft_mean", "tpot_mean", "goodput", "slo_shed",
                  "busy_overflow_s",
                  "reclaims", "evacuated_blocks", "restarted_requests",
                  "joins")


def aggregate_seeds(summaries: Iterable[Dict],
                    keys: Sequence[str] = AGGREGATE_KEYS) -> Dict[str, Dict]:
    """Aggregate per-seed summaries into {metric: ci95 dict}; percentile
    dicts aggregate per percentile under '<field>_pct' keys."""
    summaries = list(summaries)
    out: Dict[str, Dict] = {k: ci95([s.get(k) for s in summaries])
                            for k in keys}
    for field in ("short_qd_pct", "short_slowdown_pct", "ttft_pct",
                  "tpot_pct"):
        if any(field in s for s in summaries):
            out[field] = {str(p): ci95([s.get(field, {}).get(str(p))
                                        for s in summaries])
                          for p in PCTS}
    return out

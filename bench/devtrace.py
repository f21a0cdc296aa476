"""The traced run's instruments: spans around the calls into the engines,
recorded from the benchmark's side, and a `torch.profiler` slice of the
window reduced to device busy time, time by kernel and idle time by what
the host was doing.

`Spans` wraps each engine's ``prefill_quantum`` and ``decode_iteration``
(and the calls around them) on the instance.  While a slice is open it
records each call's shapes, so the work of the slice can be counted from
shapes (`model_flops`, `kernels/`), and names the call on the profiler's
timeline (``record_function``), so an idle gap on the device can be put
down to the host call it fell in.  The slice opens and closes between
arrivals, where every engine call has synchronised with the card.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

#: engine methods named on the timeline; the first two also count work
WRAPPED = ("prefill_quantum", "decode_iteration", "start_prefill",
           "prefill_logits", "admit", "evict")
#: what an idle gap outside every engine call is put down to
HOST_OTHER = "host: scheduler, simulator and harness"


class Spans:
    def __init__(self):
        self.active = False
        #: prefill quanta in the slice: (new tokens S, cached P, layers,
        #: logits follow)
        self.quanta: List[Tuple[int, int, int, bool]] = []
        #: decode iterations in the slice: each active lane's cached length
        self.decodes: List[List[int]] = []

    def wrap(self, eng) -> None:
        for name in WRAPPED:
            setattr(eng, name, self._wrapped(eng, name, getattr(eng, name)))

    def _wrapped(self, eng, name, fn):
        def call(*args, **kw):
            if not self.active:
                return fn(*args, **kw)
            if name == "prefill_quantum":
                st = args[0]
                lo, S, P = st.layer, st.x.shape[1], st.prefix_len
            elif name == "decode_iteration":
                lens = eng.slot_lengths()
                self.decodes.append([lens[s] for s in args[0]])
            with torch.profiler.record_function("engine." + name):
                out = fn(*args, **kw)
            if name == "prefill_quantum":
                st = out[0]
                self.quanta.append((S, P, st.layer - lo,
                                    st.layer == eng.cfg.num_layers))
            return out
        return call


def _profiler():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def warm_profiler(device) -> None:
    """Start and stop the profiler once on a trivial op, so the device
    tracer's own start-up (seconds, the first time) falls in set-up and
    not in the slice."""
    p = _profiler()
    p.start()
    torch.ones(8, device=device).sum().item()
    p.stop()


class Slice:
    """One profiled stretch of the window, opened at `start_s` wall seconds
    into it and closed once `length_s` seconds have been traced (checked at
    each arrival)."""

    def __init__(self, spans: Spans, start_s: float, length_s: float):
        self.spans, self.start_s, self.length_s = spans, start_s, length_s
        self.prof = None
        self.t0 = self.t1 = None

    def poll(self, elapsed: float) -> None:
        if self.prof is None and elapsed >= self.start_s:
            self.prof = _profiler()
            self.prof.start()
            self.spans.active = True
            self.t0 = time.perf_counter()
        elif self.t1 is None and self.t0 is not None \
                and time.perf_counter() - self.t0 >= self.length_s:
            self.close()

    def close(self) -> None:
        if self.prof is not None and self.t1 is None:
            self.spans.active = False
            self.t1 = time.perf_counter()
            self.prof.stop()

    def events(self) -> List[Tuple[str, float, float, bool]]:
        """(name, start s, end s, on the device) of every recorded event."""
        if self.prof is None:
            return []
        out = []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            # the device-side twin of a `record_function` range is no work
            dev = (e.device_type() != torch.autograd.DeviceType.CPU
                   and not name.startswith("engine."))
            t0 = (e.start_ns() if hasattr(e, "start_ns")
                  else e.start_us() * 1e3) * 1e-9
            dur = (e.duration_ns() if hasattr(e, "duration_ns")
                   else e.duration_us() * 1e3) * 1e-9
            out.append((name, t0, t0 + dur, dev))
        return out


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(events: List[Tuple[str, float, float, bool]], window_s: float
           ) -> Optional[Dict]:
    """Device busy seconds (the union of device activity), seconds by
    device operation, and idle seconds by the engine call (or none) the
    host was in: None where the slice holds no device activity."""
    dev = [(n, a, b) for n, a, b, d in events if d and b > a]
    if not dev:
        return None
    by_op: Dict[str, float] = defaultdict(float)
    for n, a, b in dev:
        by_op[n] += b - a
    busy = merge([(a, b) for _, a, b in dev])
    host = sorted((a, b, n) for n, a, b, d in events
                  if not d and n.startswith("engine."))
    lo = min(a for _, a, _, _ in events)
    hi = max(b for _, _, b, _ in events)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    idle: Dict[str, float] = defaultdict(float)
    j = 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        while j < len(host) and host[j][1] < mid:
            j += 1
        name = host[j][2] if j < len(host) and host[j][0] <= mid else HOST_OTHER
        idle[name] += b - a
    top = lambda d: [[k, v] for k, v in sorted(d.items(),  # noqa: E731
                                               key=lambda kv: -kv[1])[:10]]
    return {"busy_s": sum(b - a for a, b in busy), "window_s": window_s,
            "by_op": dict(by_op), "device_ops": top(by_op),
            "idle_gaps": top(idle)}

"""Spans and counters: where the host's time goes inside the engines, the
backend and the simulator.

A `Tracer` keeps totals only, always on: per span name the calls
(``name:n``), the host nanoseconds (``name:ns``), the nanoseconds outside
the spans opened inside it (``name:self_ns``) and the nanoseconds spent in
``wait`` spans inside it, its own included (``name:wait_ns``).  A ``wait``
span times the host blocked on the card: a readback, a synchronise, a copy
from pageable host memory (which waits for the stream to drain).  Counters
(`count`) share the same table, `stats`, which `EngineBackend.stats` is.

A span opened with ``record=True`` also asks the tracer's `ranges` hook for
a profiler range of its name.  The serving layer installs the hook
(serving/engine.py): it opens a range while a `torch.profiler` session is
active, and only then builds the span's attributes (request ids, shapes)
from its ``args`` callable.  With no hook, or no profiler active, no range
is entered and no attribute is built; this module imports no torch.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Callable, List, Optional

_now = time.perf_counter_ns


class _Span:
    __slots__ = ("tracer", "keys", "wait", "rf", "frame", "t0")

    def __init__(self, tracer, keys, wait, rf):
        self.tracer, self.keys, self.wait, self.rf = tracer, keys, wait, rf

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        self.frame = [0, 0]                 # child ns, wait ns inside
        self.tracer._open.append(self.frame)
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        dt = _now() - self.t0
        tr = self.tracer
        tr._open.pop()
        child, wait = self.frame
        tr._total(self.keys, 1, dt, dt - child, dt if self.wait else wait)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class Tracer:
    """Span totals and counters of one backend (see the module docstring).
    Spans nest on one stack, so they are opened from one thread: the
    backend's (gang ranks' threads open none)."""

    def __init__(self):
        #: counters and span totals, keyed ``name`` and ``name:<field>``
        self.stats: Counter = Counter()
        #: the open spans' frames (child ns, wait ns inside), under a root
        #: frame that collects the spans opened at the top
        self._open: List[List[int]] = [[0, 0]]
        self._keys = {}
        #: ``ranges(name, args)`` -> a profiler range to enter, or None (no
        #: profiler active); None here until the serving layer installs one
        self.ranges: Optional[Callable] = None

    def _keys_of(self, name: str) -> tuple:
        keys = self._keys.get(name)
        if keys is None:
            keys = self._keys[name] = tuple(
                f"{name}:{f}" for f in ("n", "ns", "self_ns", "wait_ns"))
        return keys

    def _total(self, keys, n: int, ns: int, self_ns: int, wait: int) -> None:
        parent = self._open[-1]
        parent[0] += ns
        parent[1] += wait
        n_key, ns_key, self_key, wait_key = keys
        s = self.stats
        s[n_key] += n
        s[ns_key] += ns
        s[self_key] += self_ns
        s[wait_key] += wait

    def span(self, name: str, *, wait: bool = False, record: bool = False,
             args: Optional[Callable[[], dict]] = None) -> _Span:
        """Time a block as span `name` (``with tracer.span(...):``).
        `wait`: the block waits for the card.  `record`: also a profiler
        range where `ranges` gives one, its trace args what `args()`
        returns (called only then)."""
        ranges = self.ranges
        rf = ranges(name, args) if record and ranges is not None else None
        return _Span(self, self._keys_of(name), wait, rf)

    def inner_ns(self) -> int:
        """Nanoseconds of the spans closed so far directly inside the
        innermost open span (or at the top): read before and after a block
        the caller times itself, the difference is the spans inside it."""
        return self._open[-1][0]

    def add(self, name: str, ns: int, self_ns: int, n: int = 1) -> None:
        """Add `n` blocks the caller timed itself to span `name`'s totals:
        spans without a context manager, for a loop as hot as the
        simulator's (the spans inside them from `inner_ns`)."""
        # the spans inside them closed into the frame around them already
        self._open[-1][0] -= ns - self_ns
        self._total(self._keys_of(name), n, ns, self_ns, 0)

    def count(self, name: str, n: int = 1) -> None:
        self.stats[name] += n

    def seconds(self, name: str, field: str = "ns") -> float:
        """Total seconds of span `name`: its ``ns``, ``self_ns`` or
        ``wait_ns``."""
        return self.stats[f"{name}:{field}"] * 1e-9

    def reset(self) -> None:
        """Clear every total and counter (spans still open carry on)."""
        self.stats.clear()

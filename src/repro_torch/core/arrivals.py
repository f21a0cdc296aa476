"""Arrival-time processes for workload generation.

The paper replays a single Azure-style stream with Poisson arrivals (§3.1,
§6.2); related schedulers (CascadeInfer, Tail-Aware Scheduling) are evaluated
under bursty and heavy-tailed regimes as well. This module factors the
arrival process out of trace generation so every scenario can pick one:

    poisson   homogeneous Poisson — exponential i.i.d. interarrivals
    gamma     gamma-renewal — interarrival CV is a free parameter; cv > 1
              clusters arrivals (heavy-tailed gaps), cv < 1 smooths them
    mmpp      2-state Markov-modulated Poisson (quiet/burst) — the standard
              burstiness model: exponential sojourns in each state, a higher
              Poisson rate while in the burst state
    diurnal   non-homogeneous Poisson with a sinusoidal rate (day/night
              cycle compressed to a simulation-friendly period)

All processes take (n, rate, rng) and return a sorted float64 array of n
arrival times starting near 0; `rate` is the LONG-RUN mean arrival rate
(requests/sec), so scenarios stay comparable at equal offered load.
Determinism: every draw goes through the caller's `rng`.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

ARRIVAL_PROCESSES: Dict[str, Callable] = {}


def register_arrival(name: str) -> Callable:
    def deco(fn: Callable) -> Callable:
        ARRIVAL_PROCESSES[name] = fn
        return fn
    return deco


def make_arrivals(process: str, n: int, rate: float,
                  rng: np.random.Generator, **params) -> np.ndarray:
    """Dispatch to a registered arrival process; validates the result."""
    if process not in ARRIVAL_PROCESSES:
        raise ValueError(f"unknown arrival process {process!r}; "
                         f"have {sorted(ARRIVAL_PROCESSES)}")
    if n <= 0:
        return np.empty(0, dtype=np.float64)
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate}")
    out = np.asarray(ARRIVAL_PROCESSES[process](n, rate, rng, **params),
                     dtype=np.float64)
    assert out.shape == (n,) and np.all(np.diff(out) >= 0.0)
    return out


@register_arrival("poisson")
def poisson_arrivals(n: int, rate: float, rng: np.random.Generator
                     ) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / rate, n))


@register_arrival("gamma")
def gamma_arrivals(n: int, rate: float, rng: np.random.Generator, *,
                   cv: float = 2.5) -> np.ndarray:
    """Gamma-renewal process: mean interarrival 1/rate, coefficient of
    variation `cv`. cv=1 degenerates to Poisson; cv>1 gives heavy-tailed
    gaps (long lulls punctuated by clumps of arrivals)."""
    shape = 1.0 / (cv * cv)
    scale = cv * cv / rate
    return np.cumsum(rng.gamma(shape, scale, n))


@register_arrival("mmpp")
def mmpp_arrivals(n: int, rate: float, rng: np.random.Generator, *,
                  burst_factor: float = 8.0, burst_frac: float = 0.15,
                  mean_cycle: float = 60.0) -> np.ndarray:
    """2-state MMPP. The process alternates quiet/burst states with
    exponential sojourns; `burst_frac` of time is spent bursting at
    `burst_factor` x the quiet rate. Quiet rate is solved so the long-run
    mean equals `rate`:  (1-f)*r0 + f*B*r0 = rate.

    Within each sojourn we draw the arrival count ~ Poisson(r*dur) and place
    the arrivals as uniform order statistics — exactly a Poisson process
    conditioned on its count, and vectorised (no per-arrival Python loop).
    """
    if not 0.0 < burst_frac < 1.0:
        raise ValueError("burst_frac must be in (0,1)")
    r_quiet = rate / ((1.0 - burst_frac) + burst_frac * burst_factor)
    r_burst = burst_factor * r_quiet
    soj = {False: mean_cycle * (1.0 - burst_frac),
           True: mean_cycle * burst_frac}
    out: List[np.ndarray] = []
    total, t, burst = 0, 0.0, False
    while total < n:
        dur = rng.exponential(soj[burst])
        r = r_burst if burst else r_quiet
        k = rng.poisson(r * dur)
        if k:
            out.append(np.sort(rng.uniform(t, t + dur, k)))
            total += k
        t += dur
        burst = not burst
    return np.concatenate(out)[:n]


@register_arrival("diurnal")
def diurnal_arrivals(n: int, rate: float, rng: np.random.Generator, *,
                     period: float = 600.0, depth: float = 0.8,
                     phase: float = 0.0) -> np.ndarray:
    """Non-homogeneous Poisson with rate lambda(t) = rate * (1 + depth *
    sin(2 pi t / period + phase)), generated by thinning against the peak
    rate in vectorised chunks. `period` is the full day/night cycle in
    simulated seconds (compressed from 24 h so a 20 K-request trace spans
    several cycles); `depth` in [0,1) is the peak-to-mean swing."""
    if not 0.0 <= depth < 1.0:
        raise ValueError("depth must be in [0,1)")
    lam_max = rate * (1.0 + depth)
    out: List[np.ndarray] = []
    total, t = 0, 0.0
    while total < n:
        m = int((n - total) * (1.0 + depth) * 1.5) + 64
        cand = t + np.cumsum(rng.exponential(1.0 / lam_max, m))
        lam = rate * (1.0 + depth * np.sin(2 * np.pi * cand / period + phase))
        acc = cand[rng.random(m) * lam_max <= lam]
        out.append(acc)
        total += len(acc)
        t = cand[-1]
    return np.concatenate(out)[:n]

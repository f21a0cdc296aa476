"""The benchmark's traffic: one general generator that reads a mix's data file
(``traffic/<name>.json``) and a cell's rate (``workloads/<cell>.json``).

`azure_trace` is a frozen copy of the port's ``core/trace.generate_trace``
with Poisson arrivals (``core/arrivals.poisson_arrivals``): the paper's §6.2
mix, lognormal inputs and outputs with the top quantile of inputs made long.
It draws a fixed POPULATION from the mix file's own seed, so every run seed
serves the same set of sizes and inter-arrival gaps.  The run's ``--seed``
only orders them: `run_requests` shuffles sizes and gaps within consecutive
blocks of the population, so any prefix of whole blocks holds the same
multiset of requests and the same total arrival time for every seed.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

def trace_params(mix: Dict) -> Dict:
    """A mix file's population as the frozen generator's parameters (the
    medians become the lognormals' mu)."""
    return {"n_requests": int(mix["population"]), "arrival_rps": 1.0,
            "input_mu": float(np.log(mix["input_median"])),
            "input_sigma": float(mix["input_sigma"]),
            "input_max": int(mix["input_max"]),
            "input_min": int(mix["input_min"]),
            "output_mu": float(np.log(mix["output_median"])),
            "output_sigma": float(mix["output_sigma"]),
            "output_max": int(mix["output_max"]),
            "long_quantile": float(mix["long_quantile"]),
            "long_low": int(mix["long_low"]),
            "long_high": int(mix["long_high"]),
            "seed": int(mix["population_seed"])}


def azure_trace(p: Dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """(input lengths, output lengths, is_long, arrival times): the same draws
    in the same order as ``generate_trace(TraceConfig(**p))`` with the
    Poisson process and scale 1."""
    rng = np.random.default_rng(p["seed"])
    n = p["n_requests"]
    inputs = np.clip(rng.lognormal(p["input_mu"], p["input_sigma"], n),
                     p["input_min"], p["input_max"]).astype(np.int64)
    outputs = np.clip(rng.lognormal(p["output_mu"], p["output_sigma"], n),
                      1, p["output_max"]).astype(np.int64)
    if p["long_quantile"] >= 1.0:
        is_long = np.zeros(n, dtype=bool)
    else:
        k = max(int(round(n * (1.0 - p["long_quantile"]))), 1)
        order = np.lexsort((rng.random(n), inputs))
        is_long = np.zeros(n, dtype=bool)
        is_long[order[-k:]] = True
        inputs[is_long] = rng.integers(p["long_low"], p["long_high"] + 1, k)
    arrivals = np.cumsum(rng.exponential(1.0 / p["arrival_rps"], n))
    return inputs, outputs, is_long, arrivals


def seed_rng(seed: int, *salt: int) -> np.random.Generator:
    """A numpy generator from any whole-number seed (negative or past 64
    bits included) and a salt."""
    return np.random.default_rng([seed & (2 ** 64 - 1), int(seed < 0), *salt])


def run_requests(mix: Dict, rate: float, seed: int):
    """The run's request stream as (input_len, output_len, is_long, arrival)
    tuples on the cluster clock, in arrival order, at `rate` requests per
    cluster second: the mix's population, shuffled by `seed` within blocks
    of ``mix["block"]`` requests (sizes and gaps each by their own
    permutation)."""
    ins, outs, longs, arr = azure_trace(trace_params(mix))
    gaps = np.diff(arr, prepend=0.0)
    n, b = len(ins), int(mix["block"])
    rng = seed_rng(seed, 0x7261)
    size_order = np.concatenate([lo + rng.permutation(min(b, n - lo))
                                 for lo in range(0, n, b)])
    gap_order = np.concatenate([lo + rng.permutation(min(b, n - lo))
                                for lo in range(0, n, b)])
    times = np.cumsum(gaps[gap_order]) / rate
    for i, j in enumerate(size_order):
        yield int(ins[j]), int(outs[j]), bool(longs[j]), float(times[i])


class Prompts:
    """The benchmark's token provider: request `rid`'s prompt is drawn from
    (seed, rid); a long runs `max_prompt` tokens, a short its trace length
    capped at `max_prompt`.  Kept per rid, so the check reads the very
    prompts the engines served."""

    def __init__(self, seed: int, vocab: int, max_prompt: int):
        self.seed, self.vocab, self.max_prompt = seed, vocab, max_prompt
        self.tokens: Dict[int, np.ndarray] = {}

    def length(self, input_len: int, is_long: bool) -> int:
        return self.max_prompt if is_long else min(input_len, self.max_prompt)

    def __call__(self, req) -> np.ndarray:
        t = self.tokens.get(req.rid)
        if t is None:
            n = self.length(req.input_len, req.is_long)
            t = seed_rng(self.seed, 0x70, req.rid).integers(
                0, self.vocab, n).astype(np.int32)
            self.tokens[req.rid] = t
        return t

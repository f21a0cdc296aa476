"""Arithmetic on the requests' stamps (cluster seconds): which requests
failed, and the percentiles and rates the end-to-end metrics report."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile, linearly interpolated between order statistics
    (numpy's default); None for no values."""
    return float(np.percentile(np.asarray(values, float), q)) if len(values) \
        else None


def stamps_in_order(r) -> bool:
    """arrival <= prefill_start <= first_token <= finish, all stamped."""
    s = (r.arrival, r.prefill_start, r.first_token, r.finish)
    return None not in s and s[0] <= s[1] <= s[2] <= s[3]


def target_tokens(max_new: int):
    """A request's target count of served tokens: its output length capped
    at the configuration's ``max_new``, and at least one."""
    return lambda r: max(1, min(max_new, r.output_len))


def failures(requests, generated: Dict[int, List[int]], target, vocab: int
             ) -> Dict[str, int]:
    """Requests that did not complete with their target count of
    in-vocabulary tokens, or whose stamps are out of order, by cause (a
    request counts once, under its first cause)."""
    out = {"unfinished": 0, "token_count": 0, "out_of_vocab": 0,
           "stamps": 0}
    for r in requests:
        toks = generated.get(r.rid)
        if r.finish is None or toks is None:
            out["unfinished"] += 1
        elif len(toks) != target(r):
            out["token_count"] += 1
        elif any(not 0 <= t < vocab for t in toks):
            out["out_of_vocab"] += 1
        elif not stamps_in_order(r):
            out["stamps"] += 1
    return out


def shorts(requests):
    return [r for r in requests if not r.is_long]


def short_qd_s(requests) -> List[float]:
    return [r.prefill_start - r.arrival for r in shorts(requests)
            if r.prefill_start is not None]


def short_ttft_s(requests) -> List[float]:
    return [r.first_token - r.arrival for r in shorts(requests)
            if r.first_token is not None]


def long_jct_s(requests) -> List[float]:
    return [r.finish - r.arrival for r in requests
            if r.is_long and r.finish is not None]


def shorts_done_by(requests, t: float) -> int:
    return sum(1 for r in shorts(requests)
               if r.finish is not None and r.finish <= t)


def summary(values: Sequence[float]) -> Dict[str, Optional[float]]:
    """Mean and a few percentiles, for the run's log."""
    return {"n": len(values),
            "mean": float(np.mean(values)) if len(values) else None,
            **{f"p{q}": percentile(values, q) for q in (50, 75, 90, 95)}}

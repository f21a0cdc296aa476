"""Azure-LLM-inference-style trace generation (paper §3.1 / §6.2).

The 2024 Azure trace has a highly skewed long-tail input-length distribution
(~80 % of requests < 2 K tokens, frequency decreasing with length, max ~9 K)
and output lengths of tens-to-hundreds of tokens (< 800). Following §6.2 we
resample the inputs above the 95th percentile uniformly from [100 K, 500 K]
to model long-input workloads (IR / book summarization), keep outputs
unchanged, and draw arrivals from a pluggable arrival process (arrivals.py;
Poisson by default, matching the paper).

Real Azure-trace-format CSV files (AzurePublicDataset LLM inference traces:
TIMESTAMP, ContextTokens, GeneratedTokens) load via `load_trace_csv`;
`save_trace_csv` writes the same format for round-tripping synthetic traces.
"""
from __future__ import annotations

import csv
import re
from dataclasses import dataclass
from datetime import datetime, timezone
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.arrivals import make_arrivals
from repro_torch.core.request import Request


@dataclass(frozen=True)
class TraceConfig:
    n_requests: int = 20000
    arrival_rps: float = 10.0          # long-run mean arrival rate
    # arrival process name (arrivals.py registry) + kwargs as a tuple of
    # (key, value) pairs so the config stays frozen/hashable
    arrival_process: str = "poisson"
    arrival_params: Tuple[Tuple[str, float], ...] = ()
    # body: lognormal fitted so P(len < 2000) ~= 0.80, clipped to trace max 9K
    input_mu: float = float(np.log(500.0))
    input_sigma: float = 1.6
    input_max: int = 9000
    input_min: int = 16
    output_mu: float = float(np.log(150.0))
    output_sigma: float = 0.9
    output_max: int = 800
    long_quantile: float = 0.95        # §6.2: above 95th pct -> long
    long_low: int = 100_000
    long_high: int = 500_000
    seed: int = 0
    scale: float = 1.0                 # uniformly shrink lengths (CPU tests)


def generate_trace(cfg: TraceConfig) -> List[Request]:
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_requests
    inputs = np.clip(rng.lognormal(cfg.input_mu, cfg.input_sigma, n),
                     cfg.input_min, cfg.input_max).astype(np.int64)
    outputs = np.clip(rng.lognormal(cfg.output_mu, cfg.output_sigma, n),
                      1, cfg.output_max).astype(np.int64)
    if cfg.long_quantile >= 1.0:          # short-only trace (calibration)
        is_long = np.zeros(n, dtype=bool)
    else:
        # top-(1-q) by rank (random tie-break — clipping at input_max creates
        # ties that would otherwise inflate the long fraction)
        k = max(int(round(n * (1.0 - cfg.long_quantile))), 1)
        order = np.lexsort((rng.random(n), inputs))
        is_long = np.zeros(n, dtype=bool)
        is_long[order[-k:]] = True
        inputs[is_long] = rng.integers(cfg.long_low, cfg.long_high + 1, k)
    arrivals = make_arrivals(cfg.arrival_process, n, cfg.arrival_rps, rng,
                             **dict(cfg.arrival_params))
    if cfg.scale != 1.0:
        inputs = np.maximum((inputs * cfg.scale).astype(np.int64), 1)
        outputs = np.maximum((outputs * cfg.scale).astype(np.int64), 1)
    return [Request(rid=i, arrival=float(arrivals[i]),
                    input_len=int(inputs[i]), output_len=int(outputs[i]),
                    is_long=bool(is_long[i]))
            for i in range(n)]


# ---------------------------------------------------------------------------
# Real-trace CSV I/O (AzurePublicDataset LLM inference format)
# ---------------------------------------------------------------------------
# header aliases, lowercased: canonical field -> accepted column names
_CSV_ALIASES = {
    "timestamp": ("timestamp", "arrival", "arrival_time", "time"),
    "input": ("contexttokens", "context_tokens", "input_len", "input_tokens",
              "prompt_tokens", "input"),
    "output": ("generatedtokens", "generated_tokens", "output_len",
               "output_tokens", "completion_tokens", "output"),
}
# optional columns (multi-tenant / chat scenarios round-trip through these)
_CSV_OPTIONAL = {
    "tenant": ("tenant", "tenantid", "tenant_id", "customer"),
    "session": ("session", "sessionid", "session_id", "conversation_id"),
}


def _epoch_utc(dt: datetime) -> float:
    # Azure trace datetimes are UTC-naive; pinning them avoids local-timezone
    # (and DST-step) distortion of intra-trace gaps
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp()


def _parse_timestamp(raw: str) -> float:
    """Seconds as float, or an ISO-8601 datetime (Azure traces use the
    latter); datetimes become absolute epoch seconds — callers re-zero."""
    try:
        return float(raw)
    except ValueError:
        pass
    iso = raw.strip().replace("Z", "+00:00")
    try:
        return _epoch_utc(datetime.fromisoformat(iso))
    except ValueError:
        # Azure traces carry 7-digit fractional seconds ('...:28.0340000');
        # Python <= 3.10 fromisoformat only accepts 3 or 6 digits
        m = re.match(r"(.*?\.\d{1,6})\d*([+-].*)?$", iso)
        if m:
            return _epoch_utc(datetime.fromisoformat(
                m.group(1) + (m.group(2) or "")))
        raise


def load_trace_csv(path: Union[str, Path], *,
                   long_threshold: int = 100_000,
                   time_scale: float = 1.0,
                   max_requests: Optional[int] = None) -> List[Request]:
    """Load an Azure-trace-format CSV into Request objects.

    Columns are matched case-insensitively against common aliases
    (TIMESTAMP/ContextTokens/GeneratedTokens and friends). Timestamps may be
    float seconds or ISO-8601 datetimes; they are shifted to start at 0 and
    multiplied by `time_scale` (use < 1 to compress a day-long trace).
    Requests with input_len >= `long_threshold` are flagged long — the §6.2
    resampled traces place longs at >= 100 K tokens.

    Optional Tenant/Session columns (written by `save_trace_csv` for tagged
    traces) round-trip into `Request.tenant` / `Request.session`; a malformed
    row raises ValueError naming the file, the 1-based data row, and the
    offending cell instead of a bare int() traceback.
    """
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None:
            raise ValueError(f"{path}: empty CSV")
        cols = {}
        for canon, aliases in _CSV_ALIASES.items():
            for name in reader.fieldnames:
                if name.strip().lower() in aliases:
                    cols[canon] = name
                    break
            if canon not in cols:
                raise ValueError(
                    f"{path}: no column for {canon!r} "
                    f"(accepted: {aliases}; have {reader.fieldnames})")
        for canon, aliases in _CSV_OPTIONAL.items():
            for name in reader.fieldnames:
                if name.strip().lower() in aliases:
                    cols[canon] = name
                    break
        rows = []
        for lineno, row in enumerate(reader, start=1):
            try:
                ts = _parse_timestamp(row[cols["timestamp"]])
                inp = int(float(row[cols["input"]]))
                out = int(float(row[cols["output"]]))
                session = None
                if "session" in cols and (row[cols["session"]] or "").strip():
                    session = int(float(row[cols["session"]]))
            except (ValueError, TypeError, KeyError) as e:
                raise ValueError(
                    f"{path}: malformed row {lineno}: {dict(row)!r} ({e})"
                ) from e
            tenant = (row[cols["tenant"]].strip() or None
                      if "tenant" in cols and row[cols["tenant"]] is not None
                      else None)
            rows.append((ts, inp, out, tenant, session))
    if not rows:
        return []
    # sort BEFORE truncating: max_requests means "the earliest N requests",
    # even when the file itself is not time-ordered
    rows.sort(key=lambda r: r[0])
    if max_requests is not None:
        rows = rows[:max_requests]
    t0 = rows[0][0]
    return [Request(rid=i, arrival=(t - t0) * time_scale,
                    input_len=max(inp, 1), output_len=max(out, 1),
                    is_long=inp >= long_threshold,
                    tenant=tenant, session=session)
            for i, (t, inp, out, tenant, session) in enumerate(rows)]


def save_trace_csv(reqs: List[Request], path: Union[str, Path]) -> None:
    """Write requests in the canonical Azure columns; round-trips with
    `load_trace_csv` (is_long is re-derived from the length threshold).
    Tenant/Session columns are appended when any request carries those tags
    (multi_tenant / chat_multiturn scenarios), so tagged traces survive the
    round trip too; untagged traces keep the bare 3-column Azure format."""
    tagged = any(r.tenant is not None or r.session is not None for r in reqs)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        header = ["TIMESTAMP", "ContextTokens", "GeneratedTokens"]
        if tagged:
            header += ["Tenant", "Session"]
        w.writerow(header)
        for r in sorted(reqs, key=lambda r: r.arrival):
            row = [f"{r.arrival:.6f}", r.input_len, r.output_len]
            if tagged:
                row += [r.tenant or "",
                        "" if r.session is None else r.session]
            w.writerow(row)


def trace_stats(reqs: List[Request]) -> dict:
    ins = np.array([r.input_len for r in reqs])
    outs = np.array([r.output_len for r in reqs])
    longs = np.array([r.is_long for r in reqs])
    return {
        "n": len(reqs),
        "frac_under_2k": float((ins[~longs] < 2000).mean()) if (~longs).any() else 0.0,
        "frac_long": float(longs.mean()),
        "input_p50": float(np.percentile(ins[~longs], 50)),
        "input_p99": float(np.percentile(ins[~longs], 99)),
        "output_p50": float(np.percentile(outs, 50)),
        "output_max": int(outs.max()),
        "long_min": int(ins[longs].min()) if longs.any() else 0,
        "long_max": int(ins[longs].max()) if longs.any() else 0,
    }

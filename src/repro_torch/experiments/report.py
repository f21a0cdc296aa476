"""Claims ledger rendering: markdown for humans, JSON for machines.

`render_markdown` produces the EXPERIMENTS.md-style ledger table;
`write_report` emits `claims_report.json`, the artifact the CI
claims-smoke job uploads and downstream tooling diffs across PRs.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.experiments.claims import CLAIMS, ClaimResult
from repro_torch.experiments.spec import SCHEMA_VERSION

REPORT_SCHEMA = 1


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "—"
    if v == 0:
        return "0"
    if abs(v) >= 1000 or abs(v) < 0.01:
        return f"{v:.2e}"
    return f"{v:.3g}"


def render_markdown(results: Sequence[ClaimResult]) -> str:
    """One row per claim id; backends collapse into per-backend value cells
    so the sim/engine pair reads side by side."""
    by_cid: Dict[str, List[ClaimResult]] = {}
    for r in results:
        by_cid.setdefault(r.cid, []).append(r)
    lines = [
        "| claim | paper ref | expression | bound | sim | engine | status |",
        "|---|---|---|---|---|---|---|",
    ]
    for cid, rs in by_cid.items():
        claim = CLAIMS.get(cid)
        expr = claim.metric_expr if claim else "?"
        per = {r.backend: r for r in rs}
        op = "≥" if rs[0].direction == "ge" else "≤"
        if len({r.bound for r in rs}) > 1:
            bound = " / ".join(f"{op} {_fmt(r.bound)} ({r.backend})"
                               for r in rs)
        else:
            bound = f"{op} {_fmt(rs[0].bound)}"

        def cell(b: str) -> str:
            r = per.get(b)
            if r is None:
                return "n/a"
            if r.skipped:
                return f"skip ({r.skipped})"
            return _fmt(r.value)

        evaluated = [r for r in rs if not r.skipped]
        status = "PASS" if evaluated and all(r.passed for r in evaluated) \
            else ("SKIP" if not evaluated else "**FAIL**")
        lines.append(f"| `{cid}` | {rs[0].paper_ref} | `{expr}` | {bound} "
                     f"| {cell('sim')} | {cell('engine')} | {status} |")
    return "\n".join(lines)


def summarize_results(results: Sequence[ClaimResult]) -> Dict:
    evaluated = [r for r in results if not r.skipped]
    return {
        "n_claims": len({r.cid for r in results}),
        "n_evaluated": len(evaluated),
        "n_passed": sum(r.passed for r in evaluated),
        "n_failed": sum(not r.passed for r in evaluated),
        "n_skipped": len(results) - len(evaluated),
        "failed": sorted({(r.cid, r.backend) for r in evaluated
                          if not r.passed}),
        "backends": sorted({r.backend for r in evaluated}),
    }


def write_report(results: Sequence[ClaimResult], json_path,
                 md_path=None, meta: Optional[Dict] = None) -> Dict:
    """Write claims_report.json (+ optional markdown ledger); returns the
    report dict."""
    report = {
        "report_schema": REPORT_SCHEMA,
        "spec_schema": SCHEMA_VERSION,
        "meta": meta or {},
        "summary": summarize_results(results),
        "results": [r.to_dict() for r in results],
    }
    json_path = Path(json_path)
    json_path.parent.mkdir(parents=True, exist_ok=True)
    json_path.write_text(json.dumps(report, indent=1, default=float))
    if md_path is not None:
        Path(md_path).write_text(render_markdown(results) + "\n")
    return report

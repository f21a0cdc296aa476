"""Readings that set the check's limit (``workloads/<cell>.json``): the
program's widest served-token gap over a dozen seeds or more, and the
control's (the reference in fp8, `reference/dense.py`, put in the program's
place by ``run.serve(control=True)``) on some of them, all in one process
with a short window at the cell's own rate.  A control run goes through the
harness's own comparison and has to come out not correct.

    python3 bench/limits.py --workload mistral_7b.azure_overload \\
        --seeds 101,102,103 --control 2 --seconds 15 --out limits.jsonl

The lower reading is the largest program gap, the upper the smallest
control gap; PERF.md gives both for each limit.
"""
from __future__ import annotations

import argparse
import json
import sys

import run


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="read the control on the first N seeds")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rehearse", type=int, default=0)
    a = ap.parse_args()
    rows = []
    for i, seed in enumerate(int(s) for s in a.seeds.split(",")):
        res = run.serve(a.workload, seed, a.seconds, False,
                        rehearse=bool(a.rehearse), control=i < a.control)
        info = res["info"]
        ctl = "program_gap" in info
        row = {"workload": a.workload, "seed": seed,
               "served_gap": info["program_gap" if ctl else "served_gap"],
               "control_gap": info["served_gap"] if ctl else None,
               "correct": res["correct"], "tokens": info["tokens"],
               "cover": info["check_cover"], "failed": res["failed"],
               "attempted": res["attempted"], "check_s": info["check_s"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    ctl = [r["control_gap"] for r in rows if r["control_gap"] is not None]
    print(json.dumps({"workload": a.workload, "seeds": len(rows),
                      "lower": max(r["served_gap"] for r in rows),
                      "upper": min(ctl) if ctl else None,
                      "control_correct": [r["correct"] for r in rows
                                          if r["control_gap"] is not None]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

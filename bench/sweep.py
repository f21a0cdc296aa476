"""The knee sweep: a cell's mix at a ladder of Poisson rates, one window
each, with no check.  The knee is the highest rate at which the backlog of
shorts waiting for prefill or decode does not grow across the window; the
cells' rates (``workloads/<cell>.json``) were set from it once, on the card.

    python3 bench/sweep.py --workload mistral_7b.azure_overload \\
        --rates 10,20,30 --seconds 20 --seed 5 --out sweep.jsonl
"""
from __future__ import annotations

import argparse
import json
import sys

import run


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rehearse", type=int, default=0)
    a = ap.parse_args()
    for rate in (float(r) for r in a.rates.split(",")):
        res = run.serve(a.workload, a.seed, a.seconds, False, rate=rate,
                        rehearse=bool(a.rehearse), run_check=False)
        i = res["info"]
        row = {"workload": a.workload, "rate": rate,
               "arrivals": i["arrivals"], "longs": i["longs"],
               "window_cluster_s": i["window_cluster_s"],
               "wall_per_cluster_s": i["window_wall_s"]
               / max(i["window_cluster_s"] or 1e-9, 1e-9),
               "shorts_done_per_s": i["shorts_done_in_window"]
               / max(i["window_cluster_s"] or 1e-9, 1e-9),
               "backlog_mean_halves": i["backlog_mean_halves"],
               "drain_wall_s": i["drain_wall_s"],
               "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
        print(json.dumps(row), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

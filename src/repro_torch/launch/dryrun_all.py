"""The full dry-run matrix, the counterpart of the reference's
``launch/dryrun_all.py``: every (arch x shape x production mesh) combo
through `dryrun.run_combo`, one JSON record each under
``build/dryrun_torch/``, and the reference's OK / SKIP / FAIL lines.

One process runs them all: a meta mesh holds no process-global device
count, so no combo needs a process of its own (the reference starts one
per combo for its 512 forced XLA devices).  Exits 1 on any FAIL.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--archs ...]
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES
from repro_torch.launch.dryrun import OUT, run_logged


def run_matrix(archs: Sequence[str] = ARCH_IDS, *, out_dir: Optional[Path] = OUT,
               log=print) -> List[Dict]:
    """Every combo's record, in (arch, shape, single pod, multi-pod) order."""
    return [run_logged(arch, shape, multi_pod=mp, out_dir=out_dir, log=log)
            for arch in archs for shape in INPUT_SHAPES for mp in (False, True)]


def summary(recs: List[Dict]) -> Dict[str, int]:
    ok = sum(1 for r in recs if r.get("ok"))
    skip = sum(1 for r in recs if r.get("skipped"))
    return {"ok": ok, "skipped": skip, "failed": len(recs) - ok - skip}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="*", default=ARCH_IDS)
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    recs = run_matrix(args.archs, out_dir=Path(args.out))
    n = summary(recs)
    print(f"done: {n['ok']} ok, {n['skipped']} skipped, {n['failed']} failed "
          f"in {time.perf_counter() - t0:.1f}s")
    return 1 if n["failed"] else 0


if __name__ == "__main__":
    raise SystemExit(main())

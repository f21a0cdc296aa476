"""The benchmark's CPU tests import its modules by their own names, as
``bench/run.py`` does, and the port from ``src/``."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (BENCH.parent / "src", BENCH):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

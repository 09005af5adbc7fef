"""Run one cell of the benchmark once; see ``benchport/__init__.py``.

    python benchport/run.py --workload star-team --seed 7 --seconds 10 --trace 0
"""

import time

T_PROC0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from benchport import harness

    sys.exit(harness.run(sys.argv[1:], root=ROOT, t_proc0=T_PROC0))

"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with one CUDA card.  The last line of
standard output is the run's result (JSON); the numbers that decided
``correct``, each beside its limit, are the last lines of standard
error.  See ``portbench/harness.py``.
"""
import time

T0 = time.perf_counter()

import sys                                   # noqa: E402
from pathlib import Path                     # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness               # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t0=T0))

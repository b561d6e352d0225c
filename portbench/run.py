"""Run one cell of the benchmark once and print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics (a profiled slice
follows the measured window).  Both check the outputs against the plain
reference and print each compared number beside its limit, as the last
lines of standard error and under ``checks``, the last key of the line.
The run exits with 2, and prints no result, without the GPUs the cell
asks for, and with 3 when a module of JAX or of the JAX package was
loaded.  The libraries the port uses are kept from loading JAX
(``core/guard.environment``); the host's allocator and thread pools keep
their defaults.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.core.guard import environment  # noqa: E402

for _k, _v in environment().items():
    os.environ.setdefault(_k, _v)

from portbench.core import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))

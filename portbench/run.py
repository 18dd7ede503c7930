"""Run one cell of the port's benchmark on this machine's card.

    python portbench/run.py --workload star2d_r2.rollout --seed 7 \\
        --seconds 10 --trace 0

From the root of a checkout: the port is imported from its ``src/``.
Prints one JSON object as the last line of standard output, and each
number compared beside its limit as the last lines of standard error.
Exits with another code than 0, printing no result, without the CUDA
devices the cell needs.
"""
import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
_ROOT = _HERE.parent
# the package is imported by its name, never this folder as a top level
sys.path[:] = [str(_ROOT), str(_ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != _HERE]

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))

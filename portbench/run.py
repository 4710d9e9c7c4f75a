"""Run one cell of the benchmark once:

    python3 portbench/run.py --workload grouped_k5.ols --seed 1 --seconds 10 --trace 0

The result is the last line of standard output (one JSON object); the
numbers that decide ``correct`` are the last lines of standard error.
Exits non-zero, with no result, without enough CUDA devices.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return harness.main(ap.parse_args(argv), T_START)


if __name__ == "__main__":
    sys.exit(main())

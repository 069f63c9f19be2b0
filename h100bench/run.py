"""The benchmark of kantts_tpu_torch on the card: one run of one cell.

    python3 h100bench/run.py --workload CELL --seed N --seconds S --trace 0|1

The last line of standard output is the result (JSON); the numbers the
correctness check compared, each beside its limit, are the last lines of
standard error. Without as many CUDA devices as the cell asks for, it
exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, the folder itself would shadow modules of the same names
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    from h100bench import harness

    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())

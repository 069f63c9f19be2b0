"""The readings that a cell's limits are set from: for each seed, the
program's checked numbers and the control's (the reference in the
program's place, in the precision below the configuration's), read in
one process with a short window at the cell's own load.

    python3 h100bench/readings.py --workload CELL --seconds S --seeds N [N ...]
        [--no-control | --fault NAME]

One JSON line per seed and side: {"seed", "timed", "readings" (every
number the check reads, compared or not), "metrics"};
with ``--fault`` the program alone, with that fault of ``faults.py``.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--no-control", action="store_true")
    parser.add_argument("--fault", default=None,
                        help="read the program with this fault of faults.py planted")
    args = parser.parse_args(argv)
    import torch

    from h100bench import harness
    from h100bench.faults import FAULTS

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    harness.set_cache_dirs()
    torch.set_num_threads(harness.THREADS)
    sides = ("program",) if args.no_control else ("program", "control")
    prepare = None
    if args.fault:
        spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
        traffic = next(w["traffic"] for w in spec["workloads"]
                       if w["name"] == args.workload)
        path = harness.load_json(os.path.join(HERE, "traffic", f"{traffic}.json"))["path"]
        prepare, sides = FAULTS[path][args.fault], ("program",)
    for seed in args.seeds:
        for timed in sides:
            r = harness.run_cell(args.workload, seed, args.seconds, False,
                                 torch.device("cuda", 0), time.perf_counter(),
                                 timed=timed, prepare=prepare)
            print(json.dumps({"seed": seed, "timed": args.fault or timed,
                              "readings": r["readings"], "metrics": r["metrics"]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

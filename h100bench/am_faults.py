"""Faults planted under the AM training path (``paths/am_train.py``): the
check must come out not correct under each. Each sets ``cell.wrap``, which
the cell applies to its timed call in set-up; the timed call takes one
collated batch.

    python3 h100bench/am_faults.py --workload CELL --seconds S --seeds N [N ...] --fault NAME

reads the program with that fault planted, one JSON line a seed, as
``readings.py --fault`` does for the other paths.
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

import torch  # noqa: E402


def half_batch(cell):
    """Half of the batch left out, the means taken over the rest."""
    def wrap(steps):
        def call(batch):
            n = len(batch["valid_input_lengths"]) // 2
            return steps({k: None if v is None else v[:n] for k, v in batch.items()})
        return call
    cell.wrap = wrap


def state_unchanged(cell):
    """A step that returns its state unchanged: the weights put back."""
    def wrap(steps):
        def call(batch):
            params = list(steps.params()["model"].values())
            saved = [p.detach().clone() for p in params]
            out = steps(batch)
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
            return out
        return call
    cell.wrap = wrap


def path_flipped(cell):
    """One cell of K1's hard path flipped where it is produced: item 0's
    cell at its middle frame and that frame's token, taken off the path."""
    from kantts_tpu_torch.models.sambert import sambert

    def flipped(mas_align):
        def align(attn, in_lens, out_lens):
            path = mas_align(attn, in_lens, out_lens).clone()
            row = int(out_lens[0]) // 2
            path[0, 0, row, int(path[0, 0, row].argmax())] = 0.0
            return path
        return align

    def wrap(steps):
        def call(batch):
            original = sambert.mas_align
            sambert.mas_align = flipped(original)
            try:
                return steps(batch)
            finally:
                sambert.mas_align = original
        return call
    cell.wrap = wrap


def leaf_frozen(cell):
    """The postnet LSTM's weights given no gradient, as a frozen submodule
    would be: the losses and every other leaf's gradient stay as they were."""
    def wrap(steps):
        for name, p in steps.params()["model"].items():
            if name.startswith("mel_postnet.lstm."):
                p.requires_grad_(False)
        return steps
    cell.wrap = wrap


FAULTS = {"half_batch": half_batch, "state_unchanged": state_unchanged,
          "path_flipped": path_flipped, "leaf_frozen": leaf_frozen}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--fault", required=True, choices=sorted(FAULTS))
    args = parser.parse_args(argv)
    from h100bench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    harness.set_cache_dirs()
    torch.set_num_threads(harness.THREADS)
    for seed in args.seeds:
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             torch.device("cuda", 0), time.perf_counter(),
                             prepare=FAULTS[args.fault])
        print(json.dumps({"seed": seed, "timed": args.fault, "readings": r["readings"],
                          "metrics": r["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

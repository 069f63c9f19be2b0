"""The SAM-BERT + MAS train step by phase and by part of the model, on the
card, from the program's own spans.

    python3 tools/am_step_spans.py --seed N [--seconds S] [--out FILE]

Builds the benchmark's ``voice16k_mas.am_train_b32`` cell (the port's
``make_sambert_step(with_mas=True)`` at its published B=32, seeded weights
and corpus), runs it untraced for ``--seconds`` (steps a second), then
traces about three seconds of further steps as the benchmark's traced run
does (``Cell.profile``: with the host's activity, then the device's alone),
and reads the trace with the host's. It prints one
JSON line: ``spans``, ``phase_cover``, ``blocking``, ``idle_gaps`` as
``tools/gan_step_spans.py`` reads them, for every ``kantts.am.*`` span;
``k1_launches`` (K1's own count over the host-traced steps);
``untraced_steps_per_s`` and ``traced_steps_per_s``; ``span_off_ns`` (one
span entered and left with no profiler) and ``spans_per_step``.
"""

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(ROOT))

from gan_step_spans import per_call_ns, read  # noqa: E402
from h100bench import harness  # noqa: E402
from h100bench.paths.am_train import Cell  # noqa: E402
from kantts_tpu_torch.utils import profiling  # noqa: E402

CELL = "voice16k_mas.am_train_b32"


def measure(cell: Cell, seconds: float) -> dict:
    try:
        cell.setup()
        cell.window(seconds)
        out = {"untraced_steps_per_s": cell.n_steps / cell.window_s}
        tr = cell.profile(3.0).host
        n = cell.traced_steps
        out.update(traced_steps=n, traced_steps_per_s=n / tr.window_s,
                   k1_launches=cell.k1_launches[0],
                   **read(tr, n, profiling.AM_STEP, profiling.AM_PHASES, "kantts.am."))
        return out
    finally:
        cell.cleanup()


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    device = torch.device("cuda", 0)
    harness.set_cache_dirs()
    torch.set_num_threads(harness.THREADS)
    spec = harness.load_json(os.path.join(os.path.dirname(ROOT), "BENCHMARK.json"))
    entry = next(w for w in spec["workloads"] if w["name"] == CELL)
    bench = os.path.join(os.path.dirname(ROOT), "h100bench")
    cfg = harness.load_json(os.path.join(bench, "configs", f"{entry['config']}.json"))
    mix = harness.load_json(os.path.join(bench, "traffic", f"{entry['traffic']}.json"))
    harness.set_precision(cfg)
    out = {"card": torch.cuda.get_device_name(device),
           "power_limit_w": harness.power_limit_w(),
           **measure(Cell(cfg, mix, args.seed, device), args.seconds)}
    out["span_off_ns"] = per_call_ns(profiling.span, 1_000_000)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The GAN step by phase and by network forward, on the card, from the
program's own spans.

    python3 tools/gan_step_spans.py --seed N [--seconds S] [--out FILE]

Builds the benchmark's ``voice16k_mas.gan_train_b16`` cell (the port's
``make_gan_step`` at 16 x 9600, seeded weights and corpus), runs it
untraced for ``--seconds`` (steps a second), then traces about three
seconds of further steps with the host's activity (``h100bench/devtrace.py``)
and prints one JSON line:

- ``spans``: for every ``kantts.gan.*`` span, each a step: its regions,
  its host ms, the device ms in which a kernel, copy or memset launched
  inside it (on any thread) ran, their summed durations (``kernel_ms``:
  more, where cuDNN runs kernels side by side), its launches and the
  device's idle ms under it;
- ``phase_cover``: the least share of a step span that its phase spans
  cover; ``blocking``: the host-blocking calls inside the steps;
- ``idle_gaps``: idle by the innermost host region, as the benchmark's
  ``breakdown`` names it;
- ``traced_steps_per_s`` (the host-traced window's) and
  ``untraced_steps_per_s``;
- ``span_off_ns`` and ``record_function_ns``: one span entered and left
  with no profiler, through ``utils/profiling.span`` and through
  ``torch.profiler.record_function``; ``spans_per_step``.
"""

import argparse
import bisect
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from h100bench import devtrace, harness, stepspan  # noqa: E402
from h100bench.paths.gan_train import Cell  # noqa: E402
from kantts_tpu_torch.utils import profiling  # noqa: E402

CELL = "voice16k_mas.gan_train_b16"


def per_call_ns(fn, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        pass
    base = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        with fn(profiling.GAN_STEP):
            pass
    return (time.perf_counter() - t0 - base) / n * 1e9


def idle_in(gaps, ends, a: float, b: float) -> float:
    """Idle us of the sorted, disjoint ``gaps`` (``ends``: their ends)
    inside [a, b]."""
    total, k = 0.0, bisect.bisect_right(ends, a)
    while k < len(gaps) and gaps[k][0] < b:
        total += min(gaps[k][1], b) - max(gaps[k][0], a)
        k += 1
    return total


def read(tr: devtrace.Trace, n_steps: int) -> dict:
    """The span table of a host trace of ``n_steps`` steps ({} where the
    program opens no step span)."""
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in tr.host
                   if e["name"] == profiling.GAN_STEP)
    if not steps:
        return {}
    edges = [tr.t0] + [x for iv in tr.busy_intervals for x in iv] + [tr.t1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    ends = [b for _, b in gaps]
    names = sorted({e["name"] for e in tr.host if e["name"].startswith("kantts.gan.")})
    spans = {}
    for name in names:
        s = stepspan.Steps(tr, name)
        regions = [(e["ts"], e["ts"] + e["dur"]) for e in tr.host if e["name"] == name]
        spans[name] = {
            "regions_per_step": s.n / n_steps,
            "host_ms": sum(b - a for a, b in regions) / 1e3 / n_steps,
            "device_ms": s.device_ms() * s.n / n_steps,
            "kernel_ms": sum(b - a for a, b in s.intervals()) / 1e3 / n_steps,
            "launches": s.launches() * s.n / n_steps,
            "idle_ms": sum(idle_in(gaps, ends, a, b) for a, b in regions) / 1e3 / n_steps,
        }
    phases = [(e["ts"], e["ts"] + e["dur"]) for e in tr.host
              if e["name"] in profiling.GAN_PHASES]
    cover = min(sum(b - a for a, b in phases if s0 <= a and b <= s1) / (s1 - s0)
                for s0, s1 in steps)
    inside = sum(1 for e in tr.host if e["name"].startswith("kantts.")
                 and any(s0 <= e["ts"] <= s1 for s0, s1 in steps))
    return {"spans": spans, "phase_cover": cover,
            "blocking": stepspan.Steps(tr, profiling.GAN_STEP).blocking(),
            "idle_gaps": tr.idle_gaps(20), "spans_per_step": inside / len(steps),
            "window_busy_s": tr.busy_s, "window_s": tr.window_s}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    device = torch.device("cuda", 0)
    harness.set_cache_dirs()
    torch.set_num_threads(harness.THREADS)
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = next(w for w in spec["workloads"] if w["name"] == CELL)
    cfg = harness.load_json(os.path.join(ROOT, "h100bench", "configs", f"{entry['config']}.json"))
    mix = harness.load_json(os.path.join(ROOT, "h100bench", "traffic", f"{entry['traffic']}.json"))
    harness.set_precision(cfg)
    cell = Cell(cfg, mix, args.seed, device)
    try:
        cell.setup()
        cell.window(args.seconds)
        out = {"card": torch.cuda.get_device_name(device),
               "power_limit_w": harness.power_limit_w(),
               "untraced_steps_per_s": cell.n_steps / cell.window_s}
        n = max(3, int(3.0 * cell.n_steps / cell.window_s))
        wall = []

        def run() -> None:
            t0 = time.perf_counter()
            for _ in range(n):
                with torch.profiler.record_function(devtrace.CALL_SPAN):
                    cell.timed(*next(cell.batches))
            with torch.profiler.record_function(devtrace.CALL_SPAN):
                cell.sync()
            wall.append(time.perf_counter() - t0)
        tr = devtrace.profile(run, cell.sync, host=True)
        out.update(traced_steps=n, traced_steps_per_s=n / wall[-1], **read(tr, n))
    finally:
        cell.cleanup()
    out["span_off_ns"] = per_call_ns(profiling.span, 1_000_000)
    out["record_function_ns"] = per_call_ns(torch.profiler.record_function, 100_000)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

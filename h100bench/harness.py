"""One run of one cell of ``BENCHMARK.json``, and its result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration, traffic mix and metrics; ``configs/<config>.json``
holds the configuration as it is run, ``traffic/<mix>.json`` the mix's
parameters (its ``path`` names the driver, ``paths/<path>.py``),
``workloads/<cell>.json`` the limits of the correctness check, and
``layer_metrics/<metric>.py`` the reader of each per-layer metric.

A run: set-up (weights from the seed, traffic from the seed, a warm-up
call of every shape the traffic sends), the measured window, with
``--trace 1`` a traced window of a few more calls, then the program is
freed and what the window produced is held against the plain reference.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "kantts_tpu")
PROFILE_SECONDS = 3.0
THREADS = 4


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``kantts_tpu_torch`` is not ``kantts_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str):
    path = os.path.join(HERE, "layer_metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    build = os.path.join(ROOT, "build", "h100bench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip())
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def set_precision(cfg: dict) -> None:
    """The configuration's float32 math; cuDNN picks its algorithms by
    heuristics (no autotuning), as the port does."""
    set_tf32(cfg["tf32"])
    torch.backends.cudnn.benchmark = False


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, timed: str = "program",
             spec: Optional[dict] = None, cfg: Optional[dict] = None,
             mix: Optional[dict] = None,
             prepare: Optional[Callable[[object], None]] = None) -> dict:
    """The result of one run, as ``main`` prints it. ``timed="control"``
    puts the reference, in the precision below the configuration's, in
    the program's place. ``spec``, ``cfg`` and ``mix`` replace the files',
    and ``prepare(cell)`` runs before the set-up: the tests run tiny
    voices on the CPU and break the timed path with it (``cell.wrap``)."""
    spec = spec or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = next(w for w in spec["workloads"] if w["name"] == name)
    cfg = cfg or load_json(os.path.join(HERE, "configs", f"{entry['config']}.json"))
    mix = mix or load_json(os.path.join(HERE, "traffic", f"{entry['traffic']}.json"))
    limits = load_json(os.path.join(HERE, "workloads", f"{name}.json"))["limits"]
    set_precision(cfg)
    driver = importlib.import_module(f"h100bench.paths.{mix['path']}")
    cell = driver.Cell(cfg, mix, seed, device)
    if timed == "control":
        cell.use_control()
    if prepare is not None:
        prepare(cell)
    try:
        return _run(cell, name, spec, cfg, mix, limits, seconds, trace, device, t0)
    finally:
        cell.cleanup()


def _run(cell, name, spec, cfg, mix, limits, seconds, trace, device, t0) -> dict:
    cuda = device.type == "cuda"
    phases = {"start": time.perf_counter() - t0}
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)
        phases["cuda_init"] = time.perf_counter() - t0 - phases["start"]
    cell.setup()
    e2e = cell.window(seconds)
    setup_s = cell.t_start - t0
    phases.update(getattr(cell, "phases", {}))
    phases["other"] = setup_s - sum(phases.values())
    print("[setup] " + " ".join(f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
    if cuda:
        torch.cuda.synchronize(device)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics: Dict[str, dict] = {}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak,
           "power_limit_w": power_limit_w() if cuda else None}
    breakdown = None
    if not trace:
        for m in spec["end_to_end"]:
            if applies(m, name):
                value = setup_s if m["name"] == "setup_s" else e2e[m["name"]]
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        tr = cell.profile(PROFILE_SECONDS)
        ctx = SimpleNamespace(cell=cell, trace=tr, cfg=cfg, mix=mix)
        for m in spec["per_layer"]:
            if applies(m, name):
                value = reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = tr.device.busy_s, tr.device.window_s
        breakdown = {"device_ops": tr.device.top_device_ops(),
                     "idle_gaps": tr.host.idle_gaps()}
    cell.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, failed = {}, 0
    readings = cell.check()
    for key, limit in limits.items():
        failed += sum(v > limit for v in readings[key])
        checks[key] = {"value": max(readings[key]), "limit": limit}
    result = {"correct": failed == 0 and bool(checks), "attempted": cell.attempted(),
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # every reading the check made, the compared ones and the others
    # (``readings.py`` prints them; ``main`` leaves them out of the line)
    result["readings"] = {k: max(v) for k, v in readings.items()}
    result["readings"].update(getattr(cell, "notes", {}))
    result["checks"] = checks
    return result


def main(args, t0: float) -> int:
    set_cache_dirs()
    torch.set_num_threads(THREADS)
    spec = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"the cell needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), t0, spec=spec)
    except Exception:  # the run's boundary: report and fail without a result
        traceback.print_exc()
        return 1
    del result["readings"]
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

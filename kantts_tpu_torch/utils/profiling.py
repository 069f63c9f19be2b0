"""Tracing and timing tools (counterpart of ``kantts_tpu/utils/profiling.py``).

``trace`` records a region with ``torch.profiler`` and writes a Chrome
trace; ``timed`` wall-clocks a region up to the end of the device work it
queued; ``rtf_report`` is a copy of the JAX package's. The JAX package's
``start_profiler_server`` (a server that TensorBoard's profile plugin
captures from) has no PyTorch counterpart: take a ``trace`` instead.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

import torch


def start_profiler_server(port: int = 9999) -> None:
    """Not ported: PyTorch has no profiler server to capture from."""
    raise NotImplementedError(
        "start_profiler_server has no PyTorch counterpart (the JAX package "
        "starts jax.profiler's server); record a region with "
        "kantts_tpu_torch.utils.profiling.trace(log_dir) instead")


def _sync() -> None:
    """Wait for the current CUDA device's work, if CUDA is in use."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record the region with ``torch.profiler`` (CPU activity always, CUDA
    activity where there is a card) and write its Chrome trace,
    ``log_dir/trace_<pid>_<ns>.json``; the trace's path is ``prof.path``
    after the block. Yields the profiler, whose ``key_averages()`` sum the
    region by operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.path)
    logging.info("[trace] %s", prof.path)


@contextlib.contextmanager
def timed(name: str, results: Optional[dict] = None) -> Iterator[None]:
    """Wall-clock a region. Once CUDA is in use the clock is read after a
    synchronise of the current device at both ends, so the region's time
    holds the device work it queued and none queued before it."""
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    elapsed = time.perf_counter() - t0
    if results is not None:
        results[name] = elapsed
    logging.info("[timed] %s: %.4fs", name, elapsed)


def rtf_report(audio_seconds: float, wall_seconds: float, name: str = "synthesis"
               ) -> dict:
    """Real-time-factor report (parity with the reference's RTF log,
    infer_hifigan.py:132-139)."""
    rtf = wall_seconds / max(audio_seconds, 1e-9)
    report = {
        "name": name,
        "audio_seconds": audio_seconds,
        "wall_seconds": wall_seconds,
        "rtf": rtf,
        "x_realtime": 1.0 / max(rtf, 1e-12),
    }
    logging.info("[RTF] %s: %.2fs audio in %.3fs -> RTF %.5f (%.1fx realtime)",
                 name, audio_seconds, wall_seconds, rtf, report["x_realtime"])
    return report

"""Tracing tools (counterpart of ``kantts_tpu/utils/profiling.py``).

``span`` opens one of the port's named spans: a ``torch.profiler``
record-function region while a profiler records, on the clock of the
kernels it traces, and a shared no-op otherwise. ``trace`` records a
region with ``torch.profiler`` and writes a Chrome trace; ``rtf_report``
is a copy of the JAX package's.

Every span name is listed here once. Names read ``kantts.<layer>.<what>``:

- ``GAN_STEP``: one ``make_gan_step`` step; inside it ``GAN_PHASES``, as
  the step runs them; inside those, ``GAN_GENERATOR`` around each
  generator forward and ``gan_net(family)`` around each discriminator
  family's;
- ``NSF_SOURCE``: the NSF generator's ``source_module`` and each
  ``source_downs`` conv;
- ``train_phase(phase)``: a phase of the trainers' loop (``TRAIN_PHASES``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import ContextManager, Iterator

import torch
from torch.autograd import profiler as _autograd_profiler

GAN_STEP = "kantts.gan.step"
GAN_G_LOSS = "kantts.gan.g_loss"
GAN_G_BACKWARD = "kantts.gan.g_backward"
GAN_G_UPDATE = "kantts.gan.g_update"
GAN_D_REGEN = "kantts.gan.d_regen"
GAN_D_LOSS = "kantts.gan.d_loss"
GAN_D_BACKWARD = "kantts.gan.d_backward"
GAN_D_UPDATE = "kantts.gan.d_update"
GAN_PHASES = (GAN_G_LOSS, GAN_G_BACKWARD, GAN_G_UPDATE, GAN_D_REGEN, GAN_D_LOSS,
              GAN_D_BACKWARD, GAN_D_UPDATE)
GAN_GENERATOR = "kantts.gan.net.generator"
NSF_SOURCE = "kantts.hifigan.nsf_source"
TRAIN_PHASES = ("loader_wait", "device_put", "step", "eval", "save", "log")

_OFF = contextlib.nullcontext()


def gan_net(name: str) -> str:
    """The span of one discriminator family's forward in the GAN step."""
    return f"kantts.gan.net.{name}"


def train_phase(phase: str) -> str:
    """The span of one of the trainers' loop phases."""
    return f"kantts.train.{phase}"


def span(name: str) -> ContextManager:
    """The span ``name``: ``torch.profiler.record_function(name)`` while a
    profiler records, else a shared no-op context (entering a
    record-function region costs microseconds even with no profiler)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


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

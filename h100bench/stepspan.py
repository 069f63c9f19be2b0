"""What the program's own step spans hold in a traced run's host trace.

A step is one region of the program's step span (``kantts.gan.step``,
opened by ``train/steps.py::make_gan_step``). A CUDA runtime or driver call
belongs to a step when it starts inside a step region, on any thread of
the process: the backward's launches come from autograd's own thread. The
device records (kernels, copies, memsets) of a step are those whose
correlation id is a call of the step; the step's device time is the union
of their intervals, since cuDNN runs a grouped conv's kernels side by side
on streams of its own. A traced run of a program that opens
no such span, or a trace with no CUDA activity, gives no ``Steps``.

Blocking calls hold the host until the device has caught up: any
``*Synchronize``, ``cudaMemcpy``, ``cudaFree``, ``cudaFreeHost``, and a
``cudaMemcpyAsync`` whose device record is a copy to or from pageable
memory.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Tuple

from h100bench.devtrace import Trace, _merge

GAN_STEP = "kantts.gan.step"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
BLOCKING = ("cudaMemcpy", "cudaFree", "cudaFreeHost")


def _corr(e: dict):
    return e.get("args", {}).get("correlation")


class Steps:
    def __init__(self, tr: Trace, span: str):
        regions = sorted((e["ts"], e["ts"] + e["dur"]) for e in tr.host
                         if e["name"] == span)
        starts = [a for a, _ in regions]
        self.n = len(regions)
        self.calls: List[dict] = []
        for e in tr.host:
            if e["cat"] in RUNTIME_CATS:
                # one step at a time: the latest start decides
                i = bisect.bisect_right(starts, e["ts"]) - 1
                if i >= 0 and e["ts"] <= regions[i][1]:
                    self.calls.append(e)
        self.records: Dict[object, List[dict]] = collections.defaultdict(list)
        for e in tr.device:
            self.records[_corr(e)].append(e)

    def intervals(self) -> List[Tuple[float, float]]:
        """(start, end) of each device record of the steps' calls."""
        return [(r["ts"], r["ts"] + r["dur"]) for c in self.calls
                for r in self.records.get(_corr(c), ())]

    def device_ms(self) -> float:
        """Device ms a step in which a record of the steps' calls ran."""
        return sum(b - a for a, b in _merge(self.intervals())) / 1e3 / self.n

    def launches(self) -> float:
        """Kernel launches a step."""
        return sum("Launch" in c["name"] for c in self.calls) / self.n

    def blocking(self) -> List[str]:
        """The names of the steps' blocking calls, in the trace's order."""
        out = []
        for c in self.calls:
            name = c["name"]
            pageable = name == "cudaMemcpyAsync" and any(
                "Pageable" in r["name"] for r in self.records.get(_corr(c), ()))
            if "Synchronize" in name or name in BLOCKING or pageable:
                out.append(name)
        return out


def steps(run, span: str = GAN_STEP) -> Optional[Steps]:
    tr = run.trace and run.trace.host
    if tr is None or not tr.launches():
        return None
    s = Steps(tr, span)
    return s if s.n else None

"""Pseudo-QMF multi-band analysis and synthesis filter bank (counterpart of
``kantts_tpu/models/pqmf.py``).

A Kaiser-window low-pass prototype (taps 62, cutoff 0.142, beta 9.0, tuned
for 4 sub-bands) is cosine-modulated into one analysis and one synthesis
filter per band. Both transforms are correlations, as ``F.conv1d`` is:
analysis pads taps // 2 on both sides, filters and keeps every
``subbands``-th sample; synthesis zero-stuffs each band by ``subbands``
with a gain of ``subbands``, then filters and sums the bands. The filters
are fixed buffers, not parameters.

Layout is the generator's, channels last: analysis (B, T, 1) ->
(B, ceil(T / subbands), subbands); synthesis (B, T, subbands) ->
(B, T * subbands, 1).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal.windows import kaiser
from torch import nn


def design_prototype_filter(taps: int = 62, cutoff_ratio: float = 0.142,
                            beta: float = 9.0) -> np.ndarray:
    """The Kaiser-window low-pass prototype h(n), length taps + 1."""
    if taps % 2 != 0 or not 0.0 < cutoff_ratio < 1.0:
        raise ValueError("taps must be even and 0 < cutoff_ratio < 1")
    omega_c = np.pi * cutoff_ratio
    n = np.arange(taps + 1) - 0.5 * taps
    with np.errstate(invalid="ignore"):
        h_i = np.sin(omega_c * n) / (np.pi * n)
    h_i[taps // 2] = cutoff_ratio  # the sinc's limit at n = 0
    return h_i * kaiser(taps + 1, beta)


def pqmf_filters(subbands: int, taps: int, cutoff_ratio: float, beta: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (analysis, synthesis) filters, each (subbands, taps + 1) float32."""
    h_proto = design_prototype_filter(taps, cutoff_ratio, beta)
    n = np.arange(taps + 1)
    h_analysis = np.zeros((subbands, taps + 1))
    h_synthesis = np.zeros((subbands, taps + 1))
    for k in range(subbands):
        phase = (2 * k + 1) * (np.pi / (2 * subbands)) * (n - taps / 2)
        h_analysis[k] = 2 * h_proto * np.cos(phase + (-1) ** k * np.pi / 4)
        h_synthesis[k] = 2 * h_proto * np.cos(phase - (-1) ** k * np.pi / 4)
    return h_analysis.astype(np.float32), h_synthesis.astype(np.float32)


class PQMF(nn.Module):
    def __init__(self, subbands: int = 4, taps: int = 62,
                 cutoff_ratio: float = 0.142, beta: float = 9.0):
        super().__init__()
        self.subbands, self.taps, self.pad = subbands, taps, taps // 2
        h_analysis, h_synthesis = pqmf_filters(subbands, taps, cutoff_ratio, beta)
        # conv1d weights: analysis (S, 1, taps + 1), synthesis (1, S, taps + 1)
        self.register_buffer("analysis_filter",
                             torch.from_numpy(h_analysis)[:, None, :],
                             persistent=False)
        self.register_buffer("synthesis_filter",
                             torch.from_numpy(h_synthesis)[None],
                             persistent=False)

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(F.pad(x.transpose(1, 2), (self.pad, self.pad)),
                     self.analysis_filter)
        return y[:, :, ::self.subbands].transpose(1, 2)

    def synthesis(self, x: torch.Tensor) -> torch.Tensor:
        B, T, S = x.shape
        # zero-stuff each band: sample t moves to t * S, S - 1 zeros follow
        up = F.pad((x * S).transpose(1, 2)[..., None], (0, S - 1)).reshape(B, S, T * S)
        y = F.conv1d(F.pad(up, (self.pad, self.pad)), self.synthesis_filter)
        return y.transpose(1, 2)

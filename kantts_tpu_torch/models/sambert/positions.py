"""Positional encodings for SAM-BERT (counterpart of
``kantts_tpu/models/sambert/positions.py``), with the same layout quirks:

- the sinusoid table encodes positions from 1, with exponent
  i / (d/2 - 1); sin fills the first half of the channels, cos the second;
- the duration encoding interleaves sin/cos over even/odd channels with
  inverse timescales 10000^(2*(i//2)/depth), at each frame's 1-based
  position within its phone.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch


@lru_cache(maxsize=None)
def sinusoid_position_table(n_position: int, d_hid: int) -> np.ndarray:
    """(n_position, d_hid) float32 table; row p encodes position p+1."""
    pos = np.arange(1, n_position + 1, dtype=np.float64)[:, None]
    half = d_hid // 2
    denom = np.power(10000.0, np.arange(half, dtype=np.float64) / float(half - 1))
    angles = pos / denom[None, :]
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, :half] = np.sin(angles)
    table[:, half:] = np.cos(angles)
    return table.astype(np.float32)


def add_sinusoidal_position(x: torch.Tensor, max_len: int = 0) -> torch.Tensor:
    """x (B, T, D) -> x + table[:T]."""
    T, D = x.shape[-2], x.shape[-1]
    table = torch.from_numpy(sinusoid_position_table(max(T, max_len), D)[:T])
    return x + table.to(x.device, x.dtype)[None]


@lru_cache(maxsize=None)
def _dur_inv_timescales(depth: int) -> np.ndarray:
    idx = np.arange(depth)
    return np.power(10000.0, 2 * (idx // 2) / depth).astype(np.float32)


def duration_position_encoding(durations: torch.Tensor, depth: int,
                               out_len: int,
                               masks: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """durations (B, T_in), rounded with floor(d + 0.5) -> (B, out_len,
    depth) encoding of each frame's position within its phone; frames under
    ``masks`` (B, out_len) get position 0."""
    reps = torch.floor(durations.float() + 0.5)
    cums = torch.cumsum(torch.nn.functional.pad(reps, (1, 0)), dim=1)
    rng = torch.arange(out_len, dtype=torch.float32,
                       device=durations.device)[None, :, None]
    mult = ((cums[:, None, :-1] <= rng) & (cums[:, None, 1:] > rng)).float()
    offsets = torch.einsum("bot,bt->bo", mult, cums[:, :-1])
    dur_pos = rng[:, :, 0] - offsets + 1.0
    if masks is not None:
        dur_pos = dur_pos.masked_fill(masks, 0.0)

    inv = torch.from_numpy(_dur_inv_timescales(depth)).to(durations.device)
    ang = dur_pos[:, :, None] / inv[None, None, :]
    out = torch.empty_like(ang)
    out[:, :, 0::2] = torch.sin(ang[:, :, 0::2])
    out[:, :, 1::2] = torch.cos(ang[:, :, 1::2])
    return out

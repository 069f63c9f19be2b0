"""Padding masks (counterpart of ``kantts_tpu/utils/mask.py``)."""

from __future__ import annotations

import torch


def get_mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Boolean padding mask of shape (B, max_len): True where position >=
    length."""
    ids = torch.arange(max_len, device=lengths.device)
    return ids[None, :] >= lengths[:, None]

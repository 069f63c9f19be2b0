"""Monotonic alignment search (MAS, width 1): the plain PyTorch version and
the dispatcher.

``b_mas_torch`` ports the ``lax.scan`` version of
``kantts_tpu/models/sambert/alignment.py`` (a loop over mel frames, then a
backtrack loop, both vectorised over the batch). ``mas_align`` runs it for a
CPU tensor and kernel K1 (``ops/mas.py``) for a CUDA tensor; there is no
fallback between the two. MAS runs on a detached attention map and has no
backward.
"""

from __future__ import annotations

import torch

from kantts_tpu_torch.ops.mas import b_mas_cuda

NEG = -1e30


@torch.no_grad()
def b_mas_torch(attn: torch.Tensor, in_lens: torch.Tensor,
                out_lens: torch.Tensor) -> torch.Tensor:
    """attn (B, 1, T_mel, T_text) soft attention -> same-shape hard 0/1
    alignment. A tie takes column j-1; row 0 is pinned to column 0; rows >=
    out_len and columns >= in_len are zero. Lengths are clamped to the map's
    shape, as in K1. A NaN cell scores NaN (``clamp`` keeps it), and a
    comparison with NaN takes "stay", as the JAX package's ``b_mas`` does."""
    B, _, T_mel, T_text = attn.shape
    a = attn[:, 0].float()
    dev = a.device
    in_l = in_lens.to(dev, torch.long).clamp(0, T_text)
    out_l = out_lens.to(dev, torch.long).clamp(0, T_mel)
    cols = torch.arange(T_text, device=dev)
    col_valid = cols[None, :] < in_l[:, None]  # (B, T_text)
    log_a = torch.where(col_valid[:, None, :], torch.log(a.clamp(min=1e-30)),
                        NEG)

    prev = torch.where(cols[None, :] == 0, log_a[:, 0], NEG)
    neg_col = torch.full((B, 1), NEG, device=dev)
    take = torch.zeros((B, T_mel, T_text), dtype=torch.bool, device=dev)
    for i in range(1, T_mel):
        shifted = torch.cat([neg_col, prev[:, :-1]], dim=1)
        from_left = shifted >= prev
        prev = log_a[:, i] + torch.where(from_left, shifted, prev)
        take[:, i] = from_left

    hard = torch.zeros_like(a)
    col = in_l - 1
    rows = torch.arange(B, device=dev)
    for i in range(T_mel - 1, -1, -1):
        active = (i < out_l) & (col >= 0)
        c = col.clamp(min=0)
        hard[rows, i, c] = active.float()
        if i > 0:
            col = col - (take[rows, i, c] & active).long()
    return hard[:, None]


def mas_align(attn: torch.Tensor, in_lens: torch.Tensor,
              out_lens: torch.Tensor) -> torch.Tensor:
    """Hard alignment of a detached (B, 1, T_mel, T_text) map: K1 for a CUDA
    tensor, ``b_mas_torch`` for a CPU tensor."""
    attn = attn.detach()
    if attn.device.type == "cuda":
        return b_mas_cuda(attn.float().contiguous(),
                          in_lens.to(attn.device, torch.int32).contiguous(),
                          out_lens.to(attn.device, torch.int32).contiguous())
    if attn.device.type == "cpu":
        return b_mas_torch(attn, in_lens, out_lens)
    raise ValueError(f"MAS runs on CPU or CUDA tensors, got {attn.device}")

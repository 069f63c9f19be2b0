"""ConvAttention, the soft mel<->text alignment of MAS training (counterpart
of ``kantts_tpu/models/sambert/attention.py``): conv projections of text keys
and mel queries, similarity -0.0005 * ||q - k||^2, log-softmax plus the
log attention prior, softmax over text."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from kantts_tpu_torch.models.sambert.common import NEG_INF


class ConvNorm(nn.Module):
    """'Same'-padded Conv1d over (B, C, T), named ``conv`` as in KAN-TTS."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size,
                              padding=(kernel_size - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ConvAttention(nn.Module):
    def __init__(self, n_mel_channels: int = 80, n_text_channels: int = 512,
                 n_att_channels: int = 80):
        super().__init__()
        self.key_proj = nn.Sequential(
            ConvNorm(n_text_channels, n_text_channels * 2, 3), nn.ReLU(),
            ConvNorm(n_text_channels * 2, n_att_channels, 1))
        self.query_proj = nn.Sequential(
            ConvNorm(n_mel_channels, n_mel_channels * 2, 3), nn.ReLU(),
            ConvNorm(n_mel_channels * 2, n_mel_channels, 1), nn.ReLU(),
            ConvNorm(n_mel_channels, n_att_channels, 1))

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                attn_prior: Optional[torch.Tensor] = None):
        """queries (B, T_mel, n_mel); keys (B, T_text, n_text); mask (B,
        T_text) True = padding; attn_prior (B, T_mel, T_text). Returns (attn
        (B, 1, T_mel, T_text) softmax over text, attn_logprob same shape)."""
        k = self.key_proj(keys.transpose(1, 2)).transpose(1, 2)
        q = self.query_proj(queries.transpose(1, 2)).transpose(1, 2)
        q2 = (q * q).sum(dim=-1)[:, :, None]
        k2 = (k * k).sum(dim=-1)[:, None, :]
        qk = torch.matmul(q, k.transpose(1, 2))
        attn = -0.0005 * (q2 + k2 - 2.0 * qk)
        if attn_prior is not None:
            attn = torch.log_softmax(attn, dim=-1) + torch.log(attn_prior + 1e-8)
        attn_logprob = attn[:, None]
        if mask is not None:
            attn = attn.masked_fill(mask[:, None, :], NEG_INF)
        return torch.softmax(attn, dim=-1)[:, None], attn_logprob

"""SAM-BERT transformer primitives (counterpart of
``kantts_tpu/models/sambert/common.py``).

Public functions take and return (B, T, C); convolutions transpose to
(B, C, T) around ``F.conv1d`` only. Masks are boolean, True marking padding,
and disallowed attention logits take -1e9 (not -inf) so that padded query
rows stay finite before they are zeroed.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

NEG_INF = -1e9


def torch_linear(in_features: int, out_features: int, bias: bool = True
                 ) -> nn.Linear:
    return nn.Linear(in_features, out_features, bias=bias)


class Conv1dBTC(nn.Conv1d):
    """``nn.Conv1d`` with 'same' padding (odd kernel) applied to (B, T, C)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


def conv1d_same(in_channels: int, out_channels: int, kernel_size: int,
                bias: bool = True) -> Conv1dBTC:
    return Conv1dBTC(in_channels, out_channels, kernel_size,
                     padding=(kernel_size - 1) // 2, bias=bias)


def masked_zero(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero the (B, T, ...) rows where the (B, T) mask is True."""
    if mask is None:
        return x
    return x.masked_fill(mask[..., None], 0.0)


class Prenet(nn.Module):
    """Linear -> ReLU -> Dropout(0.5) per hidden layer, then an optional
    output Linear. ``fcs`` indexes match the KAN-TTS layout (Linear at 0, 3,
    6, ...)."""

    def __init__(self, in_units: int, prenet_units: Sequence[int],
                 out_units: int = 0):
        super().__init__()
        layers = []
        d = in_units
        for units in prenet_units:
            layers += [torch_linear(d, units), nn.ReLU(), nn.Dropout(0.5)]
            d = units
        if out_units:
            layers.append(torch_linear(d, out_units))
        self.fcs = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fcs(x)


def scaled_dot_attention(q, k, v, temperature: float,
                         mask: Optional[torch.Tensor] = None,
                         dropout: Optional[nn.Dropout] = None):
    """q, k, v: (B, H, T, d); mask broadcastable to (B, H, Tq, Tk), True =
    disallowed. Returns (out (B, H, Tq, d), attn (B, H, Tq, Tk))."""
    attn = torch.matmul(q, k.transpose(-1, -2)) / temperature
    if mask is not None:
        attn = attn.masked_fill(mask, NEG_INF)
    attn = torch.softmax(attn, dim=-1)
    if dropout is not None:
        attn = dropout(attn)
    return torch.matmul(attn, v), attn


def split_heads(t: torch.Tensor, n_head: int) -> torch.Tensor:
    B, T, _ = t.shape
    return t.reshape(B, T, n_head, -1).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    B, H, T, D = t.shape
    return t.transpose(1, 2).reshape(B, T, H * D)


class MultiHeadSelfAttention(nn.Module):
    """Pre-LN multi-head self attention with a fused qkv projection."""

    def __init__(self, d_in: int, n_head: int, d_head: int, d_model: int,
                 dropout: float = 0.1, dropatt: float = 0.0):
        super().__init__()
        self.n_head, self.d_head = n_head, d_head
        self.layer_norm = nn.LayerNorm(d_in, eps=1e-6)
        self.w_qkv = torch_linear(d_in, 3 * n_head * d_head)
        self.fc = torch_linear(n_head * d_head, d_model)
        self.drop = nn.Dropout(dropout)
        self.dropatt = nn.Dropout(dropatt)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None):
        """x (B, T, d_in); key_mask (B, T) True = padding key."""
        residual = x
        q, k, v = self.w_qkv(self.layer_norm(x)).chunk(3, dim=-1)
        mask = key_mask[:, None, None, :] if key_mask is not None else None
        out, attn = scaled_dot_attention(
            split_heads(q, self.n_head), split_heads(k, self.n_head),
            split_heads(v, self.n_head), math.sqrt(self.d_head), mask,
            self.dropatt)
        out = self.drop(self.fc(merge_heads(out)))
        if out.shape[-1] == residual.shape[-1]:
            out = out + residual
        return out, attn


class PositionwiseConvFeedForward(nn.Module):
    """Pre-LN conv FFN: conv(k0) -> ReLU -> conv(k1), residual."""

    def __init__(self, d_model: int, d_inner: int,
                 kernel_sizes: Sequence[int] = (3, 1),
                 dropout_inner: float = 0.1, dropout: float = 0.1):
        super().__init__()
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-6)
        self.w_1 = conv1d_same(d_model, d_inner, kernel_sizes[0])
        self.w_2 = conv1d_same(d_inner, d_model, kernel_sizes[1])
        self.dropout_inner = nn.Dropout(dropout_inner)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        h = torch.relu(self.w_1(self.layer_norm(x)))
        h = self.dropout_inner(masked_zero(h, mask))
        return self.dropout(self.w_2(h)) + x


class FFTBlock(nn.Module):
    """Self-attention + conv FFN block."""

    def __init__(self, d_in: int, d_model: int, n_head: int, d_head: int,
                 d_inner: int, kernel_sizes: Sequence[int] = (3, 1),
                 dropout: float = 0.1, dropout_attn: float = 0.0,
                 dropout_relu: float = 0.0):
        super().__init__()
        self.slf_attn = MultiHeadSelfAttention(d_in, n_head, d_head, d_model,
                                               dropout, dropout_attn)
        self.pos_ffn = PositionwiseConvFeedForward(
            d_model, d_inner, kernel_sizes, dropout_relu, dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        out, attn = self.slf_attn(x, mask)
        out = self.pos_ffn(masked_zero(out, mask), mask)
        return masked_zero(out, mask), attn

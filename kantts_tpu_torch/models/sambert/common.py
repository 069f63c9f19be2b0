"""SAM-BERT transformer primitives (counterpart of
``kantts_tpu/models/sambert/common.py``).

Public functions take and return (B, T, C); convolutions transpose to
(B, C, T) around ``F.conv1d`` only. Masks are boolean, True marking padding,
and disallowed attention logits take -1e9 (not -inf) so that padded query
rows stay finite before they are zeroed.

Mixed precision follows the JAX package site by site: a layer built with a
compute ``dtype`` (bf16) casts its input and weight to it and adds its bias
after the product in it, as flax's ``Dense`` and ``Conv`` do; parameters
stay float32. LayerNorm runs in float32 on a float32 copy of its input,
attention scores and softmax run in float32 and the weighted sum in v's
dtype, and a residual sum is cast back to the residual's dtype.

Tensor parallelism (``parallel/tp.py``): the attention and FFN modules here
and in ``pnca.py`` and ``fsmn.py`` name their column-parallel layers
(``TP_COL``: output features split, q/k/v chunks each split head-aligned)
and row-parallel ones (``TP_ROW``: input features split) and the count that
is split (``tp_units``: heads or inner channels). Once sharded, ``tp`` holds
the model group; the input of each column layer passes ``copy_to_model``
and the partial products of the row layers are summed by
``reduce_from_model`` before their bias is added, once (under bf16 in
float32 by ``reduced_partials``, so that each product is rounded once,
after the sum). Without it
(``tp`` None) they compute exactly as before.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from kantts_tpu_torch.parallel.tp import ModelParallel, copy_to_model, reduce_from_model
from kantts_tpu_torch.utils.precision import Dtype, add_bias

NEG_INF = -1e9


def compute_dtype(cfg) -> Dtype:
    """The transformer stacks' compute dtype of SAM-BERT params:
    ``compute_dtype: bfloat16`` gives bf16, absent or ``float32`` None."""
    return {None: None, "float32": None,
            "bfloat16": torch.bfloat16}[cfg.get("compute_dtype")]


class Linear(nn.Linear):
    """``nn.Linear`` with an optional compute dtype (see the module doc)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: Dtype = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return self.add_bias(self.partial(x))

    def partial(self, x: torch.Tensor, float32_sum: bool = False) -> torch.Tensor:
        """The product without the bias, in the compute dtype; with
        ``float32_sum`` its products of the operands rounded to the compute
        dtype, summed and returned in float32 (``reduced_partials``)."""
        dt = self.compute_dtype
        if dt is None:
            return F.linear(x, self.weight)
        x, w = x.to(dt), self.weight.to(dt)
        return F.linear(x.float(), w.float()) if float32_sum else F.linear(x, w)

    def add_bias(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.bias is None else y + self.bias.to(y.dtype)


def torch_linear(in_features: int, out_features: int, bias: bool = True,
                 dtype: Dtype = None) -> Linear:
    return Linear(in_features, out_features, bias, dtype)


class Conv1dBTC(nn.Conv1d):
    """``nn.Conv1d`` with 'same' padding (odd kernel) applied to (B, T, C),
    with an optional compute dtype (see the module doc)."""

    def __init__(self, *args, compute_dtype: Dtype = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x).transpose(1, 2)
        y = F.conv1d(x.to(dt), self.weight.to(dt), None, self.stride,
                     self.padding, self.dilation, self.groups)
        return add_bias(y, self.bias).transpose(1, 2)

    def partial(self, x: torch.Tensor, float32_sum: bool = False) -> torch.Tensor:
        """The convolution without the bias, in the compute dtype, (B, T, C);
        ``float32_sum`` as ``Linear.partial``."""
        dt = self.compute_dtype
        x, w = (x, self.weight) if dt is None else (x.to(dt), self.weight.to(dt))
        if dt is not None and float32_sum:
            x, w = x.float(), w.float()
        return F.conv1d(x.transpose(1, 2), w, None, self.stride, self.padding,
                        self.dilation, self.groups).transpose(1, 2)

    def add_bias(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.bias is None else y + self.bias.to(y.dtype)


def reduced_partials(pairs, tp: ModelParallel) -> List[torch.Tensor]:
    """The partial products of bf16 row-parallel ``(layer, x)`` pairs, each
    layer holding its slice of the input features, summed over the model
    group in one collective, each then in bf16. A rank's share is the
    float32 sum of the rounded operands' products (``partial(x,
    float32_sum=True)``), so each whole product is rounded to bf16 once,
    after the sum, as the unsharded layer rounds it; summing bf16 shares
    would round twice. The all-reduce then moves float32: twice the bytes of
    bf16 shares."""
    parts = [layer.partial(x, float32_sum=True) for layer, x in pairs]
    summed = (reduce_from_model(parts[0], tp)[None] if len(parts) == 1
              else reduce_from_model(torch.stack(parts), tp))
    return [y.to(layer.compute_dtype) for y, (layer, _) in zip(summed, pairs)]


def row_parallel(layer, x: torch.Tensor, tp: Optional[ModelParallel]) -> torch.Tensor:
    """``layer(x)`` (a ``Linear`` or ``Conv1dBTC``); sharded (``tp``), its
    partial product is summed over the model group (under bf16 by
    ``reduced_partials``) and the bias, which every rank holds whole, is
    added after."""
    if tp is None:
        return layer(x)
    if layer.compute_dtype is None:
        return layer.add_bias(reduce_from_model(layer.partial(x), tp))
    return layer.add_bias(reduced_partials([(layer, x)], tp)[0])


def conv1d_same(in_channels: int, out_channels: int, kernel_size: int,
                bias: bool = True, dtype: Dtype = None) -> Conv1dBTC:
    return Conv1dBTC(in_channels, out_channels, kernel_size,
                     padding=(kernel_size - 1) // 2, bias=bias, compute_dtype=dtype)


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
    disallowed. Returns (out (B, H, Tq, d), attn (B, H, Tq, Tk) float32):
    scores and softmax in float32, the weighted sum in v's dtype."""
    attn = torch.matmul(q, k.transpose(-1, -2)).float() / temperature
    if mask is not None:
        attn = attn.masked_fill(mask, NEG_INF)
    attn = torch.softmax(attn, dim=-1)
    if dropout is not None:
        attn = dropout(attn)
    return torch.matmul(attn.to(v.dtype), v), attn


def split_heads(t: torch.Tensor, n_head: int) -> torch.Tensor:
    B, T, _ = t.shape
    return t.reshape(B, T, n_head, -1).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    B, H, T, D = t.shape
    return t.transpose(1, 2).reshape(B, T, H * D)


class MultiHeadSelfAttention(nn.Module):
    """Pre-LN multi-head self attention with a fused qkv projection. Sharded,
    ``n_head`` is this rank's heads."""

    TP_COL = {"w_qkv": 3}  # layer -> its chunks (q, k, v), each split by head
    TP_ROW = ("fc",)

    def __init__(self, d_in: int, n_head: int, d_head: int, d_model: int,
                 dropout: float = 0.1, dropatt: float = 0.0, dtype: Dtype = None):
        super().__init__()
        self.n_head, self.d_head = n_head, d_head
        self.tp: Optional[ModelParallel] = None
        self.layer_norm = nn.LayerNorm(d_in, eps=1e-6)
        self.w_qkv = torch_linear(d_in, 3 * n_head * d_head, dtype=dtype)
        self.fc = torch_linear(n_head * d_head, d_model, dtype=dtype)
        self.drop = nn.Dropout(dropout)
        self.dropatt = nn.Dropout(dropatt)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None):
        """x (B, T, d_in); key_mask (B, T) True = padding key."""
        residual = x
        h = copy_to_model(self.layer_norm(x.float()), self.tp)
        q, k, v = self.w_qkv(h).chunk(3, dim=-1)
        mask = key_mask[:, None, None, :] if key_mask is not None else None
        out, attn = scaled_dot_attention(
            split_heads(q, self.n_head), split_heads(k, self.n_head),
            split_heads(v, self.n_head), math.sqrt(self.d_head), mask,
            self.dropatt)
        out = self.drop(row_parallel(self.fc, merge_heads(out), self.tp))
        if out.shape[-1] == residual.shape[-1]:
            out = (out + residual).to(residual.dtype)
        return out, attn

    def tp_units(self) -> int:
        return self.n_head


class PositionwiseConvFeedForward(nn.Module):
    """Pre-LN conv FFN: conv(k0) -> ReLU -> conv(k1), residual. Sharded, each
    rank holds a slice of the inner channels."""

    TP_COL = {"w_1": 1}
    TP_ROW = ("w_2",)

    def __init__(self, d_model: int, d_inner: int,
                 kernel_sizes: Sequence[int] = (3, 1),
                 dropout_inner: float = 0.1, dropout: float = 0.1,
                 dtype: Dtype = None):
        super().__init__()
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-6)
        self.w_1 = conv1d_same(d_model, d_inner, kernel_sizes[0], dtype=dtype)
        self.w_2 = conv1d_same(d_inner, d_model, kernel_sizes[1], dtype=dtype)
        self.dropout_inner = nn.Dropout(dropout_inner)
        self.dropout = nn.Dropout(dropout)
        self.tp: Optional[ModelParallel] = None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        h = torch.relu(self.w_1(copy_to_model(self.layer_norm(x.float()), self.tp)))
        h = self.dropout_inner(masked_zero(h, mask))
        return (self.dropout(row_parallel(self.w_2, h, self.tp)) + x).to(x.dtype)

    def tp_units(self) -> int:
        return self.w_1.out_channels


class FFTBlock(nn.Module):
    """Self-attention + conv FFN block."""

    def __init__(self, d_in: int, d_model: int, n_head: int, d_head: int,
                 d_inner: int, kernel_sizes: Sequence[int] = (3, 1),
                 dropout: float = 0.1, dropout_attn: float = 0.0,
                 dropout_relu: float = 0.0, dtype: Dtype = None):
        super().__init__()
        self.slf_attn = MultiHeadSelfAttention(d_in, n_head, d_head, d_model,
                                               dropout, dropout_attn, dtype)
        self.pos_ffn = PositionwiseConvFeedForward(
            d_model, d_inner, kernel_sizes, dropout_relu, dropout, dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        out, attn = self.slf_attn(x, mask)
        out = self.pos_ffn(masked_zero(out, mask), mask)
        return masked_zero(out, mask), attn

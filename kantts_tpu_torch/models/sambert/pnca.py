"""PNCA (pseudo-non-causal attention) mel decoder (counterpart of
``kantts_tpu/models/sambert/pnca.py``).

Each decoder step runs two banded attentions from the same queries: over the
decoder's own history (keys j in [t - x_band_width, t]) and over the
length-regulated encoder memory (keys j in [t, t + h_band_width]).

- Training runs one teacher-forced pass with (T, T) band masks.
- Inference (``pnca_decoder_infer``) is a Python loop over steps that writes
  each step's keys and values in place into a preallocated (L, B, H, T, dh)
  cache; the memory-side keys and values are projected once before the loop.
- Band widths are tensors: a scalar, or (B, 1, 1, 1) for per-item widths.
- With a compute ``dtype`` (bf16) the projections and FFN convs run in it,
  the residual stream between them stays in it, the caches hold it, and the
  prenet, the final LayerNorm and the output head stay float32, as in the
  JAX package.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from kantts_tpu_torch.models.sambert.common import (
    PositionwiseConvFeedForward,
    Prenet,
    masked_zero,
    merge_heads,
    scaled_dot_attention,
    split_heads,
    torch_linear,
)
from kantts_tpu_torch.utils.precision import Dtype, weak_scalar


def pnca_band_masks(T: int, x_band_width: torch.Tensor,
                    h_band_width: torch.Tensor,
                    pad_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B|1, T, T) band masks, True = disallowed, with the key-side padding
    mask merged in."""
    dev = x_band_width.device
    q = torch.arange(T, device=dev)[:, None]
    k = torch.arange(T, device=dev)[None, :]
    x_mask = ~((k >= q - x_band_width) & (k <= q))[None]
    h_mask = ~((k >= q) & (k <= q + h_band_width))[None]
    if pad_mask is not None:
        x_mask = x_mask | pad_mask[:, None, :]
        h_mask = h_mask | pad_mask[:, None, :]
    return x_mask, h_mask


class MultiHeadPNCAAttention(nn.Module):
    """Dual-source multi-head attention."""

    def __init__(self, n_head: int, d_model: int, d_mem: int, d_head: int,
                 dropout: float = 0.1, dropatt: float = 0.0, dtype: Dtype = None):
        super().__init__()
        self.n_head, self.d_head = n_head, d_head
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-6)
        self.w_x_qkv = torch_linear(d_model, 3 * n_head * d_head, dtype=dtype)
        self.fc_x = torch_linear(n_head * d_head, d_model, dtype=dtype)
        self.w_h_kv = torch_linear(d_mem, 2 * n_head * d_head, dtype=dtype)
        self.fc_h = torch_linear(n_head * d_head, d_model, dtype=dtype)
        self.drop = nn.Dropout(dropout)
        self.dropatt = nn.Dropout(dropatt)

    def compute_h_kv(self, memory: torch.Tensor):
        """memory (B, T, d_mem) -> h_k, h_v each (B, H, T, d_head)."""
        h_k, h_v = self.w_h_kv(memory).chunk(2, dim=-1)
        return split_heads(h_k, self.n_head), split_heads(h_v, self.n_head)

    def _attend(self, q, k, v, mask):
        return scaled_dot_attention(q, k, v, math.sqrt(self.d_head), mask,
                                    self.dropatt)

    def _project_out(self, x_t, out_x, out_h):
        out = self.fc_x(merge_heads(out_x)) + self.fc_h(merge_heads(out_h))
        return (self.drop(out) + x_t).to(x_t.dtype)

    def forward(self, x, memory, x_attn_mask=None, h_attn_mask=None):
        """Teacher-forced pass. Masks (B|1, Tq, Tk), True = disallowed."""
        h_k, h_v = self.compute_h_kv(memory)
        q, k, v = (split_heads(t, self.n_head)
                   for t in self.w_x_qkv(self.layer_norm(x.float())).chunk(3, dim=-1))
        xm = x_attn_mask[:, None] if x_attn_mask is not None else None
        hm = h_attn_mask[:, None] if h_attn_mask is not None else None
        out_x, attn_x = self._attend(q, k, v, xm)
        out_h, attn_h = self._attend(q, h_k, h_v, hm)
        return self._project_out(x, out_x, out_h), attn_x, attn_h

    def step(self, x_t, t: int, cache_k, cache_v, h_k, h_v, x_band_width,
             h_band_width, mem_pad_mask=None):
        """One incremental step. x_t (B, 1, d_model); cache_k/cache_v (B, H,
        T, dh), written in place at row t."""
        q, k, v = (split_heads(u, self.n_head)
                   for u in self.w_x_qkv(self.layer_norm(x_t.float())).chunk(3, dim=-1))
        cache_k[:, :, t] = k[:, :, 0]
        cache_v[:, :, t] = v[:, :, 0]
        j = torch.arange(cache_k.shape[2], device=x_t.device)[None, None, None, :]
        x_mask = ~((j >= t - x_band_width) & (j <= t))
        h_mask = ~((j >= t) & (j <= t + h_band_width))
        if mem_pad_mask is not None:
            h_mask = h_mask | mem_pad_mask[:, None, None, :]
        out_x, _ = self._attend(q, cache_k, cache_v, x_mask)
        out_h, _ = self._attend(q, h_k, h_v, h_mask)
        return self._project_out(x_t, out_x, out_h)


class PNCABlock(nn.Module):
    """PNCA attention + pointwise conv FFN (kernels (1, 1))."""

    def __init__(self, d_model: int, d_mem: int, n_head: int, d_head: int,
                 d_inner: int, dropout: float = 0.1, dropout_attn: float = 0.0,
                 dropout_relu: float = 0.0, dtype: Dtype = None):
        super().__init__()
        self.pnca_attn = MultiHeadPNCAAttention(n_head, d_model, d_mem, d_head,
                                                dropout, dropout_attn, dtype)
        self.pos_ffn = PositionwiseConvFeedForward(d_model, d_inner, (1, 1),
                                                   dropout_relu, dropout, dtype)

    def forward(self, x, memory, mask=None, x_attn_mask=None, h_attn_mask=None):
        out, attn_x, attn_h = self.pnca_attn(x, memory, x_attn_mask, h_attn_mask)
        out = self.pos_ffn(masked_zero(out, mask), mask)
        return masked_zero(out, mask), attn_x, attn_h


class HybridAttentionDecoder(nn.Module):
    """Prenet + memory concat + N PNCA blocks + LN + output projection."""

    def __init__(self, d_in: int, prenet_units: Sequence[int], n_layer: int,
                 d_model: int, d_mem: int, n_head: int, d_head: int,
                 d_inner: int, d_out: int, dropout: float = 0.1,
                 dropout_attn: float = 0.0, dropout_relu: float = 0.0,
                 dtype: Dtype = None):
        super().__init__()
        self.d_model = d_model
        self.prenet = Prenet(d_in, prenet_units, d_model)
        self.dec_in_proj = torch_linear(d_mem + d_model, d_model, dtype=dtype)
        self.pnca = nn.ModuleList([
            PNCABlock(d_model, d_mem, n_head, d_head, d_inner, dropout,
                      dropout_attn, dropout_relu, dtype)
            for _ in range(n_layer)])
        self.ln = nn.LayerNorm(d_model, eps=1e-6)
        self.dec_out_proj = torch_linear(d_model, d_out)
        self.drop = nn.Dropout(dropout)

    def _input(self, prev_frames, memory):
        h = torch.cat([memory, self.prenet(prev_frames)], dim=-1)
        return self.dec_in_proj(h)

    def forward(self, inputs, memory, x_band_width, h_band_width, mask=None):
        """Teacher-forced pass over shifted targets (B, T, d_in)."""
        h = masked_zero(self._input(inputs, memory), mask)
        h = self.drop(h * weak_scalar(math.sqrt(self.d_model), h.dtype))
        x_attn_mask, h_attn_mask = pnca_band_masks(h.shape[1], x_band_width,
                                                   h_band_width, mask)
        attns_x: List[torch.Tensor] = []
        attns_h: List[torch.Tensor] = []
        for layer in self.pnca:
            h, attn_x, attn_h = layer(h, memory, mask, x_attn_mask, h_attn_mask)
            attns_x.append(attn_x)
            attns_h.append(attn_h)
        return self.dec_out_proj(self.ln(h.float())), attns_x, attns_h

    def step(self, t: int, prev_frame, memory_t, h_kv, cache_k, cache_v,
             x_band_width, h_band_width, mem_pad_mask=None):
        """One decode step. prev_frame (B, 1, d_in); memory_t (B, 1, d_mem);
        cache_k/cache_v (L, B, H, T, dh), written in place."""
        h = self._input(prev_frame, memory_t)
        h = self.drop(h * weak_scalar(math.sqrt(self.d_model), h.dtype))
        for i, layer in enumerate(self.pnca):
            h = layer.pnca_attn.step(h, t, cache_k[i], cache_v[i], h_kv[i][0],
                                     h_kv[i][1], x_band_width, h_band_width,
                                     mem_pad_mask)
            h = layer.pos_ffn(h)
        return self.dec_out_proj(self.ln(h.float()))


class MelPNCADecoder(nn.Module):
    """Low-frame-rate mel decoder head over HybridAttentionDecoder."""

    def __init__(self, prenet_units: Sequence[int], nb_layers: int,
                 nb_heads: int, d_model: int, d_inner: int, d_mem: int,
                 d_mel: int, r: int, dropout: float = 0.1,
                 dropout_attn: float = 0.0, dropout_relu: float = 0.0,
                 dtype: Dtype = None):
        super().__init__()
        self.nb_layers, self.nb_heads, self.d_model = nb_layers, nb_heads, d_model
        self.d_mel, self.r, self.dtype = d_mel, r, dtype
        self.mel_dec = HybridAttentionDecoder(
            d_mel, prenet_units, nb_layers, d_model, d_mem, nb_heads,
            d_model // nb_heads, d_inner, d_mel * r, dropout, dropout_attn,
            dropout_relu, dtype)

    def forward(self, memory, x_band_width, h_band_width, target, mask=None):
        """Teacher-forced: the decoder reads the last frame of each r-group of
        ``target`` (B, T_frames, d_mel), shifted right behind a zero frame."""
        B = memory.shape[0]
        last_frames = target[:, self.r - 1::self.r, :]
        go = target.new_zeros((B, 1, self.d_mel))
        inputs = torch.cat([go, last_frames], dim=1)[:, :-1, :]
        return self.mel_dec(inputs, memory, x_band_width, h_band_width, mask)


@torch.no_grad()
def pnca_decoder_infer(decoder: MelPNCADecoder, memory: torch.Tensor,
                       x_band_width: torch.Tensor, h_band_width: torch.Tensor,
                       mem_pad_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Incremental decode over every memory step -> (B, T, d_mel * r)."""
    B, T, _ = memory.shape
    L, H = decoder.nb_layers, decoder.nb_heads
    dh = decoder.d_model // H
    dec = decoder.mel_dec
    h_kv = [layer.pnca_attn.compute_h_kv(memory) for layer in dec.pnca]
    # the caches hold the compute dtype, as the projections make it
    cache_k = memory.new_zeros((L, B, H, T, dh), dtype=decoder.dtype or memory.dtype)
    cache_v = torch.zeros_like(cache_k)
    prev = memory.new_zeros((B, 1, decoder.d_mel))
    outs = memory.new_empty((B, T, decoder.d_mel * decoder.r))
    for t in range(T):
        out = dec.step(t, prev, memory[:, t:t + 1], h_kv, cache_k, cache_v,
                       x_band_width, h_band_width, mem_pad_mask)
        outs[:, t] = out[:, 0]
        prev = out[:, :, -decoder.d_mel:]
    return outs

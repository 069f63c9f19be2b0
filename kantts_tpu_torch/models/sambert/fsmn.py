"""FSMN encoder (counterpart of ``kantts_tpu/models/sambert/fsmn.py``):
FeedForwardNet (1x1 conv pair, the second without bias), MemoryBlockV2
(depthwise conv with ``shift``-controlled asymmetric padding, residual), and
the residual stack ``FsmnEncoderV2``. A sharded FeedForwardNet holds a
slice of its hidden channels (``common.py``)."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from kantts_tpu_torch.models.sambert.common import conv1d_same, masked_zero, row_parallel
from kantts_tpu_torch.parallel.tp import ModelParallel, copy_to_model


class FeedForwardNet(nn.Module):
    TP_COL = {"w_1": 1}
    TP_ROW = ("w_2",)

    def __init__(self, d_in: int, d_hid: int, d_out: int, dropout: float = 0.1):
        super().__init__()
        self.w_1 = conv1d_same(d_in, d_hid, 1)
        self.w_2 = conv1d_same(d_hid, d_out, 1, bias=False)
        self.dropout = nn.Dropout(dropout)
        self.tp: Optional[ModelParallel] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dropout(torch.relu(self.w_1(copy_to_model(x, self.tp))))
        return row_parallel(self.w_2, h, self.tp)

    def tp_units(self) -> int:
        return self.w_1.out_channels


class MemoryBlockV2(nn.Module):
    """Depthwise temporal conv plus residual. shift > 0 moves the receptive
    field into the past: left pad round((k-1)/2)+shift, right pad
    (k-1)//2-shift (a negative pad crops)."""

    def __init__(self, d: int, filter_size: int, shift: int = 0,
                 dropout: float = 0.0):
        super().__init__()
        self.lp = int(round((filter_size - 1) / 2)) + shift
        self.rp = (filter_size - 1) // 2 - shift
        self.conv_dw = nn.Conv1d(d, d, filter_size, groups=d, bias=False)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        x = masked_zero(x, mask)
        h = F.pad(x.transpose(1, 2), (self.lp, self.rp))
        h = self.conv_dw(h).transpose(1, 2) + x
        return masked_zero(self.dropout(h), mask)


class FsmnEncoderV2(nn.Module):
    """Stack of (FFN -> memory block), residual where the widths match."""

    def __init__(self, d_in: int, filter_size: int, fsmn_num_layers: int,
                 num_memory_units: int, ffn_inner_dim: int,
                 dropout: float = 0.0, shift: Union[int, Sequence[int]] = 0):
        super().__init__()
        shifts = (list(shift) if isinstance(shift, (list, tuple))
                  else [shift] * fsmn_num_layers)
        self.ffn_lst = nn.ModuleList()
        self.memory_block_lst = nn.ModuleList()
        d = d_in
        for i in range(fsmn_num_layers):
            self.ffn_lst.append(FeedForwardNet(d, ffn_inner_dim,
                                               num_memory_units, dropout))
            self.memory_block_lst.append(MemoryBlockV2(
                num_memory_units, filter_size, shifts[i], dropout))
            d = num_memory_units
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        h = self.dropout(x)
        for ffn, memory_block in zip(self.ffn_lst, self.memory_block_lst):
            memory = self.dropout(memory_block(ffn(h), mask))
            if memory.shape[-1] == h.shape[-1]:
                memory = memory + h
            h = memory
        return h

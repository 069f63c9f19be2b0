"""Variance adaptors (counterpart of
``kantts_tpu/models/sambert/adaptors.py``): the length regulator and the
pitch/energy/duration predictors. The autoregressive duration loop is driven
from ``sambert.py``; the predictor here runs one step or a teacher-forced
sequence alike."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from kantts_tpu_torch.models.sambert.common import Prenet, torch_linear
from kantts_tpu_torch.models.sambert.fsmn import FsmnEncoderV2
from kantts_tpu_torch.models.sambert.lstm import LSTM, BiLSTM


def length_regulate(inputs: torch.Tensor, durations: torch.Tensor,
                    out_len: int, masks: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand (B, T_in, D) by per-token durations, rounded floor(d + 0.5),
    into (B, out_len, D); frames beyond the expanded length are zero.
    Returns (expanded, output_lens (B,) int32)."""
    reps = torch.floor(durations.float() + 0.5)
    output_lens = reps.sum(dim=1).to(torch.int32)
    cums = torch.cumsum(torch.nn.functional.pad(reps, (1, 0)), dim=1)
    rng = torch.arange(out_len, dtype=torch.float32,
                       device=inputs.device)[None, :, None]
    mult = ((cums[:, None, :-1] <= rng) & (cums[:, None, 1:] > rng)).to(inputs.dtype)
    out = torch.einsum("bot,btd->bod", mult, inputs)
    if masks is not None:
        out = out.masked_fill(masks[..., None], 0.0)
    return out, output_lens


class VarFsmnRnnNARPredictor(nn.Module):
    """Pitch/energy predictor: FSMN -> BiLSTM -> FC, one scalar per token."""

    def __init__(self, d_in: int, filter_size: int, fsmn_num_layers: int,
                 num_memory_units: int, ffn_inner_dim: int, dropout: float,
                 shift: int, lstm_units: int):
        super().__init__()
        self.fsmn = FsmnEncoderV2(d_in, filter_size, fsmn_num_layers,
                                  num_memory_units, ffn_inner_dim, dropout,
                                  shift)
        self.blstm = BiLSTM(num_memory_units, lstm_units)
        self.fc = torch_linear(2 * lstm_units, 1)

    def forward(self, x: torch.Tensor, masks: Optional[torch.Tensor] = None):
        h = self.fsmn(x, masks)
        lengths = (~masks).sum(dim=1) if masks is not None else None
        out = self.fc(self.blstm(h, lengths))[..., 0]
        if masks is not None:
            out = out.masked_fill(masks, 0.0)
        return out


class VarRnnARPredictor(nn.Module):
    """Autoregressive duration predictor: prenet(prev) ++ cond -> 2-layer
    LSTM -> FC -> ReLU. ``fc_bias_init`` is the head's initial bias (the
    builder reads it; the zero default is the reference's)."""

    def __init__(self, cond_units: int, prenet_units: Sequence[int],
                 rnn_units: int, fc_bias_init: float = 0.0):
        super().__init__()
        self.fc_bias_init = fc_bias_init
        self.prenet = Prenet(1, prenet_units)
        self.lstm = LSTM(prenet_units[-1] + cond_units, rnn_units, num_layers=2)
        self.fc = torch_linear(rnn_units, 1)

    def forward(self, inputs: torch.Tensor, cond: torch.Tensor,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                masks: Optional[torch.Tensor] = None):
        """inputs (B, T, 1) log(prev_dur + 1); cond (B, T, C) ->
        (out (B, T), new LSTM state)."""
        h = torch.cat([self.prenet(inputs), cond], dim=-1)
        h, new_state = self.lstm(h, state)
        out = torch.relu(self.fc(h)[..., 0])
        if masks is not None:
            out = out.masked_fill(masks, 0.0)
        return out, new_state

"""LSTM layers (counterpart of ``kantts_tpu/models/sambert/lstm.py``).

Both are ``nn.LSTM`` with ``batch_first``: the gate order (i, f, g, o) and
the double bias ``b_ih + b_hh`` are the ones the JAX package converts to, and
the parameter names are the KAN-TTS ones.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


class LSTM(nn.LSTM):
    """(Stacked) unidirectional LSTM over (B, T, D) with a carried state, for
    the teacher-forced pass and for one autoregressive step alike:
    ``lstm(x, state)`` -> (out (B, T, H), (h, c) each (num_layers, B, H))."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1):
        super().__init__(input_size, hidden_size, num_layers, batch_first=True)


class BiLSTM(nn.LSTM):
    """Single-layer bidirectional LSTM whose reverse direction runs over each
    item's own length: padding never reaches the backward states of valid
    positions. Outputs at padding positions are zero.

    With autograd on (training) the lengths pack the sequence, which copies
    them to the host. Without it (inference, and ``torch.export``) the same
    function is computed with no host copy and no shape that depends on
    the lengths: the forward direction is read from a pass over the padded
    sequence (the padding comes after every valid step), the reverse
    direction from a pass over each item's sequence rolled so that its
    valid steps come last, gathered back into place."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True,
                         bidirectional=True)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, D) -> (B, T, 2H)."""
        if lengths is None:
            return super().forward(x)[0]
        if not torch.is_grad_enabled():
            return self._masked(x, lengths)
        packed = pack_padded_sequence(x, lengths.cpu(), batch_first=True,
                                      enforce_sorted=False)
        out, _ = super().forward(packed)
        return pad_packed_sequence(out, batch_first=True,
                                   total_length=x.shape[1])[0]

    def _masked(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        T, H = x.shape[1], self.hidden_size
        t = torch.arange(T, device=x.device)[None, :]
        lengths = lengths.to(x.device)[:, None]
        # each item's valid steps moved to the end (rolled by T - length): the
        # reverse direction, which runs from step T - 1 down, meets them
        # before any padding
        rolled = torch.remainder(t - (T - lengths), T)[..., None]
        back = super().forward(x.gather(1, rolled.expand(-1, -1, x.shape[2])))[0]
        unroll = torch.remainder(t + (T - lengths), T)[..., None]
        bwd = back[..., H:].gather(1, unroll.expand(-1, -1, H))
        out = torch.cat([super().forward(x)[0][..., :H], bwd], dim=-1)
        return out * (t < lengths)[..., None].to(x.dtype)

"""Chunked-batch vocoder inference (counterpart of
``kantts_tpu/infer/chunked.py``).

A causal generator lets one utterance be split along time into n_chunks
windows of (receptive field + chunk) mel frames, synthesized as ONE batched
call; with full receptive-field context each window's emitted region equals
the whole-utterance forward. The cost is recomputing the context prefix of
every window: operations scale by (ctx + chunk) / chunk. Whether the batch
dimension pays that back on a given device is measured, not assumed
(``chip_smoke.py`` times it at B=1 on 5 s of mel).

Windows never see artificial LEFT frames: explicit zeros are not equivalent
to the causal convs' implicit padding (biases make zero inputs nonzero deep
in the stack, see infer/streaming.py), so early windows start at frame 0
and emit at a smaller offset instead. Right padding is harmless: a causal
stack never reads frames to the right of an emitted position.

NSF generators work too: the harmonic source, whose phase is a cumsum over
the whole utterance, is computed once on the full input (its draws from
``rng``) and windowed at sample rate alongside the mel, so each
window sees the whole-utterance excitation. A PQMF (multi-band) generator
is refused, as by the JAX package's CLI.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from kantts_tpu_torch.infer.streaming import generator_receptive_field


def _plan(T: int, n_chunks: int, ctx: int):
    """Window plan: (starts, emit_offsets, chunk, window_frames)."""
    chunk = -(-T // n_chunks)  # ceil
    window = ctx + chunk
    starts, offsets = [], []
    for c in range(n_chunks):
        s = c * chunk
        ctx_start = max(0, s - ctx)
        starts.append(ctx_start)
        offsets.append(s - ctx_start)
    return starts, offsets, chunk, window


def _context_frames(generator, context_frames: Optional[int]) -> int:
    assert generator.causal, "chunked inference requires the causal generator"
    if generator.out_channels != 1:
        raise ValueError("chunked inference requires a fullband generator "
                         "(PQMF multi-band is whole-utterance only)")
    if context_frames is not None:
        return int(context_frames)
    ctx = generator_receptive_field(generator)
    if generator.nsf_params is not None:
        # source_downs_i is a causal conv of kernel 2u at stride u over the
        # sample-rate excitation: at most 2 more mel frames of left context
        # at any stage; the JAX package pads the margin to 4
        ctx += 4
    return ctx


def chunked_apply(generator, mel: torch.Tensor, n_chunks: int,
                  context_frames: Optional[int] = None,
                  rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """mel (1, T, C) -> wav (1, T*hop, 1): n_chunks causal-context windows
    through one batched generator call, emitted regions stitched. ``rng``
    gives an NSF generator's draws."""
    ctx = _context_frames(generator, context_frames)
    T = int(mel.shape[1])
    starts, offsets, chunk, window = _plan(T, n_chunks, ctx)
    hop = int(np.prod(generator.upsample_scales))

    # right-pad so that every window slice is in range; padded frames only
    # ever sit right of emitted positions
    pad = starts[-1] + window - T
    m = F.pad(mel[0], (0, 0, 0, pad))
    windows = torch.stack([m[s:s + window] for s in starts])  # (n, window, C)
    if generator.nsf_params is not None:
        exc = generator(mel, excitation_only=True, generator=rng)  # (1, T*hop, 1)
        e = F.pad(exc[0], (0, 0, 0, pad * hop))
        y = generator(windows, excitation=torch.stack(
            [e[s * hop:(s + window) * hop] for s in starts]))
    else:
        y = generator(windows)
    pieces = [y[c, offsets[c] * hop:(offsets[c] + chunk) * hop]
              for c in range(n_chunks)]
    return torch.cat(pieces, dim=0)[None, :T * hop]

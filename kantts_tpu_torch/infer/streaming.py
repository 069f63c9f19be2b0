"""Streaming vocoder synthesis with bounded latency (counterpart of
``kantts_tpu/infer/streaming.py``).

A causal generator's waveform at frame t depends only on mel frames <= t,
so chunked synthesis with ``context_frames`` of left context is exact once
the context covers the receptive field: each chunk is computed as
generator(mel[t0-ctx : t1]) and only the samples of [t0, t1) are emitted.
Latency is chunk_frames * hop / sr seconds.

Every window has the same shape (context + chunk frames), so on the card
one set of convolution algorithms serves every window of every utterance.

NSF generators are not streamed here, where the JAX package streams them.
Its ``StreamingTTS`` hands the vocoder the acoustic model's mel with the f0
and uv channels still normalised (``am_synthesis`` does not denormalise;
only ``am_infer``, ``text_to_wav`` and the service do), and its
``stream_synthesis`` draws every window's source from ``PRNGKey(0)`` with
the phase restarted, so the streamed waveform is neither the utterance's
nor any other path's. The port's ``StreamingTTS`` refuses an NSF vocoder
(``bin/stream_tts.py::NSF_REFUSAL``) rather than reproduce that.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch


def causal_receptive_field_frames(
    kernel_size: int,
    upsample_scales,
    resblock_kernel_sizes,
    resblock_dilations,
) -> int:
    """Upper bound of the generator's receptive field, in mel frames.

    Counted backwards through the stack: resblock dilated convs act at
    progressively upsampled rates, so their sample-domain extent shrinks when
    expressed in frames.
    """
    # frame-rate context from conv_pre
    frames = kernel_size - 1
    upsampled = 1
    for i, scale in enumerate(upsample_scales):
        upsampled *= scale
        # repeat-upsample conv (k=kernel_size) + resblocks at this rate
        samples = kernel_size - 1
        for k, dils in zip(resblock_kernel_sizes, resblock_dilations):
            for d in dils:
                samples += (k - 1) * d  # conv1 (dilated)
                samples += k - 1  # conv2
        frames += -(-samples // upsampled) + 1
    # conv_post at full rate
    frames += 1
    return frames


def generator_receptive_field(generator) -> int:
    return causal_receptive_field_frames(
        generator.kernel_size, generator.upsample_scales,
        generator.resblock_kernel_sizes, generator.resblock_dilations)


def stream_synthesis(
    generator,
    mel: np.ndarray,
    chunk_frames: int = 50,
    context_frames: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Yield (chunk_frames * hop, 1) float32 waveform chunks for a (T, C)
    mel (the last chunk may be shorter), computed on the generator's device.

    ``context_frames`` defaults to the generator's receptive field (exactness
    guaranteed); smaller values trade accuracy at chunk boundaries for less
    recompute. Each window runs under ``torch.inference_mode`` of its own,
    since grad mode is per thread and the caller's thread may have it on.
    """
    assert generator.causal, "streaming requires the causal generator"
    if context_frames is None:
        context_frames = generator_receptive_field(generator)
    hop = int(np.prod(generator.upsample_scales))
    device = next(generator.parameters()).device

    T = mel.shape[0]
    window_frames = context_frames + chunk_frames
    for start in range(0, T, chunk_frames):
        end = min(start + chunk_frames, T)
        # NOTE: explicit zero frames are NOT equivalent to the causal convs'
        # implicit padding beyond the first layer (biases turn zero inputs
        # into nonzero deep activations), so windows must contain only REAL
        # frames on the left. Early chunks therefore start at frame 0; the
        # fixed window size is reached by RIGHT padding, which a causal
        # stack provably ignores.
        ctx_start = max(0, start - context_frames)
        window = mel[ctx_start:end]
        ctx = start - ctx_start
        pad = window_frames - window.shape[0]
        window = np.pad(window, [(0, pad), (0, 0)]).astype(np.float32)
        with torch.inference_mode():
            y = generator(torch.from_numpy(window[None]).to(device))
            y = y[0, ctx * hop:(ctx + end - start) * hop].float().cpu().numpy()
        yield y

"""Batched STFT (counterpart of ``kantts_tpu/dsp/stft.py``).

``torch.stft`` computes it: a periodic Hann window of ``win_length``,
zero-padded to ``n_fft`` about its centre, centre padding of n_fft // 2 on
both sides in ``reflect`` (librosa, the preprocessing flavour) or
``constant`` (zeros, the loss flavour) mode. Frames come out on the second
to last axis, frequencies on the last, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window — matches torch.hann_window / scipy fftbins=True."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad a window to ``size``, centered (librosa util.pad_center)."""
    n = len(window)
    lpad = (size - n) // 2
    return np.pad(window, (lpad, size - n - lpad))


def stft_complex(x: torch.Tensor, n_fft: int, hop_length: int,
                 win_length: Optional[int] = None,
                 window: Optional[torch.Tensor] = None, center: bool = True,
                 pad_mode: str = "reflect") -> torch.Tensor:
    """Complex STFT: (..., T) -> (..., num_frames, n_fft // 2 + 1).
    ``window`` (default: the Hann window of ``win_length``) is zero-padded
    to ``n_fft`` about its centre when it is shorter. A bf16 ``x`` is
    transformed in float32, as the JAX package's product with its float32
    window promotes it."""
    win_length = win_length or n_fft
    if window is None:
        window = torch.from_numpy(hann_window(win_length))
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    window = window.to(device=x.device, dtype=x.dtype)
    if window.shape[-1] < n_fft:
        lpad = (n_fft - window.shape[-1]) // 2
        window = F.pad(window, (lpad, n_fft - window.shape[-1] - lpad))
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    if center:
        pad = n_fft // 2
        # F.pad's reflect mode wants a channel axis
        x = F.pad(x[:, None], (pad, pad), mode=pad_mode)[:, 0]
    spec = torch.stft(x, n_fft, hop_length, n_fft, window, center=False,
                      return_complex=True)
    return spec.transpose(-1, -2).reshape(*lead, spec.shape[-1], spec.shape[-2])


def stft_magnitude(x: torch.Tensor, n_fft: int, hop_length: int,
                   win_length: Optional[int] = None,
                   window: Optional[torch.Tensor] = None, center: bool = True,
                   pad_mode: str = "reflect", min_power: float = 1e-7
                   ) -> torch.Tensor:
    """Magnitude spectrogram sqrt(clamp(re^2 + im^2, min_power)), the clamp
    keeping log-magnitude losses finite at zero power."""
    spec = stft_complex(x, n_fft, hop_length, win_length, window, center,
                        pad_mode)
    power = spec.real ** 2 + spec.imag ** 2
    return torch.sqrt(power.clamp(min=min_power))


def istft(spec: torch.Tensor, n_fft: int, hop_length: int,
          win_length: Optional[int] = None, window: Optional[np.ndarray] = None,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT by overlap-add with window-square normalisation:
    complex (..., num_frames, n_fft // 2 + 1) -> (..., T). Assumes the
    forward's centre padding of n_fft // 2, which is trimmed here; ``length``
    cuts the result (default: the unpadded length of the frames)."""
    win_length = win_length or n_fft
    window = pad_center(hann_window(win_length) if window is None
                        else np.asarray(window), n_fft)
    window = torch.from_numpy(window).to(device=spec.device, dtype=spec.real.dtype)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    lead, num_frames = frames.shape[:-2], frames.shape[-2]
    total = n_fft + hop_length * (num_frames - 1)

    def overlap_add(x):  # (B, num_frames, n_fft) -> (B, total)
        return F.fold(x.transpose(1, 2), (1, total), (1, n_fft),
                      stride=(1, hop_length))[:, 0, 0]

    y = overlap_add(frames.reshape(-1, num_frames, n_fft))
    wsq = overlap_add((window ** 2).expand(1, num_frames, n_fft))
    y = y / torch.where(wsq > 1e-10, wsq, torch.ones_like(wsq))
    pad = n_fft // 2
    y = y[:, pad:pad + length] if length is not None else y[:, pad:total - pad]
    return y.reshape(*lead, y.shape[-1])

"""Griffin-Lim phase reconstruction and spectrogram/mel inversion
(counterpart of ``kantts_tpu/dsp/griffin_lim.py``), for copy-synthesis
checks without a vocoder. Everything runs on the device of its input.

The initial phase is uniform in [0, 2 pi): drawn from ``generator`` (a
``torch.Generator`` on the input's device), or injected as ``angles``, which
is how a test holds the iteration against the JAX package's, whose phase
comes from a JAX PRNG key.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kantts_tpu_torch.dsp.mel import (
    amp_to_db,
    db_to_amp,
    denormalize_db,
    mel_filterbank,
    normalize_db,
)
from kantts_tpu_torch.dsp.stft import hann_window, istft, pad_center, stft_complex


def griffin_lim(magnitude: torch.Tensor, n_fft: int, hop_length: int,
                win_length: int, n_iter: int = 60,
                generator: Optional[torch.Generator] = None,
                angles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """magnitude (..., frames, n_fft // 2 + 1) -> waveform (..., T): a
    random initial phase, then ``n_iter`` projections through iSTFT and
    STFT."""
    if angles is None:
        angles = torch.rand(magnitude.shape, generator=generator,
                            device=magnitude.device, dtype=magnitude.dtype) * (2 * np.pi)
    spec = torch.polar(magnitude, angles.to(magnitude))
    frames = magnitude.shape[-2]
    for _ in range(n_iter):
        y = istft(spec, n_fft, hop_length, win_length)
        re = stft_complex(y, n_fft, hop_length, win_length, center=True,
                          pad_mode="reflect")[..., :frames, :]
        spec = magnitude * (re / re.abs().clamp(min=1e-10))
    return istft(spec, n_fft, hop_length, win_length)


def inv_spectrogram(spec_db_norm: torch.Tensor, n_fft: int = 1024,
                    hop_length: int = 256, win_length: int = 1024,
                    max_norm: float = 1.0, min_level_db: float = -100.0,
                    ref_level_db: float = 20.0, symmetric: bool = False,
                    power: float = 1.5, n_iter: int = 60,
                    generator: Optional[torch.Generator] = None,
                    angles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Invert a normalised linear spectrogram (frames, n_fft // 2 + 1)."""
    S = db_to_amp(denormalize_db(spec_db_norm, max_norm, min_level_db, symmetric)
                  + ref_level_db)
    return griffin_lim(S ** power, n_fft, hop_length, win_length, n_iter,
                       generator, angles)


def inv_mel_spectrogram(mel_norm: torch.Tensor, sample_rate: int,
                        n_fft: int = 1024, hop_length: int = 256,
                        win_length: int = 1024, n_mels: int = 80,
                        max_norm: float = 1.0, min_level_db: float = -100.0,
                        ref_level_db: float = 20.0, fmin: float = 50.0,
                        fmax: float = 8000.0, symmetric: bool = False,
                        power: float = 1.5, n_iter: int = 60,
                        generator: Optional[torch.Generator] = None,
                        angles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Invert a normalised mel spectrogram (frames, n_mels): de-normalise,
    pseudo-invert the mel filterbank, then Griffin-Lim."""
    inv_basis = torch.from_numpy(np.linalg.pinv(
        mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax))).to(mel_norm.device)
    D = db_to_amp(denormalize_db(mel_norm, max_norm, min_level_db, symmetric)
                  + ref_level_db)
    S = (D @ inv_basis.T).clamp(min=1e-10)
    return griffin_lim(S ** power, n_fft, hop_length, win_length, n_iter,
                       generator, angles)


def spectrogram(wav: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                win_length: int = 1024, max_norm: float = 1.0,
                min_level_db: float = -100.0, ref_level_db: float = 20.0,
                symmetric: bool = False) -> torch.Tensor:
    """Normalised linear magnitude spectrogram (..., frames, n_fft // 2 + 1)."""
    window = torch.from_numpy(pad_center(hann_window(win_length), n_fft))
    spec = stft_complex(wav, n_fft, hop_length, win_length, window,
                        center=True, pad_mode="reflect")
    S = amp_to_db(spec.abs()) - ref_level_db
    return normalize_db(S, max_norm, min_level_db, symmetric)

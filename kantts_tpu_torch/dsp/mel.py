"""Mel spectrogram front-ends (counterpart of ``kantts_tpu/dsp/mel.py``).

Two normalisations, as in the JAX package:

1. **Feature extraction** (``MelSpectrogramExtractor``): reflect-padded
   STFT magnitude, mel, ``amp_to_db - ref_level_db``, then normalised into
   [0, max_norm] (or [-max_norm, max_norm] when symmetric). Training mel
   targets are made this way.
2. **Loss** (``LossMelSpectrogram``): zero-padded STFT, amplitude clamped
   at 1e-10, dB with ref 20 and min -100, symmetric into [-4, 4], returned
   as (B, n_mels, frames). ``MelSpectrogramLoss`` compares these.

The filterbank is librosa's default (Slaney mel scale, Slaney area
normalisation), computed from the formulas in numpy.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from kantts_tpu_torch.dsp.stft import hann_window, pad_center, stft_complex


def _hz_to_mel_slaney(freq):
    freq = np.asanyarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def _mel_to_hz_slaney(mels):
    mels = np.asanyarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(
        log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
    )
    return freqs


@lru_cache(maxsize=None)
def mel_filterbank(
    sr: int, n_fft: int, n_mels: int = 80, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, n_fft//2+1)."""
    if fmax is None:
        fmax = float(sr) / 2
    fftfreqs = np.linspace(0, float(sr) / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    mel_f = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))

    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def amp_to_db(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    """20 * log10(max(clip_val, x))."""
    return 20.0 * torch.log10(x.clamp(min=clip_val))


def db_to_amp(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x * 0.05)


def normalize_db(S: torch.Tensor, max_norm: float = 1.0,
                 min_level_db: float = -100.0, symmetric: bool = False
                 ) -> torch.Tensor:
    """dB -> [0, max_norm], or [-max_norm, max_norm] when ``symmetric``."""
    if symmetric:
        return torch.clamp((2 * max_norm) * ((S - min_level_db) / (-min_level_db))
                           - max_norm, -max_norm, max_norm)
    return torch.clamp(max_norm * ((S - min_level_db) / (-min_level_db)),
                       0, max_norm)


def denormalize_db(D: torch.Tensor, max_norm: float = 1.0,
                   min_level_db: float = -100.0, symmetric: bool = False
                   ) -> torch.Tensor:
    """The inverse of ``normalize_db`` inside its range."""
    if symmetric:
        return ((torch.clamp(D, -max_norm, max_norm) + max_norm)
                * -min_level_db / (2 * max_norm)) + min_level_db
    return (torch.clamp(D, 0, max_norm) * -min_level_db / max_norm) + min_level_db


class MelSpectrogramExtractor:
    """Feature-extraction mel: wav (..., T) -> (..., frames, n_mels), the
    transform that training mel targets are made with, computed on
    ``device``."""

    def __init__(self, sampling_rate: int, n_fft: int = 1024,
                 hop_length: int = 256, win_length: int = 1024,
                 n_mels: int = 80, max_norm: float = 1.0,
                 min_level_db: float = -100.0, ref_level_db: float = 20.0,
                 fmin: float = 50.0, fmax: float = 8000.0,
                 symmetric: bool = False, device="cpu"):
        self.device = torch.device(device)
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.max_norm = max_norm
        self.min_level_db = min_level_db
        self.ref_level_db = ref_level_db
        self.symmetric = symmetric
        self.melmat = torch.from_numpy(
            mel_filterbank(sampling_rate, n_fft, n_mels, fmin, fmax)).to(self.device)
        self.window = torch.from_numpy(
            pad_center(hann_window(win_length), n_fft)).to(self.device)

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        spec = stft_complex(x, self.n_fft, self.hop_length, self.win_length,
                            self.window, center=True, pad_mode="reflect")
        mel = spec.abs() @ self.melmat.to(x.device).T
        S = amp_to_db(mel) - self.ref_level_db
        return normalize_db(S, self.max_norm, self.min_level_db, self.symmetric)

    def __call__(self, wav: np.ndarray) -> np.ndarray:
        """numpy wav (T,) or (..., T) -> numpy mel (..., frames, n_mels),
        computed on the extractor's device."""
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(wav, dtype=np.float32), device=self.device)
            return self.transform(x).cpu().numpy()


class LossMelSpectrogram:
    """Loss-flavour mel: (B, T) or (B, 1, T) -> (B, n_mels, frames) in
    [-4, 4], differentiable. ``fmin`` None is 0 and ``fmax`` None is fs / 2."""

    def __init__(self, fs: int = 22050, fft_size: int = 1024,
                 hop_size: int = 256, win_length: Optional[int] = None,
                 window: str = "hann", num_mels: int = 80,
                 fmin: Optional[float] = 80.0, fmax: Optional[float] = 7600.0,
                 center: bool = True, eps: float = 1e-10,
                 log_base: Optional[float] = 10.0, min_level_db: float = -100.0,
                 ref_level_db: float = 20.0, norm_abs_value: float = 4.0,
                 symmetric: bool = True):
        del log_base  # the normalisation is in dB whatever the log base
        if window != "hann":
            raise ValueError(f"{window} window is not implemented")
        self.fft_size = fft_size
        self.hop_size = hop_size
        self.win_length = win_length or fft_size
        self.center = center
        self.eps = eps
        self.min_level_db = min_level_db
        self.ref_level_db = ref_level_db
        self.norm_abs_value = norm_abs_value
        self.symmetric = symmetric
        fmin = 0.0 if fmin is None else fmin
        fmax = float(fs) / 2 if fmax is None else fmax
        self.melmat = torch.from_numpy(
            mel_filterbank(fs, fft_size, num_mels, fmin, fmax))
        self.window = torch.from_numpy(
            pad_center(hann_window(self.win_length), fft_size))
        self._on: dict = {}  # device -> (melmat, window) there

    def _constants(self, device: torch.device):
        if device not in self._on:
            self._on[device] = (self.melmat.to(device), self.window.to(device))
        return self._on[device]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 3:
            x = x.reshape(-1, x.shape[-1])
        melmat, window = self._constants(x.device)
        spec = stft_complex(x, self.fft_size, self.hop_size, self.win_length,
                            window, center=self.center, pad_mode="constant")
        power = spec.real ** 2 + spec.imag ** 2
        amp = torch.sqrt(power.clamp(min=self.eps))
        mel = (amp @ melmat.T).clamp(min=self.eps)
        out = amp_to_db(mel) - self.ref_level_db
        out = normalize_db(out, self.norm_abs_value, self.min_level_db,
                           self.symmetric)
        return out.transpose(-1, -2)

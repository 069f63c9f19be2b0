"""Quality metrics: mel-cepstral distortion (MCD) with DTW alignment (a
copy of ``kantts_tpu/utils/metrics.py``; numpy and scipy, and the port's
STFT on the CPU for ``mcd_between_wavs``).

KAN-TTS ships no metric code; this is the standard MCD recipe, so that
comparisons across frameworks are reproducible:

- mel cepstra via DCT-II of log-mel energies (coefficients 1..K, c0/energy
  excluded), K = 13 by default;
- frame alignment by dynamic time warping on the cepstral distance;
- MCD = (10 / ln 10) * sqrt(2) * mean aligned euclidean distance.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.fftpack import dct

_MCD_CONST = 10.0 / np.log(10.0) * np.sqrt(2.0)


def mel_cepstrum(log_mel: np.ndarray, n_coeffs: int = 13) -> np.ndarray:
    """(frames, n_mels) log-mel -> (frames, n_coeffs) cepstra (c1..cK)."""
    cep = dct(log_mel, type=2, axis=-1, norm="ortho")
    return cep[:, 1 : n_coeffs + 1]


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Standard DTW over a (T1, T2) local-cost matrix; returns aligned index
    arrays."""
    T1, T2 = cost.shape
    acc = np.full((T1 + 1, T2 + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, T1 + 1):
        j_lo, j_hi = 1, T2 + 1
        for j in range(j_lo, j_hi):
            best_prev = min(acc[i - 1, j], acc[i, j - 1], acc[i - 1, j - 1])
            acc[i, j] = cost[i - 1, j - 1] + best_prev
    # backtrack
    i, j = T1, T2
    path_i, path_j = [], []
    while i > 0 and j > 0:
        path_i.append(i - 1)
        path_j.append(j - 1)
        options = [(acc[i - 1, j - 1], i - 1, j - 1),
                   (acc[i - 1, j], i - 1, j),
                   (acc[i, j - 1], i, j - 1)]
        _, i, j = min(options, key=lambda t: t[0])
    return np.asarray(path_i[::-1]), np.asarray(path_j[::-1])


def mel_cepstral_distortion(
    log_mel_a: np.ndarray,
    log_mel_b: np.ndarray,
    n_coeffs: int = 13,
    use_dtw: bool = True,
) -> float:
    """MCD (dB) between two (frames, n_mels) log-mel spectrograms."""
    ca = mel_cepstrum(np.asarray(log_mel_a, dtype=np.float64), n_coeffs)
    cb = mel_cepstrum(np.asarray(log_mel_b, dtype=np.float64), n_coeffs)
    if use_dtw:
        cost = np.linalg.norm(ca[:, None, :] - cb[None, :, :], axis=-1)
        pi, pj = dtw_path(cost)
        dists = cost[pi, pj]
    else:
        n = min(len(ca), len(cb))
        dists = np.linalg.norm(ca[:n] - cb[:n], axis=-1)
    return float(_MCD_CONST * dists.mean())


def mcd_between_wavs(
    wav_a: np.ndarray,
    wav_b: np.ndarray,
    sampling_rate: int,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    n_mels: int = 80,
    fmin: float = 50.0,
    fmax: Optional[float] = None,
    n_coeffs: int = 13,
) -> float:
    """MCD between two waveforms via the port's mel front-end."""
    import torch

    from kantts_tpu_torch.dsp.mel import mel_filterbank
    from kantts_tpu_torch.dsp.stft import stft_magnitude

    fmax = fmax or sampling_rate / 2
    fb = mel_filterbank(sampling_rate, n_fft, n_mels, fmin, fmax)

    def log_mel(w):
        mag = stft_magnitude(torch.from_numpy(w.astype(np.float32)), n_fft,
                             hop_length, win_length).numpy()
        return np.log(np.maximum(mag @ fb.T, 1e-8))

    return mel_cepstral_distortion(log_mel(wav_a), log_mel(wav_b), n_coeffs)

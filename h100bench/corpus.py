"""Synthetic vocoder corpus written from the seed, in the layout the
port's ``VocDataset`` reads: ``wav/*.wav`` (16-bit PCM) and ``mel/*.npy``.

A copy of the tone recipe of ``kantts_tpu_torch/utils/corpus.py::
write_voc_corpus``: a tone whose f0 glides around a random base of
90-260 Hz, 6 harmonics at amplitudes 1/k, an envelope rising and falling
with a slow tremolo, a little white noise, peak 0.5. Its mel is the
feature-extraction mel of the voice's audio configuration (reflect-padded
STFT magnitude, Slaney mel filters, 20 log10 floored at 1e-5, less
``ref_level_db``, mapped from [min_level_db, 0] to [0, max_norm]),
computed here with numpy.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
from scipy.io import wavfile

from h100bench.reference.gan import mel_basis


def feature_mel(wav: np.ndarray, audio: dict, basis: np.ndarray) -> np.ndarray:
    """(T,) -> (1 + T // hop, n_mels) float32; ``basis``: the mel filters."""
    n, hop, win = audio["n_fft"], audio["hop_length"], audio["win_length"]
    w = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win) / win)).astype(np.float32)
    lpad = (n - win) // 2
    w = np.pad(w, (lpad, n - win - lpad))
    x = np.pad(wav.astype(np.float32), n // 2, mode="reflect")
    frames = 1 + (len(x) - n) // hop
    x = np.lib.stride_tricks.sliding_window_view(x, n)[::hop][:frames]
    amp = np.abs(np.fft.rfft(x * w, axis=1))
    db = 20 * np.log10(np.maximum(amp @ basis.T, 1e-5)) - audio["ref_level_db"]
    norm = audio["max_norm"] * (db - audio["min_level_db"]) / -audio["min_level_db"]
    return np.clip(norm, 0, audio["max_norm"]).astype(np.float32)


def write_voc_corpus(root: str, n_utts: int, seconds: Tuple[float, float],
                     audio: dict, seed: int) -> None:
    sr = audio["sampling_rate"]
    basis = mel_basis(sr, audio["n_fft"], audio["n_mels"], audio["fmin"], audio["fmax"])
    rng = np.random.RandomState(seed % 2 ** 32)
    for sub in ("wav", "mel"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n_utts):
        n = int(rng.uniform(*seconds) * sr)
        t = np.arange(n) / sr
        f0 = rng.uniform(90, 260) * (1 + 0.15 * np.sin(2 * np.pi * rng.uniform(0.3, 2)
                                                        * t + rng.uniform(0, 6.3)))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        tone = sum(np.sin(k * phase + rng.uniform(0, 6.3)) / k for k in range(1, 7))
        envelope = (np.sqrt(np.clip(np.sin(np.pi * t / t[-1]), 0.0, None))
                    * (1 + 0.3 * np.sin(2 * np.pi * rng.uniform(2, 6) * t)))
        wav = tone * envelope + 0.02 * rng.randn(n)
        wav = (0.5 * wav / np.abs(wav).max()).astype(np.float32)
        pcm = np.clip(wav.astype(np.float64) * 32767.0, -32768, 32767).astype(np.int16)
        wavfile.write(os.path.join(root, "wav", f"utt{i:04d}.wav"), sr, pcm)
        np.save(os.path.join(root, "mel", f"utt{i:04d}.npy"), feature_mel(wav, audio, basis))

"""Wav IO (librosa/soundfile-free): PCM16 write, float read (a copy of
``kantts_tpu/utils/audio.py``)."""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def save_wav(wav: np.ndarray, path: str, sample_rate: int) -> None:
    """float waveform in [-1, 1] -> 16-bit PCM, as KAN-TTS writes it."""
    wav = np.asarray(wav, dtype=np.float64).reshape(-1)
    quant = np.clip(wav * 32767.0, -32768, 32767).astype(np.int16)
    wavfile.write(path, sample_rate, quant)


def read_wav(path: str) -> tuple[int, np.ndarray]:
    """-> (sample rate, float32 samples of the first channel in [-1, 1])."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data[:, 0]
    return sr, data

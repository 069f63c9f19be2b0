"""How far the port's frame energy lies from float64, by rounding mode.

    python tools/energy_rounding.py

On the CPU, for the harmonic test input of
``tests/test_torch_port_preprocess.py::test_get_energy_matches_jax`` (1.1 s
at 16 kHz, n_fft 2048, hop 200, window 1000), prints the largest relative
gap to a float64 numpy energy, and the frames beyond 1e-5, of two ways of
computing it, under each rounding mode of the calling thread
(``fesetround``) and under 1 and 8 torch threads:

- ``fft32``: ``|torch.stft|`` in float32, squared and summed (the port's
  ``get_energy`` before it moved off the FFT);
- ``parseval64``: ``preprocess/audio_utils.py::get_energy`` as it is.
"""

from __future__ import annotations

import ctypes
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kantts_tpu_torch.dsp.stft import stft_magnitude  # noqa: E402
from kantts_tpu_torch.preprocess.audio_utils import get_energy  # noqa: E402

SR, N_FFT, HOP, WIN = 16000, 2048, 200, 1000
MODES = {"nearest": 0x000, "down": 0x400, "up": 0x800, "toward_zero": 0xC00}


def harmonic(seconds: float = 1.1, seed: int = 4) -> np.ndarray:
    """The test's ``_harmonic``: a gliding 5-harmonic tone, a silent third,
    a little noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = rng.uniform(120, 220) * (1 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    wav = sum(np.sin(k * phase) / k for k in range(1, 6))
    wav[len(t) // 3: len(t) // 2] = 0.0
    return (0.4 * wav / np.abs(wav).max() + 0.01 * rng.randn(len(t))).astype(np.float32)


def energy_float64(wav: np.ndarray) -> np.ndarray:
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(WIN) / WIN)
    lpad = (N_FFT - WIN) // 2
    window = np.pad(window, (lpad, N_FFT - WIN - lpad))
    x = np.pad(wav.astype(np.float64), N_FFT // 2, mode="reflect")
    frames = np.stack([x[i:i + N_FFT] for i in range(0, len(x) - N_FFT + 1, HOP)])
    return np.sqrt((np.abs(np.fft.rfft(frames * window, axis=-1)) ** 2).sum(1))[:, None]


def fft32(wav: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        mag = stft_magnitude(torch.from_numpy(wav), N_FFT, HOP, WIN, min_power=0.0)
        return mag.square().sum(-1).sqrt().reshape(-1, 1).numpy()


def main() -> None:
    libm = ctypes.CDLL("libm.so.6")
    wav = harmonic()
    exact = energy_float64(wav)
    for threads in (1, 8):
        torch.set_num_threads(threads)
        for mode, code in MODES.items():
            for name, fn in (("fft32", fft32),
                             ("parseval64", lambda w: get_energy(w, HOP, WIN, N_FFT))):
                libm.fesetround(code)
                try:
                    got = fn(wav)
                finally:
                    libm.fesetround(0)
                rel = np.abs(got - exact) / np.abs(exact)
                print(f"threads={threads} mode={mode} {name}: max_rel={rel.max():.3e} "
                      f"frames_over_1e-5={int((rel > 1e-5).sum())} of {len(rel)}")


if __name__ == "__main__":
    main()

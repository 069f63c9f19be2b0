"""Eval-artifact plots: spectrograms, alignments, waveforms (counterpart of
``kantts_tpu/utils/plot.py``: the same figures, sizes and ``Agg`` backend).

matplotlib is optional: it is imported when a figure is drawn, and
``available()`` says whether it can be, so that a trainer on a machine
without it writes its other artifacts and logs what it left out.
"""

from __future__ import annotations

import importlib.util

import numpy as np


def available() -> bool:
    """Whether matplotlib is installed."""
    return importlib.util.find_spec("matplotlib") is not None


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_spectrogram(spec: np.ndarray, path: str) -> None:
    """spec: (frames, n_mels)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(np.asarray(spec).T, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    plt.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_alignment(alignment: np.ndarray, path: str, info: str | None = None) -> None:
    """alignment: (T_out, T_in)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(np.asarray(alignment).T, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("Decoder timestep" + (f"\n\n{info}" if info else ""))
    ax.set_ylabel("Encoder timestep")
    plt.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_waveform(wav: np.ndarray, path: str, sample_rate: int = 16000) -> None:
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 2.5))
    t = np.arange(len(wav)) / sample_rate
    ax.plot(t, np.asarray(wav), linewidth=0.5)
    ax.set_xlabel("seconds")
    plt.tight_layout()
    fig.savefig(path)
    plt.close(fig)

"""Audio preprocessing primitives (a copy of
``kantts_tpu/preprocess/audio_utils.py``): volume normalisation, silence
trim, the f0 ensemble, energy, interval parsing, feature normalisation.

Everything is numpy on the host but ``get_energy``, whose STFT runs on a
given device through the port's ``dsp/stft.py``. The f0 ensemble calls the
native RAPT-style and YIN trackers of ``native/pitch.cpp`` with KAN-TTS's
adaptive-range median recipe; sox's amplitude statistics are a numpy RMS and
librosa's trim is a frame-RMS dB gate with the same threshold semantics.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple

import numpy as np

import torch

from kantts_tpu_torch.dsp.stft import stft_magnitude
from kantts_tpu_torch.native.pitch import rapt, yin
from kantts_tpu_torch.utils.audio import read_wav

# Anchor amplitude distribution for corpus volume histogram matching.
# Calibration DATA reproduced from the reference's anchor tables
# (core/utils.py:15-127): anchor_bins is a uniform grid over the anchor RMS
# range; anchor_hist is the empirical CDF of a studio-quality corpus.
ANCHOR_BINS = np.linspace(0.033976, 0.099683, 51)
ANCHOR_HIST = np.array([
    0.0, 0.00215827, 0.00354383, 0.00442313, 0.00490274, 0.00532907,
    0.00602185, 0.00690115, 0.00810019, 0.00948574, 0.0120437, 0.01489475,
    0.01873168, 0.02302158, 0.02872369, 0.03669065, 0.04636291, 0.05843325,
    0.07700506, 0.11052491, 0.16802558, 0.25997868, 0.37942979, 0.50730083,
    0.62006395, 0.71092459, 0.76877165, 0.80762057, 0.83458566, 0.85672795,
    0.87660538, 0.89251266, 0.90578204, 0.91569411, 0.92541966, 0.93383959,
    0.94162004, 0.94940048, 0.95539568, 0.96136424, 0.9670397, 0.97290168,
    0.97705835, 0.98116174, 0.98465228, 0.98814282, 0.99152678, 0.99421796,
    0.9965894, 0.99840128, 1.0,
])
HIST_BINS = 50


def amp_info(wav_path: str) -> dict:
    """RMS/max/mean amplitude stats (numpy; replaces the sox binary)."""
    sr, data = read_wav(wav_path)
    return {
        "amp_rms": float(np.sqrt(np.mean(data.astype(np.float64) ** 2))),
        "amp_max": float(np.max(np.abs(data))),
        "amp_mean": float(np.mean(data)),
        "length": len(data) / sr,
        "basename": os.path.basename(wav_path),
    }


def volume_normalize(src_wav_dir: str, out_wav_dir: str,
                     num_workers: int = 8) -> bool:
    """Histogram-match per-utterance RMS to the anchor distribution
    (reference utils.py:183-223)."""
    from concurrent.futures import ThreadPoolExecutor
    from glob import glob

    from scipy.io import wavfile

    wav_list = sorted(glob(os.path.join(src_wav_dir, "*.wav")))
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        infos = list(ex.map(amp_info, wav_list))
    infos.sort(key=lambda x: x["amp_rms"])
    logging.info("Average amplitude RMS: %f",
                 np.mean([x["amp_rms"] for x in infos]))

    rms_list = [x["amp_rms"] for x in infos]
    src_hist, src_bins = np.histogram(rms_list, bins=HIST_BINS, density=True)
    src_hist = np.cumsum(src_hist / np.sum(src_hist))
    src_hist = np.insert(src_hist, 0, 0.0)

    os.makedirs(out_wav_dir, exist_ok=True)
    for info in infos:
        rms = np.clip(info["amp_rms"], src_bins[0], src_bins[-1])
        src_idx = np.where(rms >= src_bins)[0][-1]
        src_pos = src_hist[src_idx]
        anchor_idx = np.where(src_pos >= ANCHOR_HIST)[0][-1]
        if src_idx == HIST_BINS or anchor_idx == HIST_BINS:
            target_rms = ANCHOR_BINS[-1]
        else:
            target_rms = (
                (rms - src_bins[src_idx])
                / (src_bins[src_idx + 1] - src_bins[src_idx])
                * (ANCHOR_BINS[anchor_idx + 1] - ANCHOR_BINS[anchor_idx])
                + ANCHOR_BINS[anchor_idx]
            )
        scale = target_rms / info["amp_rms"]
        sr, data = wavfile.read(os.path.join(src_wav_dir, info["basename"]))
        wavfile.write(os.path.join(out_wav_dir, info["basename"]), sr,
                      (data * scale).astype(np.int16))
    return True


def trim_silence(wav: np.ndarray, top_db: float, hop_length: int,
                 win_length: int) -> np.ndarray:
    """Trim leading/trailing frames quieter than max - top_db
    (librosa.effects.trim semantics, reference core/dsp.py:38-42)."""
    n_frames = max(1, (len(wav) - win_length) // hop_length + 1)
    rms = np.empty(n_frames)
    for i in range(n_frames):
        seg = wav[i * hop_length : i * hop_length + win_length]
        rms[i] = np.sqrt(np.mean(seg.astype(np.float64) ** 2) + 1e-20)
    db = 20.0 * np.log10(rms + 1e-20)
    keep = db > db.max() - top_db
    if not keep.any():
        return wav
    first = int(np.argmax(keep))
    last = int(len(keep) - np.argmax(keep[::-1]))
    start = first * hop_length
    end = min(len(wav), last * hop_length + win_length)
    return wav[start:end]


def trim_silence_with_interval(wav: np.ndarray, interval: Optional[np.ndarray],
                               hop_length: int) -> Optional[np.ndarray]:
    """Remove leading/trailing silence using the first/last interval durations
    (reference core/dsp.py:45-51)."""
    if interval is None:
        return None
    leading, tailing = int(interval[0]), int(interval[-1])
    end = -tailing * hop_length if tailing > 0 else None
    return wav[leading * hop_length : end]


# ------------------------------------------------------------------- pitch


def interp_f0(f0: np.ndarray) -> np.ndarray:
    """Linear interpolation through unvoiced gaps (reference utils.py:226-235)."""
    f0 = f0.copy()
    f0[f0 < 1] = 0
    xp = np.nonzero(f0)[0]
    if len(xp) == 0:
        return f0.astype(np.float32)
    return np.interp(np.arange(f0.size), xp, f0[xp]).astype(np.float32)


def smooth(data: np.ndarray, win_len: int) -> np.ndarray:
    """Hanning smoothing with edge padding (reference utils.py:273-285),
    vectorized via convolution."""
    if win_len % 2 == 0:
        win_len += 1
    hwin = win_len // 2
    win = np.hanning(win_len)
    win /= win.sum()
    flat = data.reshape(-1)
    padded = np.pad(flat, hwin, mode="edge")
    return np.convolve(padded, win, mode="valid").reshape(-1, 1)


def get_pitch(pcm: np.ndarray, sampling_rate: int = 16000,
              hop_length: int = 160):
    """Adaptive-range multi-estimator median f0 (reference utils.py:307-368):
    calibration pass narrows [low, high], then each estimator's log-f0 is
    gap-interpolated; the ensemble median is Hanning-smoothed; uv likewise."""
    if pcm.dtype == np.int16:
        pcm = pcm.astype(np.float32) / 32768.0
    pcm = pcm.astype(np.float32)
    low, high = 40.0, 800.0

    cali = rapt(pcm, sampling_rate, hop_length, low, high)
    f0_range = np.sort(np.unique(cali))
    if len(f0_range) > 20:
        low = max(f0_range[10] - 50, low)
        high = min(f0_range[-10] + 50, high)

    log_f0_list, uv_list = [], []
    for func in (rapt, yin):
        f0 = func(pcm, sampling_rate, hop_length, low, high)
        uv = f0 > 0
        if len(f0) < 10 or f0.max() < low:
            logging.error("%s: calculated F0 is too low.", func.__name__)
            continue
        f0 = np.clip(f0, 1e-30, high)
        log_f0_list.append(interp_f0(np.log(f0)))
        uv_list.append(uv)

    if not log_f0_list:
        logging.error("F0 estimation failed.")
        return None

    min_len = min(len(x) for x in log_f0_list)
    multi_log_f0 = np.stack([x[:min_len] for x in log_f0_list])
    multi_uv = np.stack([u[:min_len].astype(np.float32) for u in uv_list])

    log_f0 = smooth(np.median(multi_log_f0, axis=0), 5)
    uv = (smooth(np.median(multi_uv, axis=0), 5) > 0.5).astype(np.float32)
    f0 = np.exp(log_f0)
    n = min(f0.shape[0], uv.shape[0])
    return f0[:n], uv[:n], f0[:n] * uv[:n]


# ------------------------------------------------------------------ energy


def get_energy(wav: np.ndarray, hop_length: int, win_length: int,
               n_fft: int, device="cpu") -> np.ndarray:
    """Frame-wise spectral L2 magnitude, (frames, 1), computed on
    ``device`` (reference utils.py:372-377)."""
    with torch.no_grad():
        mag = stft_magnitude(
            torch.as_tensor(wav.astype(np.float32), device=device), n_fft,
            hop_length, win_length, min_power=0.0)
        return mag.square().sum(-1).sqrt().reshape(-1, 1).cpu().numpy()


# --------------------------------------------------------------- alignment


def align_length(x: Optional[np.ndarray], target: Optional[np.ndarray],
                 basename: Optional[str] = None) -> Optional[np.ndarray]:
    """Pad/trim x's frame axis to match target; reject >20 frame mismatch
    (reference utils.py:380-401)."""
    if x is None or target is None:
        logging.error("%s: input data is None.", basename)
        return None
    if abs(x.shape[0] - target.shape[0]) > 20:
        logging.error("%s: length mismatches target too much.", basename)
        return None
    if x.shape[0] < target.shape[0]:
        return np.pad(x, ((0, target.shape[0] - x.shape[0]), (0, 0)))
    return x[: target.shape[0]]


def compute_mean_std(data_list: List[np.ndarray], dims: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Corpus feature mean/std (reference utils.py:404-435), single pass."""
    total = np.zeros((1, dims))
    sq_total = np.zeros((1, dims))
    count = 0
    for data in data_list:
        if data is None:
            continue
        feats = data.reshape(-1, dims)
        total += feats.sum(axis=0)
        sq_total += (feats ** 2).sum(axis=0)
        count += feats.shape[0]
    mean = total / count
    std = np.sqrt(np.maximum(sq_total / count - mean ** 2, 0.0))
    return mean, std


def f0_norm_mean_std(x: np.ndarray, mean: np.ndarray, std: np.ndarray
                     ) -> np.ndarray:
    """Mean/std normalize, keeping exact zeros at zero
    (reference utils.py:489-493)."""
    zero = x == 0.0
    out = (x - mean) / std
    out[zero] = 0.0
    return out


def norm_mean_std(x: np.ndarray, mean: np.ndarray, std: np.ndarray
                  ) -> np.ndarray:
    return (x - mean) / std


# --------------------------------------------------------------- intervals


def parse_interval_file(path: str, sampling_rate: int, hop_length: int):
    """Parse mit-style interval label files into (frame durations, phones)
    (reference utils.py:503-525)."""
    with open(path) as f:
        lines = f.readlines()
    frame_seconds = hop_length / sampling_rate
    idx = 12  # header lines
    durs, phones = [], []
    while idx + 2 < len(lines) + 1 and idx + 2 <= len(lines):
        try:
            begin = float(lines[idx])
            end = float(lines[idx + 1])
        except (ValueError, IndexError):
            break
        phone = lines[idx + 2].strip()[1:-1]
        durs.append(int(round((end - begin) / frame_seconds)))
        phones.append(phone)
        idx += 3
    if not durs:
        return None
    return np.array(durs), phones


def average_by_duration(x: Optional[np.ndarray], durs: Optional[np.ndarray]
                        ) -> Optional[np.ndarray]:
    """Mean of nonzero frame values per phone span (reference utils.py:528-539)."""
    if x is None or durs is None:
        return None
    x = x.reshape(-1)
    cums = np.cumsum(np.pad(durs, (1, 0)))
    out = np.zeros(durs.shape[0], dtype=np.float32)
    for i, (s, e) in enumerate(zip(cums[:-1], cums[1:])):
        vals = x[s:e][x[s:e] != 0.0]
        out[i] = vals.mean() if len(vals) else 0.0
    return out


def encode_16bits(x: np.ndarray) -> np.ndarray:
    if x.min() > -1.0 and x.max() < 1.0:
        return np.clip(x * 2 ** 15, -(2 ** 15), 2 ** 15 - 1).astype(np.int16)
    return x

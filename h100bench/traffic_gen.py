"""The general traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and the voice's sizes, and makes the inputs from
the seed.

Utterance lengths come from the mix's length law as a fixed set, the
law's quantiles at (i + 1/2) / pool for i < pool, and the seed only orders
them. The law (``"maxent"``) is fixed by what a corpus publishes of its
clips' durations, the shortest, the mean and the longest: of the laws on
[min_s, max_s] with mean ``mean_s`` it is the one of the most entropy, a
density proportional to exp(rate * seconds), so it assumes nothing that
the corpus did not state. Every seed sends the same sizes, so runs of
different seeds do the same work. The order is stratified: the sorted pool is cut into
``strata`` equal strata, and each block of ``strata`` consecutive
utterances takes one of each stratum, shuffled; so any stretch of whole
blocks holds the same mix of lengths, whatever the seed. Each
utterance's content is a slice, at a seeded offset, of a seeded bank of
smooth log-mel frames (and, for an NSF voice, of an f0 contour in Hz with
unvoiced runs and the 0/1 voicing flag).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np


def maxent_rate(width: float, mean: float) -> float:
    """The rate of the density proportional to exp(rate * y) on [0, width]
    whose mean is ``mean`` (0 < mean < width), by bisection."""
    def law_mean(rate: float) -> float:
        if abs(rate * width) < 1e-9:
            return width / 2
        return width / -math.expm1(-rate * width) - 1 / rate

    lo, hi = -200.0 / width, 200.0 / width
    for _ in range(200):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if law_mean(mid) < mean else (lo, mid)
    return (lo + hi) / 2


def length_pool(law: dict, frames_per_second: float) -> np.ndarray:
    """The frame counts of the pool, shortest first."""
    if law["law"] != "maxent":
        raise ValueError(f"unknown length law {law['law']!r}")
    n, a, b = law["pool"], law["min_s"], law["max_s"]
    if not a < law["mean_s"] < b:
        raise ValueError("the mean must lie between the shortest and the longest")
    rate = maxent_rate(b - a, law["mean_s"] - a)
    u = (np.arange(n) + 0.5) / n
    if abs(rate * (b - a)) < 1e-9:
        secs = a + u * (b - a)
    else:
        secs = a + np.log1p(u * math.expm1(rate * (b - a))) / rate
    return np.rint(secs * frames_per_second).astype(np.int64)


def stratified_order(rng: np.random.Generator, pool: np.ndarray,
                     strata: int) -> np.ndarray:
    """``pool`` (sorted) in blocks of ``strata``, one of each stratum a
    block, in seeded order."""
    if len(pool) % strata:
        raise ValueError("the pool must divide into whole strata")
    grid = np.sort(pool).reshape(strata, -1)        # stratum s is row s
    grid = rng.permuted(grid, axis=1)               # members of each stratum
    return rng.permuted(grid.T, axis=1).reshape(-1)  # each block shuffled


def _smooth(x: np.ndarray, width: int, axis: int) -> np.ndarray:
    """Moving average of ``width`` along ``axis`` ('valid' part)."""
    c = np.cumsum(x, axis=axis, dtype=np.float64)
    c = np.concatenate([np.zeros_like(np.take(c, [0], axis=axis)), c], axis=axis)
    n = x.shape[axis]
    hi = np.take(c, np.arange(width, n + 1), axis=axis)
    lo = np.take(c, np.arange(0, n + 1 - width), axis=axis)
    return (hi - lo) / width


def mel_bank(rng: np.random.Generator, spec: dict, n_mels: int) -> np.ndarray:
    """(bank_frames, n_mels) float32 log-mels: noise smoothed over
    ``smooth_frames`` frames and 5 bands, at ``spread`` around an envelope
    falling from ``top`` to ``bottom`` across the bands, clipped to
    [floor, ceil]."""
    w = spec["smooth_frames"]
    x = rng.standard_normal((spec["bank_frames"] + w - 1, n_mels + 4))
    x = _smooth(_smooth(x, w, 0), 5, 1)
    x = x / x.std() * spec["spread"]
    env = np.linspace(spec["top"], spec["bottom"], n_mels)
    return np.clip(x + env, spec["floor"], spec["ceil"]).astype(np.float32)


def f0_bank(rng: np.random.Generator, spec: dict, frames: int) -> np.ndarray:
    """(frames, 2) float32: f0 in Hz within [min_hz, max_hz], smooth over
    ``smooth_frames``, and the voicing flag in {0, 1}, alternating voiced
    and unvoiced runs whose lengths are uniform in their ranges."""
    w = spec["smooth_frames"]
    z = _smooth(rng.standard_normal(frames + w - 1), w, 0)
    z = z / z.std()
    lo, hi = math.log(spec["min_hz"]), math.log(spec["max_hz"])
    f0 = np.exp(lo + (hi - lo) * 0.5 * (1.0 + np.tanh(z)))
    uv = np.zeros(frames)
    t, voiced = 0, True
    while t < frames:
        a, b = spec["voiced_run_frames"] if voiced else spec["unvoiced_run_frames"]
        run = int(rng.integers(a, b + 1))
        uv[t:t + run] = 1.0 if voiced else 0.0
        t, voiced = t + run, not voiced
    return np.stack([f0, uv], 1).astype(np.float32)


@dataclass
class Utterances:
    """The seed's utterances, in the order they are sent: ``frames[i]``
    frames from ``bank[offsets[i]:]``."""

    bank: np.ndarray
    frames: np.ndarray
    offsets: np.ndarray

    def mel(self, i: int) -> np.ndarray:
        i %= len(self.frames)
        return self.bank[self.offsets[i]:self.offsets[i] + self.frames[i]]

    def take(self, start: int, n: int) -> List[np.ndarray]:
        return [self.mel(start + j) for j in range(n)]


def utterances(mix: dict, frames_per_second: float, n_mels: int, nsf: bool,
               seed: int) -> Utterances:
    rng = np.random.default_rng([seed % 2 ** 63, 1])
    frames = stratified_order(rng, length_pool(mix["lengths"], frames_per_second),
                              mix["lengths"]["strata"])
    bank = mel_bank(rng, mix["mel"], n_mels)
    if nsf:
        bank = np.concatenate([bank, f0_bank(rng, mix["f0"], len(bank))], 1)
    offsets = rng.integers(0, len(bank) - frames + 1)
    return Utterances(bank, frames, offsets)

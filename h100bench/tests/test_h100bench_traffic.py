"""The traffic generator: deterministic by seed, the same sizes for every
seed, and the length law of the mixes."""

import json
import math
import os

import numpy as np
import pytest

from h100bench.traffic_gen import length_pool, maxent_rate, utterances

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
def mix(name):
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        return json.load(f)


# the mixes of utterances sent for vocoding
MIXES = sorted(n for n in (f[:-5] for f in os.listdir(os.path.join(BENCH, "traffic")))
               if mix(n)["path"] == "vocode")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_inputs(name):
    a = utterances(mix(name), 80.0, 80, True, 2 ** 31 + 11)
    b = utterances(mix(name), 80.0, 80, True, 2 ** 31 + 11)
    c = utterances(mix(name), 80.0, 80, True, 12)
    assert np.array_equal(a.frames, b.frames) and np.array_equal(a.offsets, b.offsets)
    assert np.array_equal(a.bank, b.bank)
    assert not np.array_equal(a.frames, c.frames)
    assert not np.array_equal(a.bank, c.bank)
    # every seed sends the same sizes, in another order
    assert np.array_equal(np.sort(a.frames), np.sort(c.frames))


@pytest.mark.parametrize("name", MIXES)
def test_length_law(name):
    law = mix(name)["lengths"]
    assert law["law"] == "maxent" and law["source"]
    frames = length_pool(law, 80.0)
    secs = frames / 80.0
    assert len(frames) == law["pool"]
    assert secs.min() >= law["min_s"] - 1 / 80 and secs.max() <= law["max_s"] + 1 / 80
    # the corpus's published mean, to the rounding to frames
    assert abs(secs.mean() - law["mean_s"]) < 1 / 80
    # the quantiles are those of the density proportional to exp(rate * s)
    a, b = law["min_s"], law["max_s"]
    rate = maxent_rate(b - a, law["mean_s"] - a)
    cdf = np.expm1(rate * (secs - a)) / math.expm1(rate * (b - a))
    u = (np.arange(len(secs)) + 0.5) / len(secs)
    assert np.max(np.abs(cdf - u)) < 0.002


@pytest.mark.parametrize("width,mean", [(8.99, 5.46), (1.0, 0.5), (2.0, 0.3)])
def test_maxent_rate_hits_the_mean(width, mean):
    rate = maxent_rate(width, mean)
    y = np.linspace(0, width, 200001)
    p = np.exp(rate * y)
    assert abs(np.sum(y * p) / np.sum(p) - mean) < 1e-4
    assert (rate > 0) == (mean > width / 2) or abs(rate) < 1e-6


@pytest.mark.parametrize("name", MIXES)
def test_blocks_hold_one_of_each_stratum(name):
    m = mix(name)
    strata = m["lengths"]["strata"]
    u = utterances(m, 80.0, 80, False, 5)
    pool = np.sort(length_pool(m["lengths"], 80.0)).reshape(strata, -1)
    for block in u.frames.reshape(-1, strata):
        # one of each stratum: the s-th shortest of the block lies in stratum s
        b = np.sort(block)
        assert np.all(pool[:, 0] <= b) and np.all(b <= pool[:, -1])


def test_nsf_bank_channels():
    m = mix("vocode_b4")
    u = utterances(m, 100.0, 80, True, 3)
    f0, uv = u.bank[:, 80], u.bank[:, 81]
    assert u.bank.shape[1] == 82 and u.bank.dtype == np.float32
    assert f0.min() >= m["f0"]["min_hz"] and f0.max() <= m["f0"]["max_hz"]
    assert set(np.unique(uv)) == {0.0, 1.0}
    assert u.mel(0).shape == (u.frames[0], 82)

"""The yardstick's counts against hand counts."""

import json
import os

import pytest

from h100bench import flops

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def hand_generator_flops(p, B, T):
    """2 * MACs of every conv of the generator, from its published shape."""
    k, ch = p["kernel_size"], p["channels"]
    total = 2 * B * T * ch * p["in_channels"] * k          # conv_pre
    t, c_in = T, ch
    nsf = p.get("nsf_params")
    hop = 1
    for s in p["upsample_scales"]:
        hop *= s
    if nsf:
        H = nsf["nb_harmonics"] + 1
        total += 2 * B * T * hop * H                          # the source's ffn
    for i, (s, up_k) in enumerate(zip(p["upsample_scales"], p["upsample_kernal_sizes"])):
        c = ch // 2 ** (i + 1)
        total += 2 * B * (t * s) * c * c_in * k               # repeat conv
        total += 2 * B * t * c_in * c * up_k                  # transposed conv
        t *= s
        if nsf:
            u = hop // (T and t // T)
            total += 2 * B * t * c * (1 if u == 1 else 2 * u)  # source_downs
        for rk, rd in zip(p["resblock_kernel_sizes"], p["resblock_dilations"]):
            total += 2 * len(rd) * 2 * B * t * c * c * rk
        c_in = c
    total += 2 * B * t * p["out_channels"] * c_in * k        # conv_post
    return total


@pytest.mark.parametrize("config", ["voice16k_mas", "voice24k_nsf"])
@pytest.mark.parametrize("B,T", [(1, 3), (2, 7)])
def test_generator_flops_hand_count(config, B, T):
    with open(os.path.join(BENCH, "configs", f"{config}.json")) as f:
        p = json.load(f)["hifigan"]["Model"]["Generator"]["params"]
    assert flops.generator_flops(p, B, T) == hand_generator_flops(p, B, T)


def test_k1_bound():
    # the float32 map read once and the float32 path written once
    assert flops.k1_bytes(32, 576, 128) == 18_874_368
    assert flops.k1_least_seconds(32, 576, 128) * 1e3 == pytest.approx(0.005634, abs=1e-6)
    assert flops.k1_least_seconds(2, 4800, 800) * 1e3 == pytest.approx(0.01834, abs=1e-5)


def test_peaks():
    assert flops.peak_flops({"dtype": "float32", "tf32": False}) == 67e12
    assert flops.peak_flops({"dtype": "float32", "tf32": True}) == 495e12

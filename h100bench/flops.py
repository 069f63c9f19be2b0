"""Operations, bytes and the card's published peaks: the yardstick of the
``*.mfu`` and ``*_roofline`` metrics.

Operations are counted by ``torch.utils.flop_counter.FlopCounterMode`` over
the plain reference on the meta device, once per shape: no device work, and
nothing that the measured program could change. Only the readers of a
traced run count, after the measured window: its first use in a process
imports some seconds of modules, which set-up does not pay.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench.reference import hifigan as ref_hifigan

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W.
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def peak_flops(cfg: dict) -> float:
    """The peak of the configuration's compute dtype."""
    if cfg["dtype"] == "float32":
        return PEAK_FLOPS["tf32" if cfg["tf32"] else "float32"]
    return PEAK_FLOPS[cfg["dtype"]]


def generator_flops(params: dict, batch: int, frames: int) -> int:
    """Operations of one HiFi-GAN generator call on a (batch, frames) input."""
    shapes = ref_hifigan.param_shapes(params)
    w = {n: torch.empty(s, device="meta") for n, s in shapes.items()}
    nsf = params.get("nsf_params")
    channels = params["in_channels"] + (2 if nsf is not None else 0)
    mel = torch.empty((batch, frames, channels), device="meta")
    draws = None
    if nsf is not None:
        H, n = nsf["nb_harmonics"] + 1, frames * ref_hifigan.hop(params)
        draws = (torch.empty((batch, 1, H), device="meta"),
                 torch.empty((batch, n, H), device="meta"))
    with FlopCounterMode(display=False) as counter:
        ref_hifigan.generator(mel, w, params, draws)
    return counter.get_total_flops()


def generator_flop_table(params: dict, batch: int, buckets) -> Dict[int, int]:
    """{frames: operations of one call} for each padded length."""
    return {int(L): generator_flops(params, batch, int(L)) for L in sorted(set(buckets))}


def k1_bytes(batch: int, t_mel: int, t_in: int) -> int:
    """The least bytes of one MAS alignment (kernel K1): the float32
    log-probability map read once and the float32 path written once."""
    return 2 * 4 * batch * t_mel * t_in


def k1_least_seconds(batch: int, t_mel: int, t_in: int) -> float:
    return k1_bytes(batch, t_mel, t_in) / HBM_BYTES_PER_S

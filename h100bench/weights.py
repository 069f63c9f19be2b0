"""Weights made from the seed, on the device, in one draw.

Every tensor of ``shapes`` gets U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in
being the size of one slice of its weight along axis 0, as PyTorch's
default initialisers give; a weight-norm gain ``weight_g`` is the norm of
its direction ``weight_v``, so that the conv's weight is ``weight_v``; a
spectral norm's vector ``weight_u`` is drawn like a bias.
The same seed and shapes give the same tensors on the same device, so the
program and the reference are handed equal weights.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def seeded_weights(shapes: Dict[str, Tuple[int, ...]], seed: int,
                   device) -> Dict[str, torch.Tensor]:
    drawn = [n for n in shapes if not n.endswith("weight_g")]
    sizes = [math.prod(shapes[n]) for n in drawn]
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out: Dict[str, torch.Tensor] = {}
    for name, part in zip(drawn, torch.split(flat, sizes)):
        stem = name.rsplit(".", 1)[0]
        weight = next((shapes[f"{stem}.{w}"] for w in ("weight_v", "weight_orig", "weight")
                       if f"{stem}.{w}" in shapes), None)
        fan_in = math.prod(weight[1:]) if weight is not None else shapes[name][0]
        out[name] = (part / math.sqrt(fan_in)).reshape(shapes[name])
    for name in shapes:
        if name.endswith("weight_g"):
            v = out[name[:-1] + "v"]
            out[name] = torch.linalg.vector_norm(v, dim=tuple(range(1, v.ndim)),
                                                 keepdim=True)
    return {n: out[n] for n in shapes}

"""Helpers of the port's mixed precision.

In the JAX package a Python float meets a bf16 array as a weakly typed
scalar: ``0.1 * x`` multiplies x by bf16(0.1) = 0.10009765625. PyTorch
multiplies a bf16 tensor by the scalar in float32 instead, which rounds
differently. ``weak_scalar`` gives the scalar rounded to the tensor's dtype,
so that the port's bf16 ops round as the JAX package's do. ``add_bias``
adds a layer's float32 bias after its product, in the product's dtype, as
flax's layers do with a compute dtype.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import torch

Dtype = Optional[torch.dtype]  # a compute dtype; None: the input's (float32)


def add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """y (B, C, *spatial) plus a (C,) bias cast to y's dtype."""
    if bias is None:
        return y
    return y + bias.to(y.dtype).reshape(-1, *(1,) * (y.ndim - 2))


@lru_cache(maxsize=None)
def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float."""
    return torch.tensor(value, dtype=dtype).item()

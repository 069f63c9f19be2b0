"""HiFi-GAN conv primitives (counterpart of
``kantts_tpu/models/hifigan/layers.py``), non-NSF.

These layers work on (B, C, T), the layout of ``F.conv1d``; the generator
keeps (B, T, C) at its public boundary. Weight norm is written out: each conv
holds ``weight_v`` and ``weight_g`` and uses w = g / sqrt(sum(v^2) + 1e-12) * v,
the norm taken over all axes but dim 0. For ``ConvTranspose1d`` dim 0 is the
*input* channel, as with torch's ``weight_norm`` on that module. Causal convs
pad (k-1)*dilation on the left; causal transposed convs trim their tail to
T*stride.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def get_activation(name: str, params: Optional[dict]) -> nn.Module:
    params = params or {}
    if name == "LeakyReLU":
        return nn.LeakyReLU(params.get("negative_slope", 0.01))
    if name == "ReLU":
        return nn.ReLU()
    if name == "Tanh":
        return nn.Tanh()
    raise ValueError(f"Unsupported activation: {name}")


class WeightNormParams(nn.Module):
    """``weight_v`` (d0, d1, k), ``weight_g`` (d0, 1, 1) and an optional
    ``bias``: the parameters KAN-TTS keeps under ``.conv1d`` / ``.deconv``."""

    def __init__(self, d0: int, d1: int, kernel_size: int, bias_size: int = 0):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(d0, d1, kernel_size))
        self.weight_g = nn.Parameter(torch.ones(d0, 1, 1))
        self.bias = nn.Parameter(torch.zeros(bias_size)) if bias_size else None

    def weight(self) -> torch.Tensor:
        v = self.weight_v
        norm = torch.sqrt((v * v).sum(dim=(1, 2), keepdim=True) + 1e-12)
        return (self.weight_g / norm) * v


class WNConv1d(nn.Module):
    """Weight-normed Conv1d. ``causal``: left pad (k-1)*dilation; otherwise
    ``padding`` frames on both sides."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = True, causal: bool = False):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.pads = (((kernel_size - 1) * dilation, 0) if causal
                     else (padding, padding))
        self.conv1d = WeightNormParams(out_channels, in_channels, kernel_size,
                                       out_channels if bias else 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(F.pad(x, self.pads), self.conv1d.weight(),
                        self.conv1d.bias, self.stride, 0, self.dilation)


class WNConvTranspose1d(nn.Module):
    """Weight-normed ConvTranspose1d, normed per input channel. Causal: trim
    the tail to T*stride; otherwise trim ``padding`` from both ends."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0, bias: bool = True,
                 causal: bool = False):
        super().__init__()
        self.stride, self.padding, self.causal = stride, padding, causal
        self.deconv = WeightNormParams(in_channels, out_channels, kernel_size,
                                       out_channels if bias else 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose1d(x, self.deconv.weight(), self.deconv.bias,
                               self.stride)
        if self.causal:
            return y[:, :, :x.shape[-1] * self.stride]
        return y[:, :, self.padding:y.shape[-1] - self.padding]


class ResidualBlock(nn.Module):
    """MRF residual block: per dilation d, x += conv(act(conv_d(act(x))))."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5),
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: Optional[dict] = None,
                 causal: bool = False):
        super().__init__()
        self.act = get_activation(nonlinear_activation,
                                  nonlinear_activation_params
                                  or {"negative_slope": 0.1})
        k = kernel_size
        self.convs1 = nn.ModuleList([
            WNConv1d(channels, channels, k, padding=(k * d - d) // 2,
                     dilation=d, causal=causal) for d in dilation])
        self.convs2 = nn.ModuleList([
            WNConv1d(channels, channels, k, padding=(k - 1) // 2,
                     causal=causal) for _ in dilation])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = c2(self.act(c1(self.act(x)))) + x
        return x


@torch.no_grad()
def fold_weight_norm(module: nn.Module) -> nn.Module:
    """Fold g into v for every weight-normed conv (the analogue of
    ``remove_weight_norm``): v becomes the effective weight and g its norm,
    so the module computes the same function. Returns ``module``."""
    for m in module.modules():
        if isinstance(m, WeightNormParams):
            w = m.weight()
            m.weight_v.copy_(w)
            m.weight_g.copy_(torch.linalg.vector_norm(w, dim=(1, 2), keepdim=True))
    return module


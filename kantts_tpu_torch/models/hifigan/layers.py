"""HiFi-GAN conv primitives and the NSF source (counterpart of
``kantts_tpu/models/hifigan/layers.py``).

These layers work on (B, C, T), the layout of ``F.conv1d``; the generator
keeps (B, T, C) at its public boundary. Weight norm is written out: each conv
holds ``weight_v`` and ``weight_g`` and uses w = g / sqrt(sum(v^2) + 1e-12) * v,
the norm taken over all axes but dim 0. For ``ConvTranspose1d`` dim 0 is the
*input* channel, as with torch's ``weight_norm`` on that module. Causal convs
pad (k-1)*dilation on the left; causal transposed convs trim their tail to
T*stride.

A conv built with a compute ``dtype`` (bf16) takes the weight norm in
float32, casts its input and the normed weight to the dtype, convolves, and
adds the bias cast to the dtype after the product, as the JAX layers do;
without one it runs in its input's dtype with the bias fused.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import math

import torch
import torch.nn.functional as F
from torch import nn

from kantts_tpu_torch.utils.precision import Dtype, add_bias, weak_scalar


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """Leaky ReLU with the slope rounded to x's dtype, as the JAX package's
    ``slope * x`` rounds it (``utils/precision.py``)."""
    return F.leaky_relu(x, weak_scalar(negative_slope, x.dtype))


class LeakyReLU(nn.LeakyReLU):
    """``nn.LeakyReLU`` through ``leaky_relu``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x, self.negative_slope)


def get_activation(name: str, params: Optional[dict]) -> nn.Module:
    params = params or {}
    if name == "LeakyReLU":
        return LeakyReLU(params.get("negative_slope", 0.01))
    if name == "ReLU":
        return nn.ReLU()
    if name == "Tanh":
        return nn.Tanh()
    raise ValueError(f"Unsupported activation: {name}")


def weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g / sqrt(sum(v^2) + 1e-12) * v, the sum over every axis but dim 0."""
    dims = tuple(range(1, v.ndim))
    return (g / torch.sqrt((v * v).sum(dim=dims, keepdim=True) + 1e-12)) * v


class WeightNormParams(nn.Module):
    """``weight_v`` (d0, d1, *kernel_size), ``weight_g`` (d0, 1, ...) and an
    optional ``bias``: the parameters KAN-TTS keeps under ``.conv1d`` /
    ``.deconv``."""

    def __init__(self, d0: int, d1: int, kernel_size: Union[int, Sequence[int]],
                 bias_size: int = 0):
        super().__init__()
        ks = (kernel_size,) if isinstance(kernel_size, int) else tuple(kernel_size)
        self.weight_v = nn.Parameter(torch.empty(d0, d1, *ks))
        self.weight_g = nn.Parameter(torch.ones(d0, 1, *(1,) * len(ks)))
        self.bias = nn.Parameter(torch.zeros(bias_size)) if bias_size else None

    def weight(self) -> torch.Tensor:
        return weight_norm(self.weight_v, self.weight_g)


class WNConv1d(nn.Module):
    """Weight-normed Conv1d. ``causal``: left pad (k-1)*dilation; otherwise
    ``padding`` frames on both sides."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = True, causal: bool = False, dtype: Dtype = None):
        super().__init__()
        self.stride, self.dilation, self.dtype = stride, dilation, dtype
        self.pads = (((kernel_size - 1) * dilation, 0) if causal
                     else (padding, padding))
        self.conv1d = WeightNormParams(out_channels, in_channels, kernel_size,
                                       out_channels if bias else 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.conv1d.weight(), self.conv1d.bias
        if self.dtype is None:
            return F.conv1d(F.pad(x, self.pads), w, b, self.stride, 0, self.dilation)
        y = F.conv1d(F.pad(x.to(self.dtype), self.pads), w.to(self.dtype), None,
                     self.stride, 0, self.dilation)
        return add_bias(y, b)


class WNConvTranspose1d(nn.Module):
    """Weight-normed ConvTranspose1d, normed per input channel. Causal: trim
    the tail to T*stride; otherwise trim ``padding`` from both ends."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0, bias: bool = True,
                 causal: bool = False, dtype: Dtype = None):
        super().__init__()
        self.stride, self.padding, self.causal = stride, padding, causal
        self.dtype = dtype
        self.deconv = WeightNormParams(in_channels, out_channels, kernel_size,
                                       out_channels if bias else 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            y = F.conv_transpose1d(x, self.deconv.weight(), self.deconv.bias,
                                   self.stride)
        else:
            y = add_bias(F.conv_transpose1d(
                x.to(self.dtype), self.deconv.weight().to(self.dtype), None,
                self.stride), self.deconv.bias)
        if self.causal:
            return y[:, :, :x.shape[-1] * self.stride]
        return y[:, :, self.padding:y.shape[-1] - self.padding]


class ResidualBlock(nn.Module):
    """MRF residual block: per dilation d, x += conv(act(conv_d(act(x))))."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5),
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: Optional[dict] = None,
                 causal: bool = False, dtype: Dtype = None):
        super().__init__()
        self.act = get_activation(nonlinear_activation,
                                  nonlinear_activation_params
                                  or {"negative_slope": 0.1})
        k = kernel_size
        self.convs1 = nn.ModuleList([
            WNConv1d(channels, channels, k, padding=(k * d - d) // 2,
                     dilation=d, causal=causal, dtype=dtype) for d in dilation])
        self.convs2 = nn.ModuleList([
            WNConv1d(channels, channels, k, padding=(k - 1) // 2,
                     causal=causal, dtype=dtype) for _ in dilation])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = c2(self.act(c1(self.act(x)))) + x
        return x


class SourceModule(nn.Module):
    """NSF harmonic-plus-noise excitation. pitch, uv (B, T, 1) at frame rate
    -> excitation (B, T * upsample_ratio, 1) in [-1, 1].

    With H = nb_harmonics + 1 harmonics of the upsampled f0, the phase is
    2 pi (cumsum(f0 h / sr) mod 1) (``phase_cycles``) plus a random initial
    phase per harmonic
    (0 for the fundamental); voiced samples take alpha sin(phase) plus
    sigma-scaled Gaussian noise, unvoiced ones the noise alone at alpha / 3 /
    sigma times its scale. The source is a constant to autograd; a weight-
    normed pointwise conv (``ffn.0``, KAN-TTS's name) mixes the harmonics,
    then tanh.

    The draws are made in the JAX package's order, the phase (B, 1, H) from
    U(-pi, pi) and then the noise (B, T * upsample_ratio, H) from N(0, 1),
    from ``generator``; ``phase`` and ``noise`` given replace them with
    those unscaled draws. With a compute ``dtype`` only the ``ffn`` conv runs
    in it: the phase sum and the draws stay float32.
    """

    def __init__(self, nb_harmonics: int, upsample_ratio: int,
                 sampling_rate: int, alpha: float = 0.1, sigma: float = 0.003,
                 dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        self.n_harmonics = nb_harmonics + 1
        self.upsample_ratio, self.sampling_rate = upsample_ratio, sampling_rate
        self.alpha, self.sigma = alpha, sigma
        self.ffn = nn.Sequential(
            WeightNormParams(1, self.n_harmonics, 1, bias_size=1), nn.Tanh())

    def phase_cycles(self, pitch: torch.Tensor) -> torch.Tensor:
        """pitch (B, T, 1) -> (B, T * upsample_ratio, H): the fractional part
        of the running sum of f0 h / sr over the upsampled samples.

        The upsampled f0 is constant over a frame's samples, so the sum at
        sample k of frame i is the sum over frames before i plus (k + 1)
        steps of frame i, and only its fractional part matters: each frame
        adds the fractional part of its steps. The float32 running sum then
        stays below T rather than growing to the harmonics' cycle count (a
        sample-by-sample float32 scan on the card drifts from the CPU's by
        up to half a cycle over 5 s at 24 kHz). The floored remainder is
        jnp's %."""
        B, T, _ = pitch.shape
        H, up = self.n_harmonics, self.upsample_ratio
        harmonics = torch.arange(1, H + 1, dtype=pitch.dtype, device=pitch.device)
        step = pitch * harmonics / self.sampling_rate  # (B, T, H), a sample's advance
        advance = torch.remainder(step * up, 1.0)  # a frame's, mod 1
        start = torch.remainder(torch.cumsum(advance, dim=1), 1.0)
        start = torch.cat([torch.zeros_like(start[:, :1]), start[:, :-1]], dim=1)
        k = torch.arange(1, up + 1, dtype=pitch.dtype, device=pitch.device)
        cycles = start[:, :, None, :] + k[:, None] * step[:, :, None, :]
        return torch.remainder(cycles, 1.0).reshape(B, T * up, H)

    def forward(self, pitch: torch.Tensor, uv: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                phase: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, _ = pitch.shape
        H, up = self.n_harmonics, self.upsample_ratio
        uv_s = uv.repeat_interleave(up, dim=1)  # (B, T*up, 1)
        theta = 2.0 * math.pi * self.phase_cycles(pitch)  # (B, T*up, H)
        if phase is None or noise is None:
            if generator is None:
                raise ValueError("the NSF source draws its phase and noise "
                                 "from a torch.Generator: pass generator=")
            phase = (torch.rand((B, 1, H), generator=generator, device=pitch.device,
                                dtype=pitch.dtype) * 2.0 - 1.0) * math.pi
            noise = torch.randn(theta.shape, generator=generator,
                                device=pitch.device, dtype=pitch.dtype)
        phase = torch.cat([torch.zeros_like(phase[..., :1]), phase[..., 1:]], dim=-1)
        noise = self.sigma * noise
        e_voice = self.alpha * torch.sin(theta + phase) + noise
        e_unvoice = self.alpha / 3.0 / self.sigma * noise
        e = (e_voice * uv_s + e_unvoice * (1.0 - uv_s)).detach()
        conv = self.ffn[0]
        if self.dtype is None:
            return self.ffn[1](F.linear(e, conv.weight()[:, :, 0], conv.bias))
        out = F.linear(e.to(self.dtype), conv.weight()[:, :, 0].to(self.dtype))
        return self.ffn[1](out + conv.bias.to(self.dtype))


@torch.no_grad()
def fold_weight_norm(module: nn.Module) -> nn.Module:
    """Fold g into v for every weight-normed conv (the analogue of
    ``remove_weight_norm``): v becomes the effective weight and g its norm,
    so the module computes the same function. Returns ``module``."""
    for m in module.modules():
        if isinstance(m, WeightNormParams):
            w = m.weight()
            m.weight_v.copy_(w)
            m.weight_g.copy_(torch.linalg.vector_norm(
                w, dim=tuple(range(1, w.ndim)), keepdim=True))
    return module


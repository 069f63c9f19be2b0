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
``use_weight_norm=False`` holds a plain ``weight`` instead of the pair.

int8 W8A8 (``quant``, serving only; the JAX layers' ``quant`` path): the
conv goes through ``ops.int8_conv.int8_conv1d`` (kernel K2 on the card)
with per-output-channel weight scales and a dynamic per-example activation
scale, or with ``quant_static`` the static scale in the ``s_x`` buffer (the
JAX ``quant`` collection). ``quantize_weights`` quantizes the weights once,
after they are loaded and folded, and packs them once in K2's layout
(``pack_weight``); the parameters are not touched. While
``calibrate`` is set the conv runs in float32 and records the running
max(|x|) / 127 into ``s_x``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import math

import torch
import torch.nn.functional as F
from torch import nn

from kantts_tpu_torch.ops.int8_conv import (
    div127,
    int8_conv1d,
    pack_weight,
    quantize_weight,
)
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


class PlainConvParams(nn.Module):
    """``weight`` (d0, d1, k) and an optional ``bias``: a conv's parameters
    without weight norm (the reference's plain layout)."""

    def __init__(self, d0: int, d1: int, kernel_size: int, bias_size: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d0, d1, kernel_size))
        self.bias = nn.Parameter(torch.zeros(bias_size)) if bias_size else None


def conv_params(d0: int, d1: int, kernel_size: int, bias_size: int,
                use_weight_norm: bool) -> nn.Module:
    if use_weight_norm:
        return WeightNormParams(d0, d1, kernel_size, bias_size)
    return PlainConvParams(d0, d1, kernel_size, bias_size)


def effective_weight(params: nn.Module) -> torch.Tensor:
    """The weight a conv uses: normed, or the plain one."""
    if isinstance(params, WeightNormParams):
        return params.weight()
    return params.weight


class Int8ConvMixin:
    """int8 state of a conv: the flags, the static scale ``s_x`` (a buffer
    with ``quant_static`` or ``calibrate``, in the state dict), the
    quantized weight ``w_q`` with its scales ``s_w``, and ``w_p``, w_q
    packed in the layout K2 reads, which the conv uses (buffers kept out of
    the state dict, made by ``quantize_weights``)."""

    transposed = False

    def _init_int8(self, quant: bool, quant_static: bool, calibrate: bool) -> None:
        self.quant, self.quant_static, self.calibrate = quant, quant_static, calibrate
        if quant and (quant_static or calibrate):
            self.register_buffer("s_x", torch.zeros(()))
        self.register_buffer("w_q", None, persistent=False)
        self.register_buffer("s_w", None, persistent=False)
        self.register_buffer("w_p", None, persistent=False)

    @torch.no_grad()
    def quantize_weight_(self) -> None:
        self.w_q, self.s_w = quantize_weight(
            effective_weight(self.params).float(), self.transposed)
        self.w_p = pack_weight(self.w_q, self.transposed, self.stride)

    def _int8_ready(self, x: torch.Tensor) -> bool:
        """True: run the int8 conv; False: the float path (no ``quant``, or
        calibrating, which records the scale first)."""
        if not self.quant:
            return False
        if self.calibrate:
            with torch.no_grad():
                self.s_x.copy_(torch.maximum(self.s_x, div127(x.abs().amax())))
            return False
        if self.w_q is None:
            raise RuntimeError("int8 conv without int8 weights: call "
                               "quantize_weights(module) after loading the weights")
        if x.dtype != torch.float32:
            raise ValueError(f"the int8 conv takes float32 input, got {x.dtype}")
        return True

    def _int8(self, x: torch.Tensor, pad_left: int, pad_right: int, stride: int,
              dilation: int, causal: bool) -> torch.Tensor:
        return int8_conv1d(x.contiguous(), self.w_p, self.s_w, self.params.bias,
                           self.s_x if self.quant_static else None, self.w_q.shape[2],
                           stride, dilation, pad_left, pad_right, self.transposed,
                           causal)


class WNConv1d(Int8ConvMixin, nn.Module):
    """Weight-normed Conv1d. ``causal``: left pad (k-1)*dilation; otherwise
    ``padding`` frames on both sides."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = True, causal: bool = False, dtype: Dtype = None,
                 use_weight_norm: bool = True, quant: bool = False,
                 quant_static: bool = False, calibrate: bool = False):
        super().__init__()
        self.stride, self.dilation, self.dtype = stride, dilation, dtype
        self.pads = (((kernel_size - 1) * dilation, 0) if causal
                     else (padding, padding))
        self.conv1d = conv_params(out_channels, in_channels, kernel_size,
                                  out_channels if bias else 0, use_weight_norm)
        self._init_int8(quant, quant_static, calibrate)

    @property
    def params(self) -> nn.Module:
        return self.conv1d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._int8_ready(x):
            return self._int8(x, *self.pads, self.stride, self.dilation, False)
        w, b = effective_weight(self.conv1d), self.conv1d.bias
        if self.dtype is None:
            return F.conv1d(F.pad(x, self.pads), w, b, self.stride, 0, self.dilation)
        y = F.conv1d(F.pad(x.to(self.dtype), self.pads), w.to(self.dtype), None,
                     self.stride, 0, self.dilation)
        return add_bias(y, b)


class WNConvTranspose1d(Int8ConvMixin, nn.Module):
    """Weight-normed ConvTranspose1d, normed per input channel. Causal: trim
    the tail to T*stride; otherwise trim ``padding`` from both ends."""

    transposed = True

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0, bias: bool = True,
                 causal: bool = False, dtype: Dtype = None,
                 use_weight_norm: bool = True, quant: bool = False,
                 quant_static: bool = False, calibrate: bool = False):
        super().__init__()
        self.stride, self.padding, self.causal = stride, padding, causal
        self.dtype = dtype
        self.deconv = conv_params(in_channels, out_channels, kernel_size,
                                  out_channels if bias else 0, use_weight_norm)
        self._init_int8(quant, quant_static, calibrate)

    @property
    def params(self) -> nn.Module:
        return self.deconv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._int8_ready(x):
            return self._int8(x, self.padding, self.padding, self.stride, 1,
                              self.causal)
        w = effective_weight(self.deconv)
        if self.dtype is None:
            y = F.conv_transpose1d(x, w, self.deconv.bias, self.stride)
        else:
            y = add_bias(F.conv_transpose1d(
                x.to(self.dtype), w.to(self.dtype), None,
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
                 causal: bool = False, dtype: Dtype = None, **int8):
        super().__init__()
        self.act = get_activation(nonlinear_activation,
                                  nonlinear_activation_params
                                  or {"negative_slope": 0.1})
        k = kernel_size
        self.convs1 = nn.ModuleList([
            WNConv1d(channels, channels, k, padding=(k * d - d) // 2,
                     dilation=d, causal=causal, dtype=dtype, **int8)
            for d in dilation])
        self.convs2 = nn.ModuleList([
            WNConv1d(channels, channels, k, padding=(k - 1) // 2,
                     causal=causal, dtype=dtype, **int8) for _ in dilation])

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


def quantize_weights(module: nn.Module) -> nn.Module:
    """Quantize the weights of every int8 conv in ``module`` from its current
    (folded) weight, once: per output channel, as the JAX layers do on every
    call. Call it after loading and folding the weights; the int8 buffers
    then move with the module. Returns ``module``."""
    for m in module.modules():
        if isinstance(m, Int8ConvMixin) and m.quant:
            m.quantize_weight_()
    return module

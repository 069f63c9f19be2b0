"""HiFi-GAN discriminators (counterpart of
``kantts_tpu/models/hifigan/discriminators.py``): MultiPeriodDiscriminator,
MultiScaleDiscriminator with the db3 wavelet between scales, and
MultiSpecDiscriminator on STFT magnitudes, with weight- and spectral-normed
convolutions.

Layout is torch's: a discriminator takes a waveform (B, 1, T) and returns
(score (B, n), feature maps), each map (B, C, T') or, in a period
discriminator, (B, C, T / period, period), in a spectral discriminator
(B, C, frames, W). Parameter names follow the KAN-TTS state dict
(``discriminators.{i}.convs.{j}.0``, ``conv_post``, ``aux_convs.{i}``), so
``kantts_tpu.utils.torch_convert.convert_mpd`` and ``convert_msd`` read
them; the spectral discriminators take the same pattern.

Spectral norm follows the JAX package, not ``torch.nn.utils.spectral_norm``:
every forward runs one power iteration from the stored ``weight_u`` without
gradient and divides the weight by the detached sigma; the new ``u`` is
stored only when the caller passes ``update_stats=True``.

``dtype`` (bf16 under ``mixed_precision``) is every conv's compute dtype,
as in ``layers.py``: the weight norm, the spectral norm's power iteration
and its ``weight_u`` stay float32, the db3 filters take the waveform's
dtype, and the STFT magnitudes are float32 before the first conv casts
them. Scores and feature maps come out in the dtype.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kantts_tpu_torch.dsp.stft import hann_window, stft_magnitude
from kantts_tpu_torch.models.hifigan.layers import (
    get_activation,
    leaky_relu,
    weight_norm,
)
from kantts_tpu_torch.utils.precision import Dtype, add_bias

Output = Tuple[List[torch.Tensor], List[List[torch.Tensor]]]
_DIRECTION = {"weight": "weight_v", "spectral": "weight_orig", "none": "weight"}


class NormConv(nn.Module):
    """1-D or 2-D convolution with ``norm`` "weight" (parameters
    ``weight_v``, ``weight_g``), "spectral" (parameter ``weight_orig``,
    buffer ``weight_u``) or "none" (parameter ``weight``), and a ``bias``.
    Padding is symmetric, one entry per spatial axis."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Sequence[int], stride: Sequence[int],
                 padding: Sequence[int], groups: int = 1, bias: bool = True,
                 norm: str = "weight", dtype: Dtype = None):
        super().__init__()
        shape = (out_channels, in_channels // groups, *kernel_size)
        self.norm, self.dtype = norm, dtype
        self.stride, self.padding, self.groups = tuple(stride), tuple(padding), groups
        self.conv = {1: F.conv1d, 2: F.conv2d}[len(kernel_size)]
        if norm == "weight":
            self.weight_v = nn.Parameter(torch.empty(shape))
            self.weight_g = nn.Parameter(torch.ones(out_channels,
                                                    *(1,) * (len(shape) - 1)))
        elif norm == "spectral":
            self.weight_orig = nn.Parameter(torch.empty(shape))
            self.register_buffer("weight_u", torch.zeros(out_channels))
        elif norm == "none":
            self.weight = nn.Parameter(torch.empty(shape))
        else:
            raise ValueError(f"Unknown norm: {norm}")
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    @property
    def direction(self) -> nn.Parameter:
        """The unnormalised weight parameter."""
        return getattr(self, _DIRECTION[self.norm])

    def spectral_weight(self, update_stats: bool) -> torch.Tensor:
        v = self.weight_orig
        with torch.no_grad():
            w_mat = v.reshape(v.shape[0], -1)
            vvec = w_mat.T @ self.weight_u
            vvec = vvec / (torch.linalg.vector_norm(vvec) + 1e-12)
            u = w_mat @ vvec
            u = u / (torch.linalg.vector_norm(u) + 1e-12)
            sigma = u @ (w_mat @ vvec)
            if update_stats:
                self.weight_u.copy_(u)
        return v / sigma

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        if self.norm == "weight":
            w = weight_norm(self.weight_v, self.weight_g)
        elif self.norm == "spectral":
            w = self.spectral_weight(update_stats)
        else:
            w = self.weight
        if self.dtype is None:
            return self.conv(x, w, self.bias, self.stride, self.padding, 1,
                             self.groups)
        y = self.conv(x.to(self.dtype), w.to(self.dtype), None, self.stride,
                      self.padding, 1, self.groups)
        return add_bias(y, self.bias)


def _conv_act(conv: NormConv, act: nn.Module) -> nn.Sequential:
    """A conv and its activation, indexed ``.0`` and ``.1`` as in KAN-TTS."""
    return nn.Sequential(conv, act)


def _run(layer: nn.Sequential, x: torch.Tensor, update_stats: bool) -> torch.Tensor:
    return layer[1](layer[0](x, update_stats))


# Daubechies-3 decomposition low-pass filter; the high pass is its
# quadrature mirror, hi[k] = (-1)^k lo[N-1-k]
_DB3_DEC_LO = np.array([0.035226291882100656, -0.08544127388224149,
                        -0.13501102001039084, 0.4598775021193313,
                        0.8068915093133388, 0.3326705529509569])
_DB3_DEC_HI = np.array([(-1) ** k * _DB3_DEC_LO[len(_DB3_DEC_LO) - 1 - k]
                        for k in range(len(_DB3_DEC_LO))])


def db3_filters() -> torch.Tensor:
    """(2, 1, 6) float32: the time-reversed db3 low and high pass, the
    correlation kernels of the analysis filter bank."""
    return torch.from_numpy(np.stack([_DB3_DEC_LO[::-1], _DB3_DEC_HI[::-1]])
                            [:, None, :].astype(np.float32))


def dwt1d_db3(x: torch.Tensor, filters: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level of the db3 DWT of (B, 1, T) -> (lo, hi), each
    (B, 1, (T + 4) // 2 + 1): stride-2 correlation with ``db3_filters()``,
    zero padding 5 on each side, in x's dtype."""
    y = F.conv1d(x, filters.to(x.dtype), stride=2, padding=len(_DB3_DEC_LO) - 1)
    return y[:, :1], y[:, 1:]


class PeriodDiscriminator(nn.Module):
    """The waveform reflect-padded to a multiple of ``period`` and folded to
    (B, C, T / period, period); (k0, 1) convs down the time axis; a plain
    ``conv_post`` with kernel (k1 - 1, 1) and padding (k1 - 1) // 2, as in
    KAN-TTS."""

    def __init__(self, period: int = 3, in_channels: int = 1,
                 out_channels: int = 1, kernel_sizes: Sequence[int] = (5, 3),
                 channels: int = 32,
                 downsample_scales: Sequence[int] = (3, 3, 3, 3, 1),
                 max_downsample_channels: int = 1024, bias: bool = True,
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: Optional[dict] = None,
                 use_spectral_norm: bool = False, dtype: Dtype = None):
        super().__init__()
        del bias  # every conv has a bias, as in the JAX package
        self.period = period
        act_params = nonlinear_activation_params or {"negative_slope": 0.1}
        norm = "spectral" if use_spectral_norm else "weight"
        k0, k1 = kernel_sizes
        self.convs = nn.ModuleList()
        in_chs, out_chs = in_channels, channels
        for scale in downsample_scales:
            self.convs.append(_conv_act(
                NormConv(in_chs, out_chs, (k0, 1), (scale, 1), ((k0 - 1) // 2, 0),
                         norm=norm, dtype=dtype),
                get_activation(nonlinear_activation, act_params)))
            in_chs = out_chs
            out_chs = min(out_chs * 4, max_downsample_channels)
        self.conv_post = NormConv(in_chs, out_channels, (k1 - 1, 1), (1, 1),
                                  ((k1 - 1) // 2, 0), norm="none", dtype=dtype)

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        B, C, T = x.shape
        p = self.period
        if T % p:
            x = F.pad(x, (0, p - T % p), mode="reflect")
        x = x.reshape(B, C, -1, p)
        fmap = []
        for layer in self.convs:
            x = _run(layer, x, update_stats)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(B, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 discriminator_params: Optional[dict] = None, dtype: Dtype = None):
        super().__init__()
        params = dict(discriminator_params or {})
        self.discriminators = nn.ModuleList(
            [PeriodDiscriminator(period=p, dtype=dtype, **params) for p in periods])

    def forward(self, y: torch.Tensor, update_stats: bool = False) -> Output:
        outs, fmaps = [], []
        for d in self.discriminators:
            score, fmap = d(y, update_stats)
            outs.append(score)
            fmaps.append(fmap)
        return outs, fmaps


class ScaleDiscriminator(nn.Module):
    """A k0 conv, grouped k1 convs down ``downsample_scales`` (groups 4, then
    x4 up to ``max_groups``; channels x2 up to ``max_downsample_channels``),
    a k2 conv and a k3 ``conv_post``."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 kernel_sizes: Sequence[int] = (15, 41, 5, 3),
                 channels: int = 128, max_downsample_channels: int = 1024,
                 max_groups: int = 16, bias: bool = True,
                 downsample_scales: Sequence[int] = (2, 2, 4, 4, 1),
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: Optional[dict] = None,
                 use_spectral_norm: bool = False, dtype: Dtype = None):
        super().__init__()
        if len(kernel_sizes) != 4:
            raise ValueError("ScaleDiscriminator takes 4 kernel sizes")
        act_params = nonlinear_activation_params or {"negative_slope": 0.1}
        norm = "spectral" if use_spectral_norm else "weight"
        k0, k1, k2, k3 = kernel_sizes

        def layer(cin, cout, k, stride=1, groups=1):
            return _conv_act(
                NormConv(cin, cout, (k,), (stride,), ((k - 1) // 2,), groups,
                         bias, norm, dtype),
                get_activation(nonlinear_activation, act_params))

        self.convs = nn.ModuleList([layer(in_channels, channels, k0)])
        cur, out_chs, groups = channels, channels, 4
        for scale in downsample_scales:
            self.convs.append(layer(cur, out_chs, k1, scale, groups))
            cur = out_chs
            out_chs = min(cur * 2, max_downsample_channels)
            groups = min(groups * 4, max_groups)
        self.convs.append(layer(cur, out_chs, k2))
        self.conv_post = NormConv(out_chs, out_channels, (k3,), (1,),
                                  ((k3 - 1) // 2,), 1, bias, norm, dtype)

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        fmap = []
        for layer in self.convs:
            x = _run(layer, x, update_stats)
            fmap.append(x)
        x = self.conv_post(x, update_stats)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


class MultiScaleDiscriminator(nn.Module):
    """``scales`` scale discriminators; between two scales the waveform is
    halved by the db3 DWT (lo and hi concatenated, then a weight-normed k=15
    ``aux_convs.{i}`` and leaky ReLU 0.1) or, with any other
    ``downsample_pooling``, by average pooling (window 4, stride 2, zero
    padding 2 counted in the mean). ``follow_official_norm`` spectral-norms
    scale 0 and weight-norms the others."""

    def __init__(self, scales: int = 3, downsample_pooling: str = "DWT",
                 downsample_pooling_params: Optional[dict] = None,
                 discriminator_params: Optional[dict] = None,
                 follow_official_norm: bool = False, dtype: Dtype = None):
        super().__init__()
        del downsample_pooling_params  # the pooling is fixed, as in the JAX package
        params = dict(discriminator_params or {})
        self.discriminators = nn.ModuleList()
        for i in range(scales):
            p = dict(params)
            if follow_official_norm:
                p["use_spectral_norm"] = i == 0
            self.discriminators.append(ScaleDiscriminator(dtype=dtype, **p))
        self.dwt = downsample_pooling == "DWT"
        if self.dwt:
            self.aux_convs = nn.ModuleList([
                NormConv(2, 1, (15,), (1,), (7,), dtype=dtype)
                for _ in range(scales - 1)])
            self.register_buffer("db3", db3_filters(), persistent=False)

    def forward(self, y: torch.Tensor, update_stats: bool = False) -> Output:
        outs, fmaps = [], []
        for i, d in enumerate(self.discriminators):
            if i:
                if self.dwt:
                    y = torch.cat(dwt1d_db3(y, self.db3), dim=1)
                    y = leaky_relu(self.aux_convs[i - 1](y), 0.1)
                else:
                    y = F.avg_pool1d(y, 4, 2, padding=2, count_include_pad=True)
            score, fmap = d(y, update_stats)
            outs.append(score)
            fmaps.append(fmap)
        return outs, fmaps


class SpecDiscriminator(nn.Module):
    """2-D convs over the magnitude STFT of the detached waveform. The
    frequency bins are the input channels over a (frames, 1) grid: a
    (init_kernel, 1) conv, three (kernel_size, 1) convs at stride
    (stride, 1), a (5, 1) conv and a (3, 1) ``conv_post``. As in the JAX
    package (and torch's integer padding), every conv but ``conv_post`` pads
    the unit-wide axis too, which so widens conv by conv (to 49 columns at
    the defaults); the score is column 0 of ``conv_post``'s output."""

    def __init__(self, channels: int = 32, init_kernel: int = 15,
                 kernel_size: int = 11, stride: int = 2,
                 use_spectral_norm: bool = False, fft_size: int = 1024,
                 shift_size: int = 120, win_length: int = 600,
                 window: str = "hann_window",
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: Optional[dict] = None,
                 dtype: Dtype = None):
        super().__init__()
        if window != "hann_window":
            raise ValueError(f"{window} window is not implemented")
        self.fft_size, self.shift_size, self.win_length = fft_size, shift_size, win_length
        self.register_buffer("window", torch.from_numpy(hann_window(win_length)),
                             persistent=False)
        act_params = nonlinear_activation_params or {"negative_slope": 0.1}
        norm = "spectral" if use_spectral_norm else "weight"

        def layer(cin, k, stride_, pad):
            return _conv_act(NormConv(cin, channels, (k, 1), (stride_, 1), (pad, pad),
                                      norm=norm, dtype=dtype),
                             get_activation(nonlinear_activation, act_params))

        p0, p = (init_kernel - 1) // 2, (kernel_size - 1) // 2
        self.convs = nn.ModuleList(
            [layer(fft_size // 2 + 1, init_kernel, 1, p0)]
            + [layer(channels, kernel_size, stride, p) for _ in range(3)]
            + [layer(channels, 5, 1, 2)])
        self.conv_post = NormConv(channels, 1, (3, 1), (1, 1), (1, 0), norm=norm,
                                  dtype=dtype)

    def forward(self, y: torch.Tensor, update_stats: bool = False):
        mag = stft_magnitude(y[:, 0].detach(), self.fft_size, self.shift_size,
                             self.win_length, self.window)  # (B, frames, freq)
        x = mag.transpose(1, 2)[..., None]  # (B, freq, frames, 1)
        fmap = []
        for layer in self.convs:
            x = _run(layer, x, update_stats)
            fmap.append(x)
        x = self.conv_post(x, update_stats)
        fmap.append(x)
        return x[:, 0, :, 0], fmap


class MultiSpecDiscriminator(nn.Module):
    """One ``SpecDiscriminator`` per STFT resolution. ``kernel_sizes`` in
    ``discriminator_params`` is dropped, as the JAX package drops it."""

    def __init__(self, fft_sizes: Sequence[int] = (1024, 2048, 512),
                 hop_sizes: Sequence[int] = (120, 240, 50),
                 win_lengths: Sequence[int] = (600, 1200, 240),
                 discriminator_params: Optional[dict] = None, dtype: Dtype = None):
        super().__init__()
        params = dict(discriminator_params or {})
        params.pop("kernel_sizes", None)
        self.discriminators = nn.ModuleList([
            SpecDiscriminator(fft_size=f, shift_size=h, win_length=w, dtype=dtype,
                              **params)
            for f, h, w in zip(fft_sizes, hop_sizes, win_lengths)])

    def forward(self, y: torch.Tensor, update_stats: bool = False) -> Output:
        outs, fmaps = [], []
        for d in self.discriminators:
            score, fmap = d(y, update_stats)
            outs.append(score)
            fmaps.append(fmap)
        return outs, fmaps


DISCRIMINATOR_CLASSES: Dict[str, type] = {
    "MultiScaleDiscriminator": MultiScaleDiscriminator,
    "MultiPeriodDiscriminator": MultiPeriodDiscriminator,
    "MultiSpecDiscriminator": MultiSpecDiscriminator,
}

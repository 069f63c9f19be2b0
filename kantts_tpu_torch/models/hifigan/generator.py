"""HiFi-GAN generator, non-NSF (counterpart of
``kantts_tpu/models/hifigan/generator.py``).

Per upsample stage i:
  h   = sin(h) + h
  rep = conv(act(nearest_upsample(h)))      repeat path
  up  = deconv(act(h))                      transposed-conv path
  h   = rep + up[:rep_len]
  h   = mean_j resblock_j(h)                multi-receptive-field fusion
then leaky_relu with slope 0.01 -> conv_post -> tanh. Module indexes follow
the KAN-TTS state-dict layout (``repeat_upsamples.{i}.2.conv1d``,
``transpose_upsamples.{i}.1.deconv``, ``conv_blocks.{i*n_res+j}``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from kantts_tpu_torch.models.hifigan.layers import (
    ResidualBlock,
    WNConv1d,
    WNConvTranspose1d,
    get_activation,
)


class Generator(nn.Module):
    def __init__(self, in_channels: int = 80, out_channels: int = 1,
                 channels: int = 512, kernel_size: int = 7,
                 upsample_scales: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernal_sizes: Sequence[int] = (16, 16, 4, 4),
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilations: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 repeat_upsample: bool = True, bias: bool = True,
                 causal: bool = True, nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: Optional[dict] = None,
                 use_weight_norm: bool = True, nsf_params: Optional[dict] = None):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("kernel_size must be odd")
        # repeat_upsample is accepted for config compatibility: the dual
        # path always runs, as in the JAX package
        if nsf_params is not None or not use_weight_norm:
            raise NotImplementedError(
                "not ported yet: NSF and generators without weight norm")
        act_params = nonlinear_activation_params or {"negative_slope": 0.1}
        k = kernel_size
        self.n_res = len(resblock_kernel_sizes)
        self.conv_pre = WNConv1d(in_channels, channels, k,
                                 padding=(k - 1) // 2, bias=bias, causal=causal)
        self.repeat_upsamples = nn.ModuleList()
        self.transpose_upsamples = nn.ModuleList()
        self.conv_blocks = nn.ModuleList()
        ch_in = channels
        for i, (scale, up_k) in enumerate(zip(upsample_scales,
                                              upsample_kernal_sizes)):
            ch = channels // (2 ** (i + 1))
            self.repeat_upsamples.append(nn.Sequential(
                nn.Upsample(scale_factor=scale, mode="nearest"),
                get_activation(nonlinear_activation, act_params),
                WNConv1d(ch_in, ch, k, padding=(k - 1) // 2, bias=bias,
                         causal=causal)))
            self.transpose_upsamples.append(nn.Sequential(
                get_activation(nonlinear_activation, act_params),
                WNConvTranspose1d(ch_in, ch, up_k, scale,
                                  padding=(up_k - scale) // 2, causal=causal)))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilations):
                self.conv_blocks.append(ResidualBlock(
                    ch, rk, tuple(rd), nonlinear_activation, act_params, causal))
            ch_in = ch
        self.conv_post = WNConv1d(ch_in, out_channels, k, padding=(k - 1) // 2,
                                  bias=bias, causal=causal)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, T, in_channels) -> (B, T * prod(upsample_scales),
        out_channels) in [-1, 1]."""
        h = self.conv_pre(mel.transpose(1, 2))
        for i, (rep_up, tr_up) in enumerate(zip(self.repeat_upsamples,
                                                self.transpose_upsamples)):
            h = torch.sin(h) + h
            rep = rep_up(h)
            h = rep + tr_up(h)[:, :, :rep.shape[-1]]
            blocks = self.conv_blocks[i * self.n_res:(i + 1) * self.n_res]
            acc = blocks[0](h)
            for block in blocks[1:]:
                acc = acc + block(h)
            h = acc / self.n_res
        h = self.conv_post(F.leaky_relu(h, 0.01))
        return torch.tanh(h).transpose(1, 2)

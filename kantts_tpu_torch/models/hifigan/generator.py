"""HiFi-GAN generator (counterpart of
``kantts_tpu/models/hifigan/generator.py``).

Per upsample stage i:
  h   = sin(h) + h
  rep = conv(act(nearest_upsample(h)))      repeat path
  up  = deconv(act(h))                      transposed-conv path
  h   = rep (+ source_downs_i(e)) + up[:rep_len]
  h   = mean_j resblock_j(h)                multi-receptive-field fusion
then leaky_relu with slope 0.01 -> conv_post -> tanh. Module indexes follow
the KAN-TTS state-dict layout (``repeat_upsamples.{i}.2.conv1d``,
``transpose_upsamples.{i}.1.deconv``, ``conv_blocks.{i*n_res+j}``,
``source_module.ffn.0``, ``source_downs.{i}.conv1d``).

NSF (``nsf_params``): the input's last two channels are f0 and uv; the
``SourceModule`` turns them into a sample-rate excitation e, which stage i
sees through ``source_downs_i``, a strided conv down to that stage's rate.
With ``out_channels`` > 1 the output is the PQMF sub-band signal
(``models/pqmf.py`` synthesises the full band).

``dtype`` (bf16 under ``mixed_precision``) is the compute dtype of every
conv, the source's ``ffn`` included; the stream between them stays in it and
the output is in it, as in the JAX package. Parameters stay float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from kantts_tpu_torch.models.hifigan.layers import (
    ResidualBlock,
    SourceModule,
    WNConv1d,
    WNConvTranspose1d,
    get_activation,
    leaky_relu,
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
                 use_weight_norm: bool = True, nsf_params: Optional[dict] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("kernel_size must be odd")
        # repeat_upsample is accepted for config compatibility: the dual
        # path always runs, as in the JAX package
        if not use_weight_norm:
            raise NotImplementedError(
                "not ported yet: generators without weight norm")
        act_params = nonlinear_activation_params or {"negative_slope": 0.1}
        k = kernel_size
        # what streaming and chunked inference read (infer/streaming.py)
        self.causal, self.kernel_size = causal, kernel_size
        self.out_channels = out_channels
        self.upsample_scales = tuple(upsample_scales)
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilations = tuple(tuple(d) for d in resblock_dilations)
        self.n_res = len(resblock_kernel_sizes)
        self.dtype = dtype
        self.nsf_params = dict(nsf_params) if nsf_params is not None else None
        if self.nsf_params is not None:
            hop = int(np.prod(upsample_scales))
            self.source_module = SourceModule(self.nsf_params["nb_harmonics"], hop,
                                              self.nsf_params["sampling_rate"],
                                              dtype=dtype)
            # stage i runs at 1 / prod(scales[i+1:]) of the sample rate
            downs = np.cumprod([1] + list(upsample_scales[::-1][:-1]))[::-1]
            self.source_downs = nn.ModuleList()
        self.conv_pre = WNConv1d(in_channels, channels, k, padding=(k - 1) // 2,
                                 bias=bias, causal=causal, dtype=dtype)
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
                         causal=causal, dtype=dtype)))
            self.transpose_upsamples.append(nn.Sequential(
                get_activation(nonlinear_activation, act_params),
                WNConvTranspose1d(ch_in, ch, up_k, scale,
                                  padding=(up_k - scale) // 2, causal=causal,
                                  dtype=dtype)))
            if self.nsf_params is not None:
                u = int(downs[i])
                self.source_downs.append(
                    WNConv1d(1, ch, 1, dtype=dtype) if u == 1 else
                    WNConv1d(1, ch, 2 * u, stride=u, padding=u // 2,
                             causal=causal, dtype=dtype))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilations):
                self.conv_blocks.append(ResidualBlock(
                    ch, rk, tuple(rd), nonlinear_activation, act_params, causal,
                    dtype))
            ch_in = ch
        self.conv_post = WNConv1d(ch_in, out_channels, k, padding=(k - 1) // 2,
                                  bias=bias, causal=causal, dtype=dtype)

    def forward(self, x: torch.Tensor, excitation: Optional[torch.Tensor] = None,
                excitation_only: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, T, C): the mel, for NSF with f0 and uv as its last two
        channels -> (B, T * prod(upsample_scales), out_channels) in [-1, 1],
        in the compute dtype.

        NSF only: the source's draws come from ``generator``;
        ``excitation_only=True`` returns the source (B, T * hop, 1) alone, and
        ``excitation=`` injects a precomputed one instead of drawing (the
        chunked path windows one source computed on the whole utterance)."""
        if self.nsf_params is None:
            if excitation is not None or excitation_only:
                raise ValueError("excitation paths are NSF-only")
            mel = x
        else:
            mel = x[:, :, :-2]
            if excitation is None:
                excitation = self.source_module(x[:, :, -2:-1], x[:, :, -1:],
                                                generator=generator)
            if excitation_only:
                return excitation
            e_in = excitation.transpose(1, 2)
        h = self.conv_pre(mel.transpose(1, 2))
        for i, (rep_up, tr_up) in enumerate(zip(self.repeat_upsamples,
                                                self.transpose_upsamples)):
            h = torch.sin(h) + h
            rep = rep_up(h)
            n = rep.shape[-1]
            if self.nsf_params is None:
                h = rep + tr_up(h)[:, :, :n]
            else:
                h = rep + self.source_downs[i](e_in)[:, :, :n] + tr_up(h)[:, :, :n]
            blocks = self.conv_blocks[i * self.n_res:(i + 1) * self.n_res]
            acc = blocks[0](h)
            for block in blocks[1:]:
                acc = acc + block(h)
            h = acc / self.n_res
        h = self.conv_post(leaky_relu(h, 0.01))
        return torch.tanh(h).transpose(1, 2)

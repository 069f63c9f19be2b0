"""Plain PyTorch HiFi-GAN generator of KAN-TTS, with the NSF source.

Written from the published model (KAN-TTS ``kantts/models/hifigan``), in
functional form over a dict of weights in the KAN-TTS state-dict layout. It
imports nothing of the measured program, holds no kernels, no batching and
no cache, and computes in float32; the caller sets the TF32 flags.

Per upsample stage i, on (B, C, T):
  h   = sin(h) + h
  rep = conv7(lrelu(nearest_upsample(h, s_i)))        the repeat path
  up  = deconv(lrelu(h))[:, :, :len(rep)]             the transposed path
  h   = rep (+ source_down_i(e)) + up
  h   = mean_j resblock_j(h)
then lrelu(0.01) -> conv_post -> tanh. Each conv is weight-normed,
w = g v / |v| with the norm over every axis but 0 (the input channel for a
transposed conv). Causal convs pad (k-1)*dilation on the left; a causal
transposed conv keeps the first T*stride samples.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]

NSF_ALPHA, NSF_SIGMA = 0.1, 0.003


def hop(params: dict) -> int:
    return int(math.prod(params["upsample_scales"]))


def source_strides(params: dict) -> List[int]:
    """Stage i runs at 1 / prod(scales[i+1:]) of the sample rate."""
    scales = list(params["upsample_scales"])
    return [int(math.prod(scales[i + 1:])) for i in range(len(scales))]


def param_shapes(params: dict) -> Dict[str, Tuple[int, ...]]:
    """name -> shape of every weight of the generator, KAN-TTS layout:
    ``<conv>.conv1d.{weight_v, weight_g, bias}`` (``.deconv`` for the
    transposed convs)."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def wn(name: str, d0: int, d1: int, k: int, bias: int) -> None:
        shapes[f"{name}.weight_v"] = (d0, d1, k)
        shapes[f"{name}.weight_g"] = (d0, 1, 1)
        if bias:
            shapes[f"{name}.bias"] = (bias,)

    k, ch = params["kernel_size"], params["channels"]
    nsf = params.get("nsf_params")
    if nsf is not None:
        wn("source_module.ffn.0", 1, nsf["nb_harmonics"] + 1, 1, 1)
    wn("conv_pre.conv1d", ch, params["in_channels"], k, ch)
    ch_in = ch
    n_res = len(params["resblock_kernel_sizes"])
    for i, (s, up_k) in enumerate(zip(params["upsample_scales"],
                                      params["upsample_kernal_sizes"])):
        c = ch // 2 ** (i + 1)
        wn(f"repeat_upsamples.{i}.2.conv1d", c, ch_in, k, c)
        wn(f"transpose_upsamples.{i}.1.deconv", ch_in, c, up_k, c)
        if nsf is not None:
            u = source_strides(params)[i]
            wn(f"source_downs.{i}.conv1d", c, 1, 1 if u == 1 else 2 * u, c)
        for j, (rk, rd) in enumerate(zip(params["resblock_kernel_sizes"],
                                         params["resblock_dilations"])):
            for n in range(len(rd)):
                for part in ("convs1", "convs2"):
                    wn(f"conv_blocks.{i * n_res + j}.{part}.{n}.conv1d", c, c, rk, c)
        ch_in = c
    wn("conv_post.conv1d", params["out_channels"], ch_in, k, params["out_channels"])
    return shapes


def _w(p: Weights, name: str) -> torch.Tensor:
    v, g = p[f"{name}.weight_v"], p[f"{name}.weight_g"]
    return g * v / torch.linalg.vector_norm(v, dim=tuple(range(1, v.ndim)),
                                            keepdim=True)


def _conv(x: torch.Tensor, p: Weights, name: str, causal: bool, dilation: int = 1,
          stride: int = 1, padding: Optional[int] = None) -> torch.Tensor:
    w = _w(p, name)
    k = w.shape[-1]
    if causal:
        pads = ((k - 1) * dilation, 0)
    else:
        pad = (k - 1) * dilation // 2 if padding is None else padding
        pads = (pad, pad)
    return F.conv1d(F.pad(x, pads), w, p.get(f"{name}.bias"), stride, 0, dilation)


def _lrelu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def nsf_draws(batch: int, frames: int, params: dict, device,
              seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The NSF source's draws for a call on a (batch, frames) input, as a
    ``torch.Generator`` seeded ``seed`` gives them: the initial phases
    U(-pi, pi) of shape (batch, 1, H), then the noise N(0, 1) of shape
    (batch, frames * hop, H)."""
    H = params["nsf_params"]["nb_harmonics"] + 1
    g = torch.Generator(device=device).manual_seed(seed)
    phase = (torch.rand((batch, 1, H), generator=g, device=device) * 2.0 - 1.0) * math.pi
    noise = torch.randn((batch, frames * hop(params), H), generator=g, device=device)
    return phase, noise


def nsf_source(f0: torch.Tensor, uv: torch.Tensor, phase: torch.Tensor,
               noise: torch.Tensor, p: Weights, params: dict) -> torch.Tensor:
    """Harmonic-plus-noise excitation. f0 (B, T) in Hz and uv (B, T) in
    {0, 1} at frame rate -> (B, 1, T * hop).

    Harmonic h has the phase 2 pi (running sum of f0 h / sr over the
    samples, mod 1) plus a random start (0 for the fundamental). The sum is
    taken frame by frame (f0 is constant over a frame's samples), keeping
    only fractional parts, so that float32 holds it exactly enough."""
    sr = params["nsf_params"]["sampling_rate"]
    H, up = params["nsf_params"]["nb_harmonics"] + 1, hop(params)
    B, T = f0.shape
    h = torch.arange(1, H + 1, dtype=f0.dtype, device=f0.device)
    step = f0[:, :, None] * h / sr                          # (B, T, H) per sample
    start = torch.remainder(torch.cumsum(torch.remainder(step * up, 1.0), 1), 1.0)
    start = torch.cat([torch.zeros_like(start[:, :1]), start[:, :-1]], 1)
    k = torch.arange(1, up + 1, dtype=f0.dtype, device=f0.device)
    cycles = torch.remainder(start[:, :, None, :] + k[:, None] * step[:, :, None, :], 1.0)
    theta = 2.0 * math.pi * cycles.reshape(B, T * up, H)
    phase = torch.cat([torch.zeros_like(phase[..., :1]), phase[..., 1:]], -1)
    n = NSF_SIGMA * noise
    voiced = NSF_ALPHA * torch.sin(theta + phase) + n
    unvoiced = NSF_ALPHA / 3.0 / NSF_SIGMA * n
    uv_s = uv.repeat_interleave(up, dim=1)[:, :, None]
    e = voiced * uv_s + unvoiced * (1.0 - uv_s)             # (B, T*up, H)
    w = _w(p, "source_module.ffn.0")[:, :, 0]               # (1, H)
    return torch.tanh(e @ w.t() + p["source_module.ffn.0.bias"]).transpose(1, 2)


def generator(mel: torch.Tensor, p: Weights, params: dict,
              draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> torch.Tensor:
    """mel (B, T, C) -> waveform (B, T * hop). For NSF, C holds the mels then
    f0 and uv, and ``draws`` are the source's (phase, noise)."""
    causal = params.get("causal", True)
    slope = params.get("nonlinear_activation_params", {}).get("negative_slope", 0.1)
    k = params["kernel_size"]
    nsf = params.get("nsf_params")
    if nsf is not None:
        e = nsf_source(mel[:, :, -2], mel[:, :, -1], *draws, p, params)
        mel = mel[:, :, :-2]
    h = _conv(mel.transpose(1, 2), p, "conv_pre.conv1d", causal)
    n_res = len(params["resblock_kernel_sizes"])
    for i, (s, up_k) in enumerate(zip(params["upsample_scales"],
                                      params["upsample_kernal_sizes"])):
        h = torch.sin(h) + h
        rep = _conv(_lrelu(F.interpolate(h, scale_factor=s, mode="nearest"), slope),
                    p, f"repeat_upsamples.{i}.2.conv1d", causal)
        name = f"transpose_upsamples.{i}.1.deconv"
        up = F.conv_transpose1d(_lrelu(h, slope), _w(p, name), p[f"{name}.bias"], s)
        if not causal:
            pad = (up_k - s) // 2
            up = up[:, :, pad:up.shape[-1] - pad]
        n = rep.shape[-1]
        h = rep + up[:, :, :n]
        if nsf is not None:
            u = source_strides(params)[i]
            name = f"source_downs.{i}.conv1d"
            if u == 1:
                h = h + _conv(e, p, name, False, padding=0)[:, :, :n]
            else:
                h = h + _conv(e, p, name, causal, stride=u, padding=u // 2)[:, :, :n]
        acc = 0.0
        for j, (rk, rd) in enumerate(zip(params["resblock_kernel_sizes"],
                                         params["resblock_dilations"])):
            x = h
            for m, d in enumerate(rd):
                blk = f"conv_blocks.{i * n_res + j}"
                t = _conv(_lrelu(x, slope), p, f"{blk}.convs1.{m}.conv1d", causal, d)
                x = _conv(_lrelu(t, slope), p, f"{blk}.convs2.{m}.conv1d", causal) + x
            acc = acc + x
        h = acc / n_res
    h = _conv(_lrelu(h, 0.01), p, "conv_post.conv1d", causal)
    return torch.tanh(h)[:, 0]


def vocode_utterances(mels: Sequence[torch.Tensor], p: Weights, params: dict,
                      padded: Optional[Tuple[int, int]] = None
                      ) -> List[torch.Tensor]:
    """Each mel (T_i, C) alone -> its waveform (T_i * hop,). For NSF the
    draws are those of one call on the padded (batch, frames) input, of
    which utterance i takes row i and its first T_i * hop samples."""
    draws = None
    if params.get("nsf_params") is not None:
        draws = nsf_draws(*padded, params, mels[0].device)
    out = []
    for i, mel in enumerate(mels):
        d = None
        if draws is not None:
            n = mel.shape[0] * hop(params)
            d = (draws[0][i:i + 1], draws[1][i:i + 1, :n])
        out.append(generator(mel[None], p, params, d)[0])
    return out

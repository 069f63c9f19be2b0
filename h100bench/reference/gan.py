"""Plain PyTorch HiFi-GAN training step of KAN-TTS: the multi-scale (db3
wavelet between scales) and multi-period discriminators, the mel,
adversarial (least squares) and feature-matching losses, and Adam.

Written from the published recipe (KAN-TTS ``kantts/models/hifigan``,
``kantts/train/loss.py``, ``hifigan_v1_16k.yaml``), in functional form
over dicts of weights in the KAN-TTS state-dict layout; the generator is
``hifigan.generator``. It imports nothing of the measured program. A step:

1. the generator's loss, 45 mel + 1 adversarial + 2 feature matching,
   with the discriminators as they are (their spectral-norm vectors not
   updated), differentiated by the generator's weights, then Adam;
2. the fake regenerated by the updated generator without gradient, the
   discriminators' loss on it (first) and on the real waveform (which
   stores the new spectral-norm vectors), differentiated by their
   weights, then Adam for each family.

Spectral norm: one power iteration from the stored vector, without
gradient, w = v / sigma.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference import hifigan as ref_g

Weights = Dict[str, torch.Tensor]

# Daubechies-3 decomposition low pass; the high pass is its quadrature mirror
DB3_LO = np.array([0.035226291882100656, -0.08544127388224149, -0.13501102001039084,
                   0.4598775021193313, 0.8068915093133388, 0.3326705529509569])
DB3_HI = np.array([(-1) ** k * DB3_LO[5 - k] for k in range(6)])


# ---------------------------------------------------------------- shapes

def _conv(shapes: dict, name: str, shape: Tuple[int, ...], norm: str) -> None:
    if norm == "weight":
        shapes[f"{name}.weight_v"] = shape
        shapes[f"{name}.weight_g"] = (shape[0],) + (1,) * (len(shape) - 1)
    elif norm == "spectral":
        shapes[f"{name}.weight_orig"] = shape
        shapes[f"{name}.weight_u"] = (shape[0],)
    else:
        shapes[f"{name}.weight"] = shape
    shapes[f"{name}.bias"] = (shape[0],)


def scale_layers(dp: dict) -> List[Tuple[int, int, int, int, int]]:
    """(c_in, c_out, kernel, stride, groups) of a scale discriminator's
    convs, then its conv_post."""
    k0, k1, k2, k3 = dp["kernel_sizes"]
    ch, top = dp["channels"], dp["max_downsample_channels"]
    layers = [(dp.get("in_channels", 1), ch, k0, 1, 1)]
    cur, out, groups = ch, ch, 4
    for s in dp["downsample_scales"]:
        layers.append((cur, out, k1, s, groups))
        cur, out = out, min(out * 2, top)
        groups = min(groups * 4, dp["max_groups"])
    layers.append((cur, out, k2, 1, 1))
    layers.append((out, dp.get("out_channels", 1), k3, 1, 1))
    return layers


def period_layers(dp: dict) -> List[Tuple[int, int, int, int]]:
    """(c_in, c_out, kernel, stride) of a period discriminator's convs,
    then its conv_post (kernel k1 - 1)."""
    k0, k1 = dp["kernel_sizes"]
    cin, out = dp.get("in_channels", 1), dp["channels"]
    layers = []
    for s in dp["downsample_scales"]:
        layers.append((cin, out, k0, s))
        cin, out = out, min(out * 4, dp["max_downsample_channels"])
    layers.append((cin, dp.get("out_channels", 1), k1 - 1, 1))
    return layers


def msd_norm(params: dict, i: int) -> str:
    if params.get("follow_official_norm", False):
        return "spectral" if i == 0 else "weight"
    spectral = params["discriminator_params"].get("use_spectral_norm", False)
    return "spectral" if spectral else "weight"


def msd_shapes(params: dict) -> Dict[str, Tuple[int, ...]]:
    shapes: Dict[str, Tuple[int, ...]] = {}
    dp = params["discriminator_params"]
    for i in range(params["scales"]):
        norm = msd_norm(params, i)
        layers = scale_layers(dp)
        for j, (cin, cout, k, _, g) in enumerate(layers[:-1]):
            _conv(shapes, f"discriminators.{i}.convs.{j}.0", (cout, cin // g, k), norm)
        cin, cout, k, _, _ = layers[-1]
        _conv(shapes, f"discriminators.{i}.conv_post", (cout, cin, k), norm)
    if params.get("downsample_pooling", "DWT") == "DWT":
        for i in range(params["scales"] - 1):
            _conv(shapes, f"aux_convs.{i}", (1, 2, 15), "weight")
    return shapes


def mpd_shapes(params: dict) -> Dict[str, Tuple[int, ...]]:
    shapes: Dict[str, Tuple[int, ...]] = {}
    dp = params["discriminator_params"]
    norm = "spectral" if dp.get("use_spectral_norm", False) else "weight"
    for i in range(len(params["periods"])):
        layers = period_layers(dp)
        for j, (cin, cout, k, _) in enumerate(layers[:-1]):
            _conv(shapes, f"discriminators.{i}.convs.{j}.0", (cout, cin, k, 1), norm)
        cin, cout, k, _ = layers[-1]
        _conv(shapes, f"discriminators.{i}.conv_post", (cout, cin, k, 1), "none")
    return shapes


# ---------------------------------------------------------- discriminators

def _lrelu(x):
    return torch.where(x >= 0, x, x * 0.1)


def _weight(p: Weights, name: str, u: Dict[str, torch.Tensor], update: bool):
    if f"{name}.weight_v" in p:
        v, g = p[f"{name}.weight_v"], p[f"{name}.weight_g"]
        return g * v / torch.linalg.vector_norm(v, dim=tuple(range(1, v.ndim)),
                                                keepdim=True)
    if f"{name}.weight_orig" in p:
        v = p[f"{name}.weight_orig"]
        with torch.no_grad():
            w = v.reshape(v.shape[0], -1)
            x = w.t() @ u[name]
            x = x / (torch.linalg.vector_norm(x) + 1e-12)
            y = w @ x
            y = y / (torch.linalg.vector_norm(y) + 1e-12)
            sigma = y @ (w @ x)
            if update:
                u[name] = y
        return v / sigma
    return p[f"{name}.weight"]


def msd(y: torch.Tensor, p: Weights, params: dict, u: dict, update: bool):
    """y (B, 1, T) -> ([score of each scale], [[feature maps] of each])."""
    dp = params["discriminator_params"]
    outs, fmaps = [], []
    filters = torch.tensor(np.stack([DB3_LO[::-1], DB3_HI[::-1]])[:, None, :].copy(),
                           dtype=y.dtype, device=y.device)
    for i in range(params["scales"]):
        if i:
            y = F.conv1d(y, filters, stride=2, padding=5)  # the low and high bands
            name = f"aux_convs.{i - 1}"
            y = _lrelu(F.conv1d(y, _weight(p, name, u, update), p[f"{name}.bias"],
                                padding=7))
        x, fmap = y, []
        layers = scale_layers(dp)
        for j, (_, _, k, s, g) in enumerate(layers[:-1]):
            name = f"discriminators.{i}.convs.{j}.0"
            x = _lrelu(F.conv1d(x, _weight(p, name, u, update), p[f"{name}.bias"],
                                s, (k - 1) // 2, 1, g))
            fmap.append(x)
        k = layers[-1][2]
        name = f"discriminators.{i}.conv_post"
        x = F.conv1d(x, _weight(p, name, u, update), p[f"{name}.bias"], 1, (k - 1) // 2)
        fmap.append(x)
        outs.append(x.reshape(x.shape[0], -1))
        fmaps.append(fmap)
    return outs, fmaps


def mpd(y: torch.Tensor, p: Weights, params: dict, u: dict, update: bool):
    dp = params["discriminator_params"]
    outs, fmaps = [], []
    B, C, T = y.shape
    for i, period in enumerate(params["periods"]):
        x = F.pad(y, (0, period - T % period), mode="reflect") if T % period else y
        x = x.reshape(B, C, -1, period)
        fmap = []
        layers = period_layers(dp)
        for j, (_, _, k, s) in enumerate(layers[:-1]):
            name = f"discriminators.{i}.convs.{j}.0"
            x = _lrelu(F.conv2d(x, _weight(p, name, u, update), p[f"{name}.bias"],
                                (s, 1), ((k - 1) // 2, 0)))
            fmap.append(x)
        k = layers[-1][2]
        name = f"discriminators.{i}.conv_post"
        x = F.conv2d(x, p[f"{name}.weight"], p[f"{name}.bias"], 1, (k // 2, 0))
        fmap.append(x)
        outs.append(x.reshape(B, -1))
        fmaps.append(fmap)
    return outs, fmaps


DISCRIMINATORS = {"MultiScaleDiscriminator": (msd, msd_shapes),
                  "MultiPeriodDiscriminator": (mpd, mpd_shapes)}


# ------------------------------------------------------------------ losses

def _slaney_mel(hz):
    hz = np.asarray(hz, np.float64)
    lin = hz / (200.0 / 3)
    return np.where(hz >= 1000.0, 15.0 + np.log(np.maximum(hz, 1000.0) / 1000.0)
                    / (np.log(6.4) / 27.0), lin)


def _slaney_hz(mel):
    mel = np.asarray(mel, np.float64)
    return np.where(mel >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (mel - 15.0)),
                    mel * 200.0 / 3)


def mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-normalised triangular filters (n_mels, n_fft // 2 + 1), as
    librosa's ``filters.mel`` makes them."""
    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    edges = _slaney_hz(np.linspace(_slaney_mel(fmin), _slaney_mel(fmax), n_mels + 2))
    lo, mid, hi = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    tri = np.maximum(0.0, np.minimum((freqs - lo) / (mid - lo), (hi - freqs) / (hi - mid)))
    return (tri * (2.0 / (edges[2:] - edges[:-2]))[:, None]).astype(np.float32)


class MelLoss:
    """L1 between normalised dB mels: |STFT| (Hann window of win_length,
    zero-padded to fft_size; zero padding of fft_size / 2 at both ends),
    mel filters, 20 log10 (floored at 1e-5) - 20 dB, mapped from
    [-100, 0] dB to [-4, 4] and clipped."""

    def __init__(self, p: dict, device):
        n = p["fft_size"]
        win = p.get("win_length") or n
        w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win) / win)
        lpad = (n - win) // 2
        self.window = torch.tensor(np.pad(w, (lpad, n - win - lpad)), dtype=torch.float32,
                                   device=device)
        fmax = p.get("fmax") or p["fs"] / 2
        self.basis = torch.tensor(mel_basis(p["fs"], n, p["num_mels"], p.get("fmin") or 0.0,
                                            fmax), device=device)
        self.n, self.hop = n, p["hop_size"]

    def mel(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x[:, None], (self.n // 2, self.n // 2))[:, 0]
        s = torch.stft(x, self.n, self.hop, self.n, self.window, center=False,
                       return_complex=True)
        amp = torch.sqrt((s.real ** 2 + s.imag ** 2).clamp(min=1e-10))
        m = (self.basis @ amp).clamp(min=1e-10)
        db = 20.0 * torch.log10(m.clamp(min=1e-5)) - 20.0
        return torch.clamp(8.0 * (db + 100.0) / 100.0 - 4.0, -4.0, 4.0)

    def __call__(self, y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return (self.mel(y_hat) - self.mel(y)).abs().mean()


def generator_adv(outs) -> torch.Tensor:
    return sum(((o - 1.0) ** 2).mean() for o in outs)


def feature_match(fmaps_hat, fmaps) -> torch.Tensor:
    return sum((a - b.detach()).abs().mean()
               for fh, f in zip(fmaps_hat, fmaps) for a, b in zip(fh, f))


def discriminator_adv(outs_hat, outs) -> Tuple[torch.Tensor, torch.Tensor]:
    return (sum(((o - 1.0) ** 2).mean() for o in outs),
            sum((o ** 2).mean() for o in outs_hat))


# --------------------------------------------------------------- training

class Adam:
    """torch.optim.Adam's update without weight decay, with a learning-rate
    factor for the step (MultiStepLR: gamma per milestone passed)."""

    def __init__(self, leaves: Dict[str, torch.Tensor], opt: dict, sched: dict):
        p = opt["params"]
        self.lr, self.betas, self.eps = p["lr"], tuple(p["betas"]), p.get("eps", 1e-8)
        if p.get("weight_decay", 0.0):
            raise ValueError("the reference's Adam takes no weight decay")
        self.sched = sched or {"type": "ConstantLR", "params": {}}
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.t = 0

    def factor(self, step: int) -> float:
        if self.sched["type"] == "MultiStepLR":
            sp = self.sched["params"]
            return sp["gamma"] ** sum(step >= m for m in sp["milestones"])
        if self.sched["type"] == "ConstantLR":
            return 1.0
        raise ValueError(f"the reference has no {self.sched['type']} schedule")

    @torch.no_grad()
    def step(self, leaves: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        b1, b2 = self.betas
        lr = self.lr * self.factor(self.t)
        self.t += 1
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            leaves[k].sub_(lr * m_hat / (v_hat.sqrt() + self.eps))


class GanReference:
    """The generator's and the discriminators' weights and optimizer state,
    stepped as the recipe steps them. ``weights``: {"Generator": ...,
    family: ...}, copied; the spectral-norm vectors ``*.weight_u`` are state,
    not weights."""

    def __init__(self, config: dict, weights: Dict[str, Weights], device):
        model = config["Model"]
        self.config, self.model = config, model
        self.w, self.u, self.opt = {}, {}, {}
        for fam, w in weights.items():
            self.w[fam] = {k: v.detach().clone() for k, v in w.items()
                           if not k.endswith("weight_u")}
            self.u[fam] = {k[:-len(".weight_u")]: v.detach().clone()
                           for k, v in w.items() if k.endswith("weight_u")}
            self.opt[fam] = Adam(self.w[fam], model[fam]["optimizer"],
                                 model[fam].get("scheduler"))
        self.mel_loss = MelLoss(config["Loss"]["mel_loss"]["params"], device)
        self.families = [f for f in weights if f != "Generator"]

    def generate(self, mel: torch.Tensor) -> torch.Tensor:
        gp = self.model["Generator"]["params"]
        if gp.get("nsf_params") is not None:
            raise ValueError("the reference GAN step has no NSF source draws")
        return ref_g.generator(mel, self.w["Generator"], gp)[:, None]

    def discriminate(self, fam: str, y: torch.Tensor, update: bool):
        fn = DISCRIMINATORS[fam][0]
        return fn(y, self.w[fam], self.model[fam]["params"], self.u[fam], update)

    def step(self, wav: torch.Tensor, mel: torch.Tensor) -> Dict[str, object]:
        """wav (B, T, 1), mel (B, frames, C) -> the losses and the
        gradients of this step."""
        loss_cfg = self.config["Loss"]
        y = wav.transpose(1, 2)
        g = self.w["Generator"]
        for v in g.values():
            v.requires_grad_(True)
        y_hat = self.generate(mel)
        gen_loss = self.mel_loss(y_hat[:, 0], y[:, 0]) * loss_cfg["mel_loss"]["weights"]
        adv = fm = 0.0
        for fam in self.families:
            outs_hat, fmaps_hat = self.discriminate(fam, y_hat, False)
            with torch.no_grad():
                _, fmaps = self.discriminate(fam, y, False)
            adv = adv + generator_adv(outs_hat)
            fm = fm + feature_match(fmaps_hat, fmaps)
        gen_loss = (gen_loss + adv * loss_cfg["generator_adv_loss"]["weights"]
                    + fm * loss_cfg["feat_match_loss"]["weights"])
        g_grads = dict(zip(g, torch.autograd.grad(gen_loss, list(g.values()))))
        for v in g.values():
            v.requires_grad_(False)
        self.opt["Generator"].step(g, g_grads)
        grads = {"Generator": g_grads}
        with torch.no_grad():
            y_fake = self.generate(mel)
        real = fake = 0.0
        for fam in self.families:
            for v in self.w[fam].values():
                v.requires_grad_(True)
            outs_hat, _ = self.discriminate(fam, y_fake, False)
            outs, _ = self.discriminate(fam, y, True)
            r, f = discriminator_adv(outs_hat, outs)
            real, fake = real + r, fake + f
        dis_loss = real + fake
        leaves = [(fam, k, v) for fam in self.families for k, v in self.w[fam].items()]
        d_grads = torch.autograd.grad(dis_loss, [v for _, _, v in leaves])
        for fam in self.families:
            grads[fam] = {k: gr for (f, k, _), gr in zip(leaves, d_grads) if f == fam}
            for v in self.w[fam].values():
                v.requires_grad_(False)
            self.opt[fam].step(self.w[fam], grads[fam])
        return {"generator_loss": gen_loss.detach(),
                "discriminator_loss": dis_loss.detach(), "grads": grads}

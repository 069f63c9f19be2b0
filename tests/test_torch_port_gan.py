"""The port's HiFi-GAN GAN-training path against the JAX package, at the small
widths of ``tests/test_train_steps.py`` on the CPU: the discriminators, the
GAN criteria, the weight bridges, one GAN step and its warm-up gates, three
steps with the published Adam and MultiStepLR, the eval step, and
``train_hifigan`` with both resume modes.

Weights are made by the JAX package's init and reach the port through the
weight bridge; inputs are numpy arrays from a seed. Tolerances: scores and
feature maps atol 1e-5; spectral vectors after ``update_stats`` atol 1e-6;
criteria rtol 1e-5. One SGD step: every parameter and spectral vector atol
1e-6 (SGD moves a parameter by lr x its gradient, so a gradient that leaks
from the generator loss into the discriminators, or a fake that is not
regenerated, shows at once), every metric rtol 1e-5. Three Adam steps: see
``test_three_adam_steps_match_jax``.
"""

import collections
import glob
import logging
import os
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from kantts_tpu.losses import losses as jl
from kantts_tpu.data.dataset import load_wav
from kantts_tpu.models.hifigan.discriminators import MultiPeriodDiscriminator as JMPD
from kantts_tpu.models.hifigan.discriminators import MultiScaleDiscriminator as JMSD
from kantts_tpu.models.hifigan.generator import Generator as JGenerator
from kantts_tpu.models.pqmf import PQMF as JPQMF
from kantts_tpu.train.optim import optimizer_builder as j_optimizer_builder
from kantts_tpu.train.states import GanTrainState
from kantts_tpu.train.steps import make_gan_eval_step as j_make_gan_eval_step
from kantts_tpu.train.steps import make_gan_step as j_make_gan_step
from kantts_tpu.utils.torch_convert import convert_mpd, convert_msd
from kantts_tpu_torch.bin import train_hifigan
from kantts_tpu_torch.bin.text_to_wav import text_to_wav
from kantts_tpu_torch.configs import get_config
from kantts_tpu_torch.losses import criterion_builder
from kantts_tpu_torch.losses import losses as tl
from kantts_tpu_torch.models.builder import (
    build_sambert,
    hifigan_gan_builder,
    hifigan_model_builder,
    init_parameters,
    load_checkpoint,
    save_checkpoint,
)
from kantts_tpu_torch.models.hifigan.discriminators import (
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
)
from kantts_tpu_torch.models.hifigan.generator import Generator
from kantts_tpu_torch.train.optim import optimizer_builder
from kantts_tpu_torch.train.steps import make_gan_eval_step, make_gan_step
from kantts_tpu_torch.utils.convert import (
    hifigan_state_dict_from_jax,
    mpd_state_dict_from_jax,
    msd_state_dict_from_jax,
)
from kantts_tpu_torch.utils import plot, profiling
from kantts_tpu_torch.utils.corpus import write_voc_corpus
from test_sambert import TINY
from test_torch_port_tools import (  # noqa: F401 - torch_one_thread is a fixture
    assert_same_checkpoint,
    assert_scalars_match_log,
    cpu_profile,
    recorded_spans,
    torch_one_thread,
)
from test_train_steps import GEN_CFG, LOSS_CFG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN = dict(GEN_CFG, causal=True)
MSD_CFG = {"discriminator_params": {"channels": 16, "max_downsample_channels": 32,
                                    "max_groups": 4, "downsample_scales": [2, 2, 1]},
           "follow_official_norm": True}
MPD_CFG = {"periods": (2, 3),
           "discriminator_params": {"channels": 4, "max_downsample_channels": 8,
                                    "downsample_scales": [3, 3, 1]}}
DISCS = {  # name: (JAX class, port class, bridge, config)
    "MultiScaleDiscriminator": (JMSD, MultiScaleDiscriminator,
                                msd_state_dict_from_jax, MSD_CFG),
    "MultiPeriodDiscriminator": (JMPD, MultiPeriodDiscriminator,
                                 mpd_state_dict_from_jax, MPD_CFG),
}
B, FRAMES, HOP = 2, 8, 16  # hop: prod(GEN_CFG's upsample_scales)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    mel = rng.randn(B, FRAMES, 20).astype(np.float32)
    wav = (0.3 * rng.randn(B, FRAMES * HOP, 1)).astype(np.float32)
    return wav, mel


def _jax_init(wav, mel, disc_cfgs=None):
    """-> (JAX generator, {name: JAX discriminator}, gen params,
    disc params, spectral), numpy leaves."""
    disc_cfgs = disc_cfgs or {n: d[3] for n, d in DISCS.items()}
    gen = JGenerator(**GEN)
    discs = {n: DISCS[n][0](**cfg) for n, cfg in disc_cfgs.items()}
    gen_params = _np(gen.init(jax.random.PRNGKey(0), jnp.asarray(mel))["params"])
    disc_params, spectral = {}, {}
    for i, (name, d) in enumerate(discs.items()):
        variables = d.init(jax.random.PRNGKey(i + 1), jnp.asarray(wav))
        disc_params[name] = _np(variables["params"])
        spectral[name] = _np(variables.get("spectral", {}))
    return gen, discs, gen_params, disc_params, spectral


def _port(gen_params, disc_params, spectral):
    """The port's generator and discriminators on the JAX weights."""
    gen = Generator(**GEN)
    gen.load_state_dict(hifigan_state_dict_from_jax(gen_params, GEN), strict=True)
    discs = {}
    for name in disc_params:
        _, cls, bridge, cfg = DISCS[name]
        discs[name] = cls(**cfg)
        discs[name].load_state_dict(
            bridge(disc_params[name], cfg, spectral.get(name)), strict=True)
    return gen.train(), {n: d.train() for n, d in discs.items()}


# ------------------------------------------------------------ discriminators

DISC_CASES = {
    "msd_dwt_official_norm": ("MultiScaleDiscriminator", MSD_CFG),
    "msd_avg_pool": ("MultiScaleDiscriminator",
                     dict(MSD_CFG, downsample_pooling="AvgPool1d",
                          follow_official_norm=False)),
    "mpd": ("MultiPeriodDiscriminator", MPD_CFG),
    "mpd_spectral": ("MultiPeriodDiscriminator",
                     dict(MPD_CFG, discriminator_params=dict(
                         MPD_CFG["discriminator_params"], use_spectral_norm=True))),
}


@pytest.mark.parametrize("case", list(DISC_CASES))
def test_discriminator_matches_jax(case):
    """Scores and every feature map, then the spectral vectors stored by
    ``update_stats=True``; T=130 is a multiple of neither period 3 nor of
    the DWT's stride at every scale."""
    name, cfg = DISC_CASES[case]
    jcls, cls, bridge, _ = DISCS[name]
    wav = (0.3 * np.random.RandomState(1).randn(2, 130, 1)).astype(np.float32)
    jd = jcls(**cfg)
    variables = jd.init(jax.random.PRNGKey(3), jnp.asarray(wav))
    spectral = _np(variables.get("spectral", {}))
    (want_out, want_fmaps), mutated = jd.apply(variables, jnp.asarray(wav), True,
                                               mutable=["spectral"])
    disc = cls(**cfg)
    disc.load_state_dict(bridge(_np(variables["params"]), cfg, spectral), strict=True)
    with torch.no_grad():
        out, fmaps = disc(torch.from_numpy(wav).transpose(1, 2), update_stats=True)
    assert len(out) == len(want_out)
    for got, want in zip(out, want_out):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for fmap, want_fmap in zip(fmaps, want_fmaps):
        assert len(fmap) == len(want_fmap)
        for got, want in zip(fmap, want_fmap):
            np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1),
                                       np.asarray(want), atol=1e-5, rtol=0)
    if spectral:
        new = bridge(_np(variables["params"]), cfg, _np(mutated["spectral"]))
        us = [k for k in new if k.endswith("weight_u")]
        assert us
        for k in us:
            np.testing.assert_allclose(disc.state_dict()[k].numpy(), new[k].numpy(),
                                       atol=1e-6, rtol=0, err_msg=k)
            assert not torch.equal(new[k], bridge(_np(variables["params"]), cfg,
                                                  spectral)[k])


def test_spectral_norm_stores_u_only_when_asked():
    disc = MultiScaleDiscriminator(**MSD_CFG)
    init_parameters(disc, 0)
    before = {k: v.clone() for k, v in disc.state_dict().items()}
    x = torch.randn(1, 1, 64)
    disc(x)
    assert all(torch.equal(before[k], v) for k, v in disc.state_dict().items())
    out, _ = disc(x, update_stats=True)
    changed = [k for k, v in disc.state_dict().items() if not torch.equal(before[k], v)]
    assert changed and all(k.endswith("weight_u") for k in changed)
    # sigma is detached: no gradient reaches u, and v gets one
    out[0].sum().backward()
    conv = disc.discriminators[0].convs[0][0]
    assert conv.weight_orig.grad is not None and not conv.weight_u.requires_grad


def test_weight_bridge_round_trips():
    """JAX -> port -> JAX through the JAX package's converters, exactly; the
    spectral-normed scale, which they do not cover, is checked leaf by leaf."""
    wav = np.zeros((1, 64, 1), np.float32)
    mpd = JMPD(**MPD_CFG).init(jax.random.PRNGKey(0), jnp.asarray(wav))["params"]
    msd_cfg = dict(MSD_CFG, follow_official_norm=False)
    msd = JMSD(**msd_cfg).init(jax.random.PRNGKey(1), jnp.asarray(wav))["params"]
    for params, back in (
            (mpd, lambda sd: convert_mpd(sd, MPD_CFG["periods"], 3)),
            (msd, lambda sd: convert_msd(sd, 3, 3, has_dwt_aux=True))):
        sd = (mpd_state_dict_from_jax(_np(params), MPD_CFG) if params is mpd
              else msd_state_dict_from_jax(_np(params), msd_cfg))
        a = flax.traverse_util.flatten_dict(_np(params))
        b = flax.traverse_util.flatten_dict(back({k: v.numpy() for k, v in sd.items()}))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg="/".join(k))

    variables = JMSD(**MSD_CFG).init(jax.random.PRNGKey(2), jnp.asarray(wav))
    params, spectral = _np(variables["params"]), _np(variables["spectral"])
    sd = msd_state_dict_from_jax(params, MSD_CFG, spectral)
    for j in range(5):
        leaf = params["discriminators_0"][f"convs_{j}"]
        prefix = f"discriminators.0.convs.{j}.0"
        np.testing.assert_array_equal(sd[f"{prefix}.weight_orig"].numpy(),
                                      leaf["kernel_v"].transpose(2, 1, 0))
        np.testing.assert_array_equal(sd[f"{prefix}.bias"].numpy(), leaf["bias"])
        np.testing.assert_array_equal(
            sd[f"{prefix}.weight_u"].numpy(),
            spectral["discriminators_0"][f"convs_{j}"]["u"])
    with pytest.raises(KeyError, match="spectral"):
        msd_state_dict_from_jax(params, MSD_CFG)


# ------------------------------------------------------------------ criteria


def _scores(seed, shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


SHAPES = [(2, 9), (2, 5), (2, 17)]


@pytest.mark.parametrize("loss_type", ["mse", "hinge"])
@pytest.mark.parametrize("average", [True, False])
def test_adversarial_losses_match_jax(loss_type, average):
    fake, real = _scores(0, SHAPES), _scores(1, SHAPES)
    jg = jl.GeneratorAdversarialLoss(average, loss_type)
    tg = tl.GeneratorAdversarialLoss(average, loss_type)
    np.testing.assert_allclose(float(tg([torch.from_numpy(f) for f in fake])),
                               float(jg([jnp.asarray(f) for f in fake])), rtol=1e-5)
    np.testing.assert_allclose(float(tg(torch.from_numpy(fake[0]))),
                               float(jg(jnp.asarray(fake[0]))), rtol=1e-5)
    jd = jl.DiscriminatorAdversarialLoss(average, loss_type)
    td = tl.DiscriminatorAdversarialLoss(average, loss_type)
    want = jd([jnp.asarray(f) for f in fake], [jnp.asarray(r) for r in real])
    got = td([torch.from_numpy(f) for f in fake], [torch.from_numpy(r) for r in real])
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want],
                               rtol=1e-5)


@pytest.mark.parametrize("by_layers,by_discs", [(True, True), (False, False),
                                                (True, False)])
def test_feature_match_loss_matches_jax(by_layers, by_discs):
    shapes = [[(2, 4, 9), (2, 8, 5), (2, 1, 5)], [(2, 4, 3, 2), (2, 1, 4, 2)]]
    fake = [_scores(i, s) for i, s in enumerate(shapes)]
    real = [_scores(10 + i, s) for i, s in enumerate(shapes)]
    want = jl.FeatureMatchLoss(by_layers, by_discs)(
        [[jnp.asarray(a) for a in m] for m in fake],
        [[jnp.asarray(a) for a in m] for m in real])
    real_t = [[torch.from_numpy(a).requires_grad_() for a in m] for m in real]
    got = tl.FeatureMatchLoss(by_layers, by_discs)(
        [[torch.from_numpy(a).requires_grad_() for a in m] for m in fake], real_t)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    got.backward()
    assert all(a.grad is None for m in real_t for a in m)  # real maps detached


def test_spectral_losses_match_jax():
    rng = np.random.RandomState(4)
    y_hat, y = (0.3 * rng.randn(2, 1, 1600)).astype(np.float32), \
        (0.3 * rng.randn(2, 1, 1600)).astype(np.float32)
    mel_kw = LOSS_CFG["Loss"]["mel_loss"]["params"]
    want = jl.MelSpectrogramLoss(**mel_kw)(jnp.asarray(y_hat), jnp.asarray(y))
    got = tl.MelSpectrogramLoss(**mel_kw)(torch.from_numpy(y_hat), torch.from_numpy(y))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    res = dict(fft_sizes=(256, 128), hop_sizes=(32, 16), win_lengths=(128, 64))
    want = jl.MultiResolutionSTFTLoss(**res)(jnp.asarray(y_hat), jnp.asarray(y))
    got = tl.MultiResolutionSTFTLoss(**res)(torch.from_numpy(y_hat), torch.from_numpy(y))
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want],
                               rtol=1e-5)
    want = jl.STFTLoss(256, 32, 128)(jnp.asarray(y_hat[:, 0]), jnp.asarray(y[:, 0]))
    got = tl.STFTLoss(256, 32, 128)(torch.from_numpy(y_hat[:, 0]),
                                    torch.from_numpy(y[:, 0]))
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want],
                               rtol=1e-5)


def test_criterion_builder_takes_the_gan_losses():
    cfg = {"Loss": dict(LOSS_CFG["Loss"], stft_loss={"enable": False},
                        subband_stft_loss={"enable": False})}
    crit = criterion_builder(cfg)
    assert set(crit) == {"generator_adv_loss", "discriminator_adv_loss",
                         "mel_loss", "feat_match_loss"}
    assert crit["mel_loss"].weights == 45.0 and crit["feat_match_loss"].weights == 2.0
    assert not crit["generator_adv_loss"].average_by_discriminators
    sub = criterion_builder({"Loss": {"subband_stft_loss": {"enable": True, "params": {
        "fft_sizes": [384, 683, 171], "hop_sizes": [35, 75, 15],
        "win_lengths": [150, 300, 60], "window": "hann_window"}}}})
    assert isinstance(sub["subband_stft_loss"], tl.MultiResolutionSTFTLoss)
    assert [f.fft_size for f in sub["subband_stft_loss"].stft_losses] == [384, 683, 171]


# ----------------------------------------------------------------- GAN step

SGD = {"type": "SGD", "params": {"lr": 1e-3}}
ADAM = {"type": "Adam", "params": {"lr": 2e-4, "betas": [0.5, 0.9],
                                   "weight_decay": 0.0}}
MULTISTEP = {"type": "MultiStepLR", "params": {"gamma": 0.5, "milestones": [1, 2]}}


class _Pair:
    """The same GAN in both packages: the JAX state and step factory, the
    port's modules, optimizers and schedules."""

    def __init__(self, opt_cfg, sched_cfg=None, seed=0):
        self.wav, self.mel = _batch(seed)
        gen, discs, gen_params, disc_params, spectral = _jax_init(self.wav, self.mel)
        self.j_gen, self.j_discs = gen, discs
        self.j_crit = jl.criterion_builder(LOSS_CFG)
        self.gen_tx, _ = j_optimizer_builder(opt_cfg, sched_cfg)
        self.disc_txs = {n: j_optimizer_builder(opt_cfg, sched_cfg)[0] for n in discs}
        self.state = GanTrainState(
            gen_params, self.gen_tx.init(gen_params), disc_params,
            {n: self.disc_txs[n].init(disc_params[n]) for n in discs},
            spectral, jnp.asarray(0, dtype=jnp.int32))
        self.gen, self.discs = _port(gen_params, disc_params, spectral)
        self.crit = criterion_builder(LOSS_CFG)
        self.gen_opt, self.gen_sched, _ = optimizer_builder(
            self.gen.parameters(), opt_cfg, sched_cfg)
        parts = {n: optimizer_builder(d.parameters(), opt_cfg, sched_cfg)
                 for n, d in self.discs.items()}
        self.disc_opts = {n: p[0] for n, p in parts.items()}
        self.disc_scheds = {n: p[1] for n, p in parts.items()}

    def steps(self, train_generator=True, include_adversarial=True):
        """-> (JAX step, port step) for one pair of gates."""
        j = j_make_gan_step(self.j_gen, self.j_discs, self.j_crit, self.gen_tx,
                            self.disc_txs, train_generator=train_generator,
                            include_adversarial=include_adversarial)
        t = make_gan_step(self.gen, self.discs, self.crit, self.gen_opt,
                          self.gen_sched, self.disc_opts, self.disc_scheds,
                          train_generator=train_generator,
                          include_adversarial=include_adversarial)
        return j, t

    def run(self, j_step, t_step):
        self.state, j_metrics = j_step(self.state, jnp.asarray(self.wav),
                                       jnp.asarray(self.mel), jax.random.PRNGKey(7))
        t_metrics = t_step(torch.from_numpy(self.wav), torch.from_numpy(self.mel))
        return _np(j_metrics), {k: float(v) for k, v in t_metrics.items()}

    def assert_weights_match(self, atol):
        st = self.state
        want = hifigan_state_dict_from_jax(_np(st.gen_params), GEN)
        got = self.gen.state_dict()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol,
                                       rtol=0, err_msg=k)
        for name, disc in self.discs.items():
            want = DISCS[name][2](_np(st.disc_params[name]), DISCS[name][3],
                                  _np(st.spectral[name]))
            got = disc.state_dict()
            for k in want:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                           atol=atol, rtol=0, err_msg=f"{name} {k}")


GATES = {"both": (True, True), "generator_warmup": (True, False),
         "discriminator_only": (False, True)}


@pytest.mark.parametrize("gates", list(GATES))
def test_sgd_gan_step_matches_jax(gates):
    """One whole step with SGD, so that each parameter's change is lr times
    its gradient: parameters and spectral vectors atol 1e-6, metrics rtol
    1e-5. ``generator_warmup`` is ``make_gan_step(include_adversarial=False)``,
    ``discriminator_only`` is ``make_gan_step(train_generator=False)``."""
    pair = _Pair(SGD)
    before = {n: {k: v.clone() for k, v in d.state_dict().items()}
              for n, d in pair.discs.items()}
    gen_before = {k: v.clone() for k, v in pair.gen.state_dict().items()}
    want, got = pair.run(*pair.steps(*GATES[gates]))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    pair.assert_weights_match(atol=1e-6)
    train_generator, include_adversarial = GATES[gates]
    gen_moved = any(not torch.equal(gen_before[k], v)
                    for k, v in pair.gen.state_dict().items())
    disc_moved = any(not torch.equal(before[n][k], v) for n, d in pair.discs.items()
                     for k, v in d.state_dict().items())
    assert gen_moved == train_generator and disc_moved == include_adversarial


@pytest.mark.parametrize("gates", list(GATES))
def test_gan_step_spans(gates):
    """One step under a CPU profiler: one ``kantts.gan.step``; inside it the
    phases the gates open, once each, in order and apart (the generator's
    three with ``train_generator``, the discriminators' four with
    ``include_adversarial``); the generator's forward in ``g_loss`` and
    ``d_regen``; each discriminator family's in each loss phase once a
    pass through ``run_discriminators`` (fake and real: feature maps in
    ``g_loss``, scores in ``d_loss``), none with the adversarial terms
    off; no network span outside a phase."""
    train_generator, include_adversarial = GATES[gates]
    torch.manual_seed(0)
    gen = Generator(**GEN).train()
    discs = {n: DISCS[n][1](**DISCS[n][3]).train() for n in DISCS}
    gen_opt, gen_sched, _ = optimizer_builder(gen.parameters(), ADAM, MULTISTEP)
    parts = {n: optimizer_builder(d.parameters(), ADAM, MULTISTEP) for n, d in discs.items()}
    step = make_gan_step(gen, discs, criterion_builder(LOSS_CFG), gen_opt, gen_sched,
                         {n: p[0] for n, p in parts.items()},
                         {n: p[1] for n, p in parts.items()},
                         train_generator=train_generator,
                         include_adversarial=include_adversarial)
    wav, mel = (torch.from_numpy(a) for a in _batch())
    with cpu_profile() as prof:
        step(wav, mel)
    spans = recorded_spans(prof, "kantts.gan.")
    (name, t0, t1), = [s for s in spans if s[0] == profiling.GAN_STEP]
    assert all(t0 <= a and b <= t1 for _, a, b in spans)
    phases = [s for s in spans if s[0] in profiling.GAN_PHASES]
    g, d = profiling.GAN_PHASES[:3], profiling.GAN_PHASES[3:]
    assert [s[0] for s in phases] == ([*g] if train_generator else []) + (
        [*d] if include_adversarial else [])
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    fams = {profiling.gan_net(n): 2 for n in DISCS}
    want = {profiling.GAN_G_LOSS: {profiling.GAN_GENERATOR: 1,
                                   **(fams if include_adversarial else {})},
            profiling.GAN_D_REGEN: {profiling.GAN_GENERATOR: 1},
            profiling.GAN_D_LOSS: fams}
    nets = [s for s in spans if s[0].startswith("kantts.gan.net.")]
    inside = 0
    for phase, a, b in phases:
        got = collections.Counter(n for n, x, y in nets if a <= x and y <= b)
        assert got == want.get(phase, {}), phase
        inside += sum(got.values())
    assert inside == len(nets)


def test_three_adam_steps_match_jax():
    """The published optimizer (Adam, betas 0.5/0.9) and a MultiStepLR that
    halves the rate after updates 1 and 2: parameters and spectral vectors
    atol 1e-5, metrics rtol 1e-5. Adam divides each gradient by its running
    magnitude, so a coordinate whose gradient were rounding noise could move
    by up to about lr (2e-4) differently in the two packages; these inputs
    have none (4.5e-7 and 3.1e-7 apart on the CPU), and the bound keeps it
    that way."""
    pair = _Pair(ADAM, MULTISTEP)
    j_step, t_step = pair.steps()
    for _ in range(3):
        want, got = pair.run(j_step, t_step)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    pair.assert_weights_match(atol=1e-5)
    assert pair.gen_sched.last_epoch == 3
    assert pair.gen_opt.param_groups[0]["lr"] == pytest.approx(2e-4 * 0.25)


def test_eval_step_matches_jax():
    pair = _Pair(SGD)
    j_eval = j_make_gan_eval_step(pair.j_gen, pair.j_discs, pair.j_crit)
    want, want_wav = j_eval(pair.state, jnp.asarray(pair.wav), jnp.asarray(pair.mel),
                            jax.random.PRNGKey(0))
    before = {n: {k: v.clone() for k, v in d.state_dict().items()}
              for n, d in pair.discs.items()}
    got, wav = make_gan_eval_step(pair.gen, pair.discs, pair.crit)(
        torch.from_numpy(pair.wav), torch.from_numpy(pair.mel))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(wav.numpy(), np.asarray(want_wav), atol=1e-5, rtol=0)
    assert all(torch.equal(before[n][k], v) for n, d in pair.discs.items()
               for k, v in d.state_dict().items())


# ----------------------------------------------------- builder, CLI, serving


def test_builder_refuses_what_is_not_ported():
    """bf16 (``mixed_precision``) builds with float32 parameters and a bf16
    output; bf16 with a multi-band generator is refused by name, as the JAX
    package cannot run it (its PQMF synthesis fails on a bf16 signal); NSF,
    PQMF and the MultiSpecDiscriminator build (hifigan_v1_16k.yaml with a
    narrow generator, its MSD and MPD left out), each with what it brings."""
    narrow = {"channels": 32, "resblock_kernel_sizes": [3], "resblock_dilations": [[1]]}
    cfg = get_config("hifigan_v1_16k")
    cfg.update(mixed_precision=True)
    cfg["Model"]["Generator"]["params"].update(narrow)
    gen = hifigan_model_builder(cfg)
    assert gen.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in gen.parameters())
    with torch.no_grad():
        assert gen(torch.randn(1, 4, 80)).dtype == torch.bfloat16
    cfg["Model"]["Generator"]["params"].update(
        out_channels=4, upsample_scales=[5, 5, 2], upsample_kernal_sizes=[10, 10, 4])
    with pytest.raises(NotImplementedError, match="mixed_precision.*PQMF"):
        hifigan_model_builder(cfg)
    with pytest.raises(TypeError, match="bfloat16"):
        JPQMF(subbands=4).synthesis(jnp.zeros((1, 8, 4), jnp.bfloat16))
    cases = {
        "NSF": lambda c: c["Model"]["Generator"]["params"].update(
            nsf_params={"nb_harmonics": 7, "sampling_rate": 16000}),
        "PQMF": lambda c: c["Model"]["Generator"]["params"].update(
            out_channels=4, upsample_scales=[5, 5, 2], upsample_kernal_sizes=[10, 10, 4]),
        "MultiSpecDiscriminator": lambda c: c["Model"].update(
            MultiSpecDiscriminator={"params": {"discriminator_params": {"channels": 4}},
                                    "optimizer": ADAM}),
    }
    for name, change in cases.items():
        with open(os.path.join(ROOT, "kantts_tpu_torch", "resources", "configs",
                               "hifigan_v1_16k.yaml")) as f:
            cfg = yaml.safe_load(f)
        cfg["Model"]["Generator"]["params"].update(narrow)
        del cfg["Model"]["MultiScaleDiscriminator"], cfg["Model"]["MultiPeriodDiscriminator"]
        change(cfg)
        built = hifigan_gan_builder(cfg)
        assert (built["generator"].nsf_params is not None) == (name == "NSF")
        assert (built["pqmf"] is not None) == (name == "PQMF")
        assert list(built["discriminators"]) == (
            ["MultiSpecDiscriminator"] if name == "MultiSpecDiscriminator" else [])
        mel = torch.randn(1, 4, 82 if name == "NSF" else 80)
        with torch.no_grad():
            y = built["generator"](mel, generator=torch.Generator().manual_seed(0))
        assert y.shape == ((1, 4 * 50, 4) if name == "PQMF" else (1, 4 * 200, 1))


def gan_config(stage: str, **keys) -> str:
    """hifigan_v1_16k.yaml at small widths (the generator keeps 80 mels and
    the hop of 200), B=2, 1200-sample crops, 4 steps, intervals of 2."""
    with open(os.path.join(ROOT, "kantts_tpu", "configs", "hifigan_v1_16k.yaml")) as f:
        cfg = yaml.safe_load(f)
    model = cfg["Model"]
    model["Generator"]["params"].update(channels=32, resblock_kernel_sizes=[3],
                                        resblock_dilations=[[1, 3]])
    model["MultiScaleDiscriminator"]["params"]["discriminator_params"].update(
        MSD_CFG["discriminator_params"])
    model["MultiPeriodDiscriminator"]["params"]["discriminator_params"].update(
        MPD_CFG["discriminator_params"])
    cfg.update(batch_size=2, batch_max_steps=1200, num_workers=0,
               train_max_steps=4, save_interval_steps=2, eval_interval_steps=2,
               log_interval_steps=2)
    cfg.update(keys)
    path = os.path.join(stage, "model.yaml")
    os.makedirs(stage, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _ckpts(stage):
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(stage, "ckpt", "*")))


@pytest.mark.usefixtures("torch_one_thread")
def test_train_hifigan_cli_resume_and_serve(tmp_path, caplog):
    data, stage = str(tmp_path / "data"), str(tmp_path / "stage")
    write_voc_corpus(data, 8, (0.4, 0.6), seed=0)
    cfg = gan_config(stage)
    with caplog.at_level(logging.INFO):
        train_hifigan.main(["--model_config", cfg, "--root_dir", data,
                            "--stage_dir", stage, "--device", "cpu"])
    assert _ckpts(stage) == ["checkpoint_2.ckpt", "checkpoint_4.ckpt"]
    # the JAX trainer's waveform PNGs beside the wavs
    pngs = ["0_gen.png", "0_ref.png", "1_gen.png", "1_ref.png"] if plot.available() else []
    assert sorted(os.listdir(os.path.join(stage, "intermediate_results_4"))) == sorted(
        ["0_gen.wav", "0_ref.wav", "1_gen.wav", "1_ref.wav"] + pngs)
    assert_scalars_match_log(os.path.join(stage, "log"), caplog.records)
    ckpt2 = os.path.join(stage, "ckpt", "checkpoint_2.ckpt")
    payload = torch.load(ckpt2, weights_only=True)
    assert set(payload) == {"model", "config", "optimizer", "scheduler", "steps"}
    assert payload["steps"] == 2
    assert set(payload["model"]) == {"generator", "discriminator"}
    assert set(payload["model"]["discriminator"]) == {"MultiScaleDiscriminator",
                                                      "MultiPeriodDiscriminator"}
    assert payload["scheduler"]["discriminator"]["MultiPeriodDiscriminator"][
        "last_epoch"] == 2
    u_key = "discriminators.0.convs.0.0.weight_u"
    assert u_key in payload["model"]["discriminator"]["MultiScaleDiscriminator"]

    # a true resume: steps 3 and 4, schedules and spectral state restored;
    # the saves go through the writer thread and equal a synchronous save
    resumed = str(tmp_path / "resumed")
    trainer = train_hifigan.train(gan_config(resumed, async_checkpoint=True), data,
                                  resumed, resume_path=ckpt2,
                                  resume_training_state=True, device="cpu")
    assert trainer.steps_taken == 2 and trainer.steps == 5
    assert trainer.gen_scheduler.last_epoch == 4
    assert _ckpts(resumed) == ["checkpoint_4.ckpt"]
    assert trainer._ckpt_writer is not None
    trainer.steps = 4
    trainer.save_checkpoint(str(tmp_path / "sync_4.ckpt"))
    assert_same_checkpoint(os.path.join(resumed, "ckpt", "checkpoint_4.ckpt"),
                           str(tmp_path / "sync_4.ckpt"))

    # weights only (fine-tune start): step 1 on, fresh optimizers
    tuned = str(tmp_path / "tuned")
    trainer = train_hifigan.train(gan_config(tuned, train_max_steps=1), data, tuned,
                                  resume_path=ckpt2, device="cpu")
    assert trainer.steps_taken == 1
    assert trainer.gen_scheduler.last_epoch == 1
    assert len(trainer.gen_optimizer.state) > 0

    # the generator of a GAN checkpoint serves through text_to_wav as it is
    voc_ckpt = os.path.join(stage, "ckpt", "checkpoint_4.ckpt")
    voc, _ = load_checkpoint(voc_ckpt, torch.device("cpu"))
    assert isinstance(voc, Generator) and not voc.training
    am_cfg = get_config("sambert_16k_MAS")
    am_cfg["Model"]["KanTtsSAMBERT"]["params"] = dict(TINY, num_mels=80, MAS=True,
                                                      dur_pred_bias_init=2.2)
    am_ckpt = str(tmp_path / "am.pt")
    save_checkpoint(am_ckpt, build_sambert(am_cfg, seed=0), am_cfg)
    text = tmp_path / "text.txt"
    text.write_text("ni3 hao3 .\n")
    stats = text_to_wav(str(tmp_path / "wav"), am_ckpt, voc_ckpt, str(text),
                        device=torch.device("cpu"))
    assert stats["audio_seconds"] > 0
    wavs = glob.glob(str(tmp_path / "wav" / "res_wavs" / "*.wav"))
    assert wavs and all(np.isfinite(wavfile.read(w)[1]).all() for w in wavs)


@pytest.mark.usefixtures("torch_one_thread")
def test_train_hifigan_refuses_what_it_cannot_do(tmp_path):
    """bf16 trains (2 steps, float32 parameters and Adam moments after); bf16
    with a multi-band generator is refused before the data loads; without a
    card the default device raises."""
    data = str(tmp_path / "data")
    write_voc_corpus(data, 4, (0.3, 0.4), seed=1)
    stage = str(tmp_path / "s")
    trainer = train_hifigan.train(gan_config(stage, mixed_precision=True,
                                             train_max_steps=2), data, stage,
                                  device="cpu")
    assert trainer.steps_taken == 2 and trainer.generator.dtype == torch.bfloat16
    for module, opt in [(trainer.generator, trainer.gen_optimizer)] + [
            (trainer.discriminators[n], trainer.disc_optimizers[n])
            for n in trainer.discriminators]:
        assert all(p.dtype == torch.float32 for p in module.parameters())
        assert all(v.dtype == torch.float32 for s in opt.state.values()
                   for v in s.values() if v.is_floating_point())
    multiband = gan_config(str(tmp_path / "mb"), mixed_precision=True)
    with open(multiband) as f:
        cfg = yaml.safe_load(f)
    cfg["Model"]["Generator"]["params"].update(
        out_channels=4, upsample_scales=[5, 5, 2], upsample_kernal_sizes=[10, 10, 4])
    with open(multiband, "w") as f:
        yaml.safe_dump(cfg, f)
    with pytest.raises(NotImplementedError, match="mixed_precision.*PQMF"):
        train_hifigan.train(multiband, data, str(tmp_path / "mb"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_hifigan.train(gan_config(stage), data, stage)


def test_voc_corpus_fits_the_dataset(tmp_path):
    """Every mel covers its wav at the hop of 200 (``VocDataset`` asserts
    it), and the mel is the port's extractor of the wav."""
    write_voc_corpus(str(tmp_path), 6, (0.2, 0.5), seed=2)
    for path in sorted(glob.glob(str(tmp_path / "wav" / "*.wav"))):
        wav = load_wav(path, 16000)
        mel = np.load(os.path.join(str(tmp_path), "mel", os.path.basename(path)[:-4]
                                   + ".npy"))
        assert mel.shape == (1 + len(wav) // 200, 80)
        assert np.isfinite(wav).all() and 0.3 < np.abs(wav).max() <= 0.5 + 1e-4
        assert np.isfinite(mel).all() and 0.0 <= mel.min() and mel.max() <= 1.0


def test_gan_modules_import_and_train_without_jax(tmp_path):
    """A fresh process where jax, flax, optax and the JAX package's dsp,
    models, train, losses and bin cannot be imported: every module of
    kantts_tpu_torch imports, and train_hifigan runs 2 steps on the CPU."""
    data, stage = str(tmp_path / "data"), str(tmp_path / "stage")
    write_voc_corpus(data, 6, (0.3, 0.4), seed=3)
    cfg = gan_config(stage, train_max_steps=2)
    blocked = ("jax", "flax", "optax", "kantts_tpu.dsp", "kantts_tpu.models",
               "kantts_tpu.train", "kantts_tpu.losses", "kantts_tpu.bin")
    code = (
        "import importlib, pkgutil, sys\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        "import kantts_tpu_torch\n"
        "for m in pkgutil.walk_packages(kantts_tpu_torch.__path__, 'kantts_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from kantts_tpu_torch.bin.train_hifigan import train\n"
        f"trainer = train({cfg!r}, {data!r}, {stage!r}, device='cpu')\n"
        "assert trainer.steps_taken == 2, trainer.steps_taken\n"
        f"assert all(sys.modules[n] is None for n in {blocked!r})\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert os.path.exists(os.path.join(stage, "ckpt", "checkpoint_2.ckpt"))

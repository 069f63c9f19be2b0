"""The port's multi-band and spectral pieces against the JAX package, at small
widths on the CPU: the PQMF filter bank, the MultiSpecDiscriminator through
its weight bridge, the sub-band STFT loss, one GAN step with NSF, PQMF, the
sub-band loss and the MultiSpecDiscriminator together, ``train_hifigan`` on
such a vocoder, and the config matrix: which of the JAX package's model
configs the port builds.

Weights are made by the JAX package's init and reach the port through the
weight bridges; inputs are numpy arrays from a seed. The NSF source's random
draws cannot match across frameworks, so the GAN step runs both generators
on one excitation, drawn by the JAX generator (``excitation=``).
Tolerances: PQMF atol 1e-6; scores and feature maps atol 1e-5; spectral
vectors atol 1e-6; criteria rtol 1e-5; one SGD step: parameters and
spectral vectors atol 1e-6, metrics rtol 1e-5 (those of
``tests/test_torch_port_gan.py``).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch import nn

from kantts_tpu.losses import losses as jl
from kantts_tpu.models.hifigan.discriminators import MultiSpecDiscriminator as JMSpecD
from kantts_tpu.models.hifigan.generator import Generator as JGenerator
from kantts_tpu.models.pqmf import PQMF as JPQMF
from kantts_tpu.train.optim import optimizer_builder as j_optimizer_builder
from kantts_tpu.train.states import GanTrainState
from kantts_tpu.train.steps import make_gan_step as j_make_gan_step
from kantts_tpu_torch.bin import train_hifigan
from kantts_tpu_torch.losses import criterion_builder
from kantts_tpu_torch.models.builder import (
    build_sambert,
    hifigan_gan_builder,
    model_builder,
)
from kantts_tpu_torch.models.hifigan.discriminators import MultiSpecDiscriminator, NormConv
from kantts_tpu_torch.models.hifigan.generator import Generator
from kantts_tpu_torch.models.pqmf import PQMF
from kantts_tpu_torch.train.optim import optimizer_builder
from kantts_tpu_torch.train.steps import make_gan_step
from kantts_tpu_torch.utils.convert import (
    hifigan_state_dict_from_jax,
    mspecd_state_dict_from_jax,
)
from kantts_tpu_torch.utils.corpus import write_voc_corpus
from test_sambert import TINY
from test_torch_port_gan import gan_config
from test_torch_port_hifigan import small_generator_cfg
from test_train_steps import LOSS_CFG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "kantts_tpu", "configs")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --------------------------------------------------------------------- PQMF


def test_pqmf_matches_jax():
    """At waveform scale: a signal of std 0.3, and its own sub-bands (the
    63-tap sums round differently in the two packages, by a few 1e-7 of
    the output's magnitude)."""
    x = (0.3 * np.random.RandomState(0).randn(2, 1024, 1)).astype(np.float32)
    jp, tp = JPQMF(subbands=4), PQMF(subbands=4)
    want = np.asarray(jp.analysis(jnp.asarray(x)))
    got = tp.analysis(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 256, 4)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    bands = want
    want = np.asarray(jp.synthesis(jnp.asarray(bands)))
    got = tp.synthesis(torch.from_numpy(bands)).numpy()
    assert got.shape == want.shape == (2, 1024, 1)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert not list(tp.parameters())  # the filters are fixed buffers


def test_pqmf_near_perfect_reconstruction():
    """As ``tests/test_hifigan.py`` holds the JAX package's."""
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 4096, 1).astype(np.float32)) * 0.3
    pqmf = PQMF(subbands=4)
    bands = pqmf.analysis(x)
    assert bands.shape == (1, 1024, 4)
    recon = pqmf.synthesis(bands)
    assert recon.shape == x.shape
    a, b = x[0, 100:-100, 0].numpy(), recon[0, 100:-100, 0].numpy()
    assert np.mean((a - b) ** 2) / np.mean(a ** 2) < 1e-4


# ------------------------------------------------------- MultiSpec, losses

MSPECD_CFG = {"fft_sizes": (64, 32), "hop_sizes": (8, 4), "win_lengths": (32, 16),
              "discriminator_params": {"channels": 4, "kernel_sizes": [5, 3]}}


@pytest.mark.parametrize("norm", ["weight", "spectral"])
def test_multispec_discriminator_matches_jax(norm):
    """Scores and every feature map through ``mspecd_state_dict_from_jax``,
    then the spectral vectors stored by ``update_stats=True``."""
    cfg = dict(MSPECD_CFG, discriminator_params=dict(
        MSPECD_CFG["discriminator_params"], use_spectral_norm=norm == "spectral"))
    wav = (0.3 * np.random.RandomState(2).randn(2, 600, 1)).astype(np.float32)
    jd = JMSpecD(**cfg)
    variables = jd.init(jax.random.PRNGKey(4), jnp.asarray(wav))
    spectral = _np(variables.get("spectral", {}))
    (want_out, want_fmaps), mutated = jax.jit(lambda v, x: jd.apply(
        v, x, True, mutable=["spectral"]))(variables, jnp.asarray(wav))
    disc = MultiSpecDiscriminator(**cfg)
    disc.load_state_dict(mspecd_state_dict_from_jax(_np(variables["params"]), cfg,
                                                    spectral or None), strict=True)
    with torch.no_grad():
        out, fmaps = disc(torch.from_numpy(wav).transpose(1, 2), update_stats=True)
    assert len(out) == len(want_out) == 2
    for got, want in zip(out, want_out):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., 0], atol=1e-5,
                                   rtol=0)
    for fmap, want_fmap in zip(fmaps, want_fmaps):
        assert len(fmap) == len(want_fmap) == 6
        for got, want in zip(fmap, want_fmap):
            np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1),
                                       np.asarray(want), atol=1e-5, rtol=0)
    us = [k for k in disc.state_dict() if k.endswith("weight_u")]
    assert bool(us) == (norm == "spectral")
    if us:
        new = mspecd_state_dict_from_jax(_np(variables["params"]), cfg,
                                         _np(mutated["spectral"]))
        for k in us:
            np.testing.assert_allclose(disc.state_dict()[k].numpy(), new[k].numpy(),
                                       atol=1e-6, rtol=0, err_msg=k)


SUBBAND = {"fft_sizes": [32, 64, 16], "hop_sizes": [4, 8, 2],
           "win_lengths": [16, 32, 8], "window": "hann_window"}


def test_subband_stft_loss_matches_jax():
    """The criterion the builder makes for ``subband_stft_loss`` (a
    multi-resolution STFT loss), on (B, sub-bands, T) inputs as the GAN step
    gives it; the published resolutions too, one of them an odd FFT size."""
    rng = np.random.RandomState(5)
    y_hat, y = (0.3 * rng.randn(2, 4, 400)).astype(np.float32), \
        (0.3 * rng.randn(2, 4, 400)).astype(np.float32)
    published = {"fft_sizes": [384, 683, 171], "hop_sizes": [35, 75, 15],
                 "win_lengths": [150, 300, 60], "window": "hann_window"}
    for params in (SUBBAND, published):
        cfg = {"Loss": {"subband_stft_loss": {"enable": True, "params": params}}}
        want = jl.criterion_builder(cfg)["subband_stft_loss"](jnp.asarray(y_hat),
                                                              jnp.asarray(y))
        got = criterion_builder(cfg)["subband_stft_loss"](torch.from_numpy(y_hat),
                                                          torch.from_numpy(y))
        np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want],
                                   rtol=1e-5)


# ---------------------------------------------------------------- GAN step

GEN_MB = dict(small_generator_cfg(), out_channels=4,
              nsf_params={"nb_harmonics": 7, "sampling_rate": 16000})
B, FRAMES, HOP = 2, 8, 64  # hop: 4 x 4 sub-band samples, x 4 bands
MB_LOSS = {"Loss": dict(
    LOSS_CFG["Loss"],
    stft_loss={"enable": True, "params": {"fft_sizes": [128, 64], "hop_sizes": [16, 8],
                                          "win_lengths": [64, 32]},
               "weights": 1.0},
    subband_stft_loss={"enable": True, "params": SUBBAND})}
MB_DISCS = {"MultiSpecDiscriminator": (
                JMSpecD, MultiSpecDiscriminator, mspecd_state_dict_from_jax,
                dict(MSPECD_CFG, discriminator_params=dict(
                    MSPECD_CFG["discriminator_params"], use_spectral_norm=True)))}


class _JaxInjected:
    """The JAX generator as ``make_gan_step`` calls it, with one excitation
    injected in place of its source's draws."""

    def __init__(self, gen, excitation):
        self.gen, self.excitation = gen, excitation

    def apply(self, variables, mel, rngs=None):
        return self.gen.apply(variables, mel, excitation=self.excitation)


class _PortInjected(nn.Module):
    """The port's generator with the same excitation injected."""

    def __init__(self, gen, excitation):
        super().__init__()
        self.gen, self.excitation = gen, excitation

    def forward(self, mel, generator=None):
        return self.gen(mel, excitation=self.excitation)


def _nsf_mel(rng, b, frames, n_mels=80):
    mel = rng.randn(b, frames, n_mels + 2).astype(np.float32)
    mel[..., -2] = rng.uniform(80.0, 300.0, (b, frames))
    mel[..., -1] = (rng.rand(b, frames) > 0.3).astype(np.float32)
    return mel


def test_nsf_multiband_gan_step_matches_jax():
    """One SGD step of an NSF generator with 4 PQMF sub-bands, the sub-band
    STFT loss beside the full-band one (so the 0.5 on the full-band term
    shows), and a spectral-normed MultiSpecDiscriminator."""
    rng = np.random.RandomState(6)
    mel = _nsf_mel(rng, B, FRAMES)
    wav = (0.3 * rng.randn(B, FRAMES * HOP, 1)).astype(np.float32)
    j_gen = JGenerator(**GEN_MB)
    gen_vars = j_gen.init({"params": jax.random.PRNGKey(0),
                           "noise": jax.random.PRNGKey(1)}, jnp.asarray(mel))
    gen_params = _np(gen_vars["params"])
    excitation = j_gen.apply(gen_vars, jnp.asarray(mel), excitation_only=True,
                             rngs={"noise": jax.random.PRNGKey(2)})
    assert excitation.shape == (B, FRAMES * HOP // 4, 1)
    j_discs, disc_params, spectral = {}, {}, {}
    for i, (name, (jcls, _, _, cfg)) in enumerate(MB_DISCS.items()):
        j_discs[name] = jcls(**cfg)
        variables = j_discs[name].init(jax.random.PRNGKey(3 + i), jnp.asarray(wav))
        disc_params[name] = _np(variables["params"])
        spectral[name] = _np(variables.get("spectral", {}))
    sgd = {"type": "SGD", "params": {"lr": 1e-3}}
    gen_tx, _ = j_optimizer_builder(sgd, None)
    disc_txs = {n: j_optimizer_builder(sgd, None)[0] for n in j_discs}
    state = GanTrainState(gen_params, gen_tx.init(gen_params), disc_params,
                          {n: disc_txs[n].init(disc_params[n]) for n in j_discs},
                          spectral, jnp.asarray(0, dtype=jnp.int32))
    j_step = j_make_gan_step(_JaxInjected(j_gen, excitation), j_discs,
                             jl.criterion_builder(MB_LOSS), gen_tx, disc_txs,
                             pqmf=JPQMF(subbands=4))
    state, want = j_step(state, jnp.asarray(wav), jnp.asarray(mel),
                         jax.random.PRNGKey(7))

    gen = Generator(**GEN_MB)
    gen.load_state_dict(hifigan_state_dict_from_jax(gen_params, GEN_MB), strict=True)
    discs = {}
    for name, (_, cls, bridge, cfg) in MB_DISCS.items():
        discs[name] = cls(**cfg)
        discs[name].load_state_dict(bridge(disc_params[name], cfg,
                                           spectral[name] or None), strict=True)
        discs[name].train()
    gen_opt, gen_sched, _ = optimizer_builder(gen.parameters(), sgd, None)
    parts = {n: optimizer_builder(d.parameters(), sgd, None) for n, d in discs.items()}
    t_step = make_gan_step(
        _PortInjected(gen.train(), torch.from_numpy(np.asarray(excitation))), discs,
        criterion_builder(MB_LOSS), gen_opt, gen_sched,
        {n: p[0] for n, p in parts.items()}, {n: p[1] for n, p in parts.items()},
        pqmf=PQMF(subbands=4))
    got = t_step(torch.from_numpy(wav), torch.from_numpy(mel))

    want = _np(want)
    assert want.keys() == got.keys()
    assert {"sub_spectral_convergence_loss", "sub_log_stft_magnitude_loss",
            "spectral_convergence_loss"} <= set(got)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-5, err_msg=k)
    want_sd = hifigan_state_dict_from_jax(_np(state.gen_params), GEN_MB)
    for k, v in gen.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-6, rtol=0,
                                   err_msg=k)
    for name, (_, _, bridge, cfg) in MB_DISCS.items():
        want_sd = bridge(_np(state.disc_params[name]), cfg,
                         _np(state.spectral[name]) or None)
        for k, v in discs[name].state_dict().items():
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-6,
                                       rtol=0, err_msg=f"{name} {k}")


def test_train_hifigan_nsf_multiband_cli(tmp_path):
    """``train_hifigan`` on a 16 kHz NSF tone corpus: an NSF generator with 4
    PQMF sub-bands (hop 50 per band, 200 in all), the MultiSpecDiscriminator
    beside MPD and MSD, and the sub-band STFT loss; 4 steps, the eval and
    its full-band wavs, a checkpoint that serves its generator."""
    data, stage = str(tmp_path / "data"), str(tmp_path / "stage")
    write_voc_corpus(data, 8, (0.4, 0.6), seed=3, nsf=True)
    cfg_path = gan_config(stage)
    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    cfg["Model"]["Generator"]["params"].update(
        out_channels=4, upsample_scales=[5, 5, 2], upsample_kernal_sizes=[10, 10, 4],
        nsf_params={"nb_harmonics": 7, "sampling_rate": 16000})
    cfg["Model"]["MultiSpecDiscriminator"] = {
        "params": {"discriminator_params": {"channels": 4}},
        "optimizer": cfg["Model"]["Generator"]["optimizer"]}
    cfg["Loss"]["subband_stft_loss"] = {"enable": True, "params": {
        "fft_sizes": [128, 256, 64], "hop_sizes": [16, 32, 8],
        "win_lengths": [64, 128, 32]}}
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    trainer = train_hifigan.train(cfg_path, data, stage, device="cpu")
    assert trainer.steps_taken == 4
    train_means = [m for kind, _, m in trainer.history if kind == "train"]
    assert all(np.isfinite(v) for m in train_means for v in m.values())
    assert "train/sub_spectral_convergence_loss" in train_means[-1]
    assert set(trainer.discriminators) == {"MultiScaleDiscriminator",
                                           "MultiPeriodDiscriminator",
                                           "MultiSpecDiscriminator"}
    gens = glob.glob(os.path.join(stage, "intermediate_results_4", "*_gen.wav"))
    assert gens
    ckpt = torch.load(os.path.join(stage, "ckpt", "checkpoint_4.ckpt"),
                      map_location="cpu", weights_only=True)
    assert any(k.startswith("source_module.") for k in ckpt["model"]["generator"])


# ------------------------------------------------------------ config matrix

MODEL_CONFIGS = sorted(os.path.basename(p)[:-len(".yaml")]
                       for p in glob.glob(os.path.join(CONFIGS, "*.yaml"))
                       if not os.path.basename(p).startswith("audio_config"))
REFUSED = {}  # every config builds
SLIM_GEN = {"channels": 32, "resblock_kernel_sizes": [3],
            "resblock_dilations": [[1, 3]]}
SLIM_DISC = {"MultiScaleDiscriminator": {"channels": 16, "max_downsample_channels": 32,
                                         "max_groups": 4},
             "MultiPeriodDiscriminator": {"channels": 4, "max_downsample_channels": 8}}
SAMBERT_FLAGS = ("MAS", "NSF", "FP", "SE", "using_byte", "num_mels",
                 "nsf_norm_type", "nsf_f0_global_minimum", "nsf_f0_global_maximum")


def _slim(config):
    """The config at small widths; every flag it sets is kept."""
    model = config["Model"]
    if config["model_type"] == "sambert":
        params = model["KanTtsSAMBERT"]["params"]
        model["KanTtsSAMBERT"]["params"] = dict(
            TINY, **{k: params[k] for k in SAMBERT_FLAGS if k in params})
    elif config["model_type"] == "sybert":
        params = model["KanTtsTextsyBERT"]["params"]
        params.update({k: TINY[k] for k in params if k in TINY})
    elif config["model_type"] == "hifigan":
        model["Generator"]["params"].update(SLIM_GEN)
        for name, widths in SLIM_DISC.items():
            if name in model:
                model[name]["params"]["discriminator_params"].update(widths)
    return config


def test_config_matrix_counts():
    assert len(MODEL_CONFIGS) == 19
    assert len(set(MODEL_CONFIGS) - set(REFUSED)) == 19


def _all_float32(*modules):
    return all(p.dtype == torch.float32 for m in modules for p in m.parameters())


@pytest.mark.parametrize("mixed_precision", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", MODEL_CONFIGS)
def test_config_matrix(name, mixed_precision):
    """Each model config of the JAX package builds in the port at small
    widths, or raises NotImplementedError naming what is missing; with
    ``mixed_precision`` it builds to compute in bf16 with float32
    parameters (none of these configs is multi-band, the one combination
    that bf16 refuses)."""
    with open(os.path.join(CONFIGS, f"{name}.yaml")) as f:
        config = _slim(yaml.safe_load(f))
    config["mixed_precision"] = mixed_precision
    if name in REFUSED:
        with pytest.raises(NotImplementedError, match=REFUSED[name]):
            model_builder(config)
        return
    if config["model_type"] == "sambert":
        model = build_sambert(config)
        params = config["Model"]["KanTtsSAMBERT"]["params"]
        assert model.d_mel == params["num_mels"]
        assert not params.get("NSF") or params["num_mels"] == 82
        assert model.text_encoder.using_byte == params.get("using_byte", False)
        assert model.se_enable == params.get("SE", False)
        assert model.mel_decoder.dtype == (torch.bfloat16 if mixed_precision
                                           else None)
        assert _all_float32(model)
        assert model.fp_enable == params.get("FP", False)
        if model.fp_enable:  # the FP head computes in float32 either way
            assert all(m.compute_dtype is None for m in model.FP_predictor.modules()
                       if hasattr(m, "compute_dtype"))
        return
    if config["model_type"] == "sybert":  # float32 whatever mixed_precision says
        model = model_builder(config)
        assert not model.text_encoder.using_byte and model.text_encoder.ling_proj is None
        assert all(m.compute_dtype is None for m in model.modules()
                   if hasattr(m, "compute_dtype"))
        assert _all_float32(model)
        return
    built = hifigan_gan_builder(config)
    dtype = torch.bfloat16 if mixed_precision else None
    assert built["generator"].dtype == dtype
    assert all(c.dtype == dtype for d in built["discriminators"].values()
               for c in d.modules() if isinstance(c, NormConv))
    assert _all_float32(built["generator"], *built["discriminators"].values())
    gen_params = config["Model"]["Generator"]["params"]
    assert (built["generator"].nsf_params is not None) == ("nsf_params" in gen_params)
    assert built["pqmf"] is None
    assert set(built["discriminators"]) == {
        n for n in ("MultiScaleDiscriminator", "MultiPeriodDiscriminator",
                    "MultiSpecDiscriminator") if n in config["Model"]}

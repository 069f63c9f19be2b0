"""bf16 mixed precision of the PyTorch port against the JAX package, on the
CPU at tiny widths: SAM-BERT (teacher-forced forward, incremental PNCA
decode), the generator (plain and NSF), each discriminator, the GAN criteria
on a bf16 waveform, one SAM-BERT step and one GAN step, and a census of the
matmuls and convolutions by operand dtype.

The same weights (moved by the weight bridge) and numpy inputs go through
both packages. Tolerance: with e_ref = max |JAX bf16 - JAX f32| on the same
inputs, max |port bf16 - JAX bf16| <= 0.5 e_ref. A port that stayed in
float32 sits at about 1.0 e_ref and fails. The JAX side is compiled with
``xla_allow_excess_precision`` off: XLA on the CPU otherwise keeps some bf16
intermediates in float32 between fused ops, which the JAX program does not
ask for, and that alone puts it about one e_ref from a port that rounds
each op as the program says. With the flag off the two agree to float32
noise (``tools/torch_port_bf16_gaps.py`` prints both).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kantts_tpu.losses import losses as jl
from kantts_tpu.models.hifigan.discriminators import MultiPeriodDiscriminator as JMPD
from kantts_tpu.models.hifigan.discriminators import MultiScaleDiscriminator as JMSD
from kantts_tpu.models.hifigan.discriminators import MultiSpecDiscriminator as JMSpecD
from kantts_tpu.models.hifigan.generator import Generator as JGenerator
from kantts_tpu.models.sambert.sambert import KanTtsSAMBERT as JSAMBERT
from kantts_tpu.models.sambert.sambert import sambert_infer as j_sambert_infer
from kantts_tpu.train.optim import optimizer_builder as j_optimizer_builder
from kantts_tpu.train.states import GanTrainState, TrainState
from kantts_tpu.train.steps import make_gan_step as j_make_gan_step
from kantts_tpu.train.steps import make_sambert_step as j_make_sambert_step
from kantts_tpu.utils.torch_convert import convert_sambert
from kantts_tpu_torch.losses import criterion_builder
from kantts_tpu_torch.losses import losses as tl
from kantts_tpu_torch.models.builder import init_parameters
from kantts_tpu_torch.models.hifigan.discriminators import (
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    MultiSpecDiscriminator,
)
from kantts_tpu_torch.models.hifigan.generator import Generator
from kantts_tpu_torch.models.sambert import pnca as t_pnca
from kantts_tpu_torch.models.sambert.sambert import KanTtsSAMBERT, sambert_infer
from kantts_tpu_torch.train.optim import optimizer_builder
from kantts_tpu_torch.train.steps import make_gan_step, make_sambert_step
from kantts_tpu_torch.utils.convert import (
    hifigan_state_dict_from_jax,
    mpd_state_dict_from_jax,
    mspecd_state_dict_from_jax,
    msd_state_dict_from_jax,
)
from test_sambert import TINY
from test_torch_port_gan import GEN, MPD_CFG, MSD_CFG
from test_torch_port_hifigan import small_generator_cfg
from test_torch_port_train import MAS_LOSSES, _train_batch, _zero_dropout
from test_train_steps import LOSS_CFG

BF16 = "bfloat16"
NO_EXCESS = {"xla_allow_excess_precision": False}


def run_jax(fn, *args):
    """``fn(*args)`` jitted, compiled with every bf16 op rounded."""
    return jax.jit(fn).lower(*args).compile(NO_EXCESS)(*args)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def assert_bf16_close(port_bf16, jax_bf16, jax_f32, what=""):
    """max |port bf16 - JAX bf16| <= 0.5 e_ref, e_ref = max |JAX bf16 - JAX f32|;
    the JAX arrays are read in the port's shape."""
    port = _f32(port_bf16)
    want, ref = (_f32(a).reshape(port.shape) for a in (jax_bf16, jax_f32))
    e_ref = np.abs(want - ref).max()
    gap = np.abs(port - want).max()
    assert e_ref > 0, f"{what}: bf16 changes nothing, so the test cannot see it"
    assert gap <= 0.5 * e_ref, f"{what}: gap {gap} = {gap / e_ref:.3f} e_ref"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ census

CONTRACTIONS_JAX = ("dot_general", "conv_general_dilated")
CONTRACTIONS_TORCH = {"mm", "addmm", "bmm", "baddbmm", "convolution"}


def jax_census(closed_jaxpr, skip=("lstm", "blstm")):
    """Matmuls and convolutions of a jaxpr by operand dtype ("mixed" when the
    two differ). Recurrent ones are left out: those of an LSTM module and
    those in a scan or loop body, which run once per step and lower to
    other ops in the port."""
    count = collections.Counter()

    def walk(jaxpr, in_loop):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name in CONTRACTIONS_JAX and not in_loop:
                scopes = str(eqn.source_info.name_stack).split("/")
                if not set(scopes) & set(skip):
                    dts = {str(v.aval.dtype) for v in eqn.invars}
                    count[dts.pop() if len(dts) == 1 else "mixed"] += 1
            loop = in_loop or eqn.primitive.name in ("scan", "while")
            for p in eqn.params.values():
                for sub in p if isinstance(p, (list, tuple)) else [p]:
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner, loop)

    walk(closed_jaxpr.jaxpr, False)
    return dict(count)


class TorchCensus(TorchDispatchMode):
    """The port's matmuls and convolutions by operand dtype, as the
    dispatcher sees them, leaving out those inside ``nn.LSTM`` modules."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.count = collections.Counter()
        self.depth = 0
        self.hooks = []
        for m in model.modules():
            if isinstance(m, torch.nn.LSTM):
                self.hooks.append(m.register_forward_pre_hook(self._enter))
                self.hooks.append(m.register_forward_hook(self._leave))

    def _enter(self, *_):
        self.depth += 1

    def _leave(self, *_):
        self.depth -= 1

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in CONTRACTIONS_TORCH and not self.depth:
            dts = {str(a.dtype)[len("torch."):] for a in args[:3]
                   if isinstance(a, torch.Tensor) and a.ndim > 1}
            self.count[dts.pop() if len(dts) == 1 else "mixed"] += 1
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------- SAM-BERT


def _am_cfg(mas: bool, bf16: bool):
    # the duration head's bias makes inference decode about 2 frames a phone
    cfg = dict(TINY, MAS=mas, dur_pred_bias_init=1.0)
    if bf16:
        cfg["compute_dtype"] = BF16
    return cfg


@pytest.fixture(scope="module")
def am_pair():
    """-> pair(mas, bf16) -> (port model in eval mode, JAX model, JAX params),
    one seeded set of weights for all four."""
    made = {}

    def pair(mas: bool, bf16: bool):
        if (mas, bf16) not in made:
            cfg = _am_cfg(mas, bf16)
            port = KanTtsSAMBERT(cfg)
            init_parameters(port, seed=0)
            params = convert_sambert({k: v.numpy() for k, v in
                                      port.state_dict().items()}, cfg)
            made[(mas, bf16)] = (port.eval(), JSAMBERT(cfg), params)
        return made[(mas, bf16)]

    return pair


def _am_batch(mas: bool):
    batch = _train_batch(TINY, mas)
    return {k: np.asarray(v) for k, v in batch.items()}


def _j_forward(model):
    def fwd(params, b):
        return model.apply(
            {"params": params}, b["input_lings"], b["input_emotions"],
            b["input_speakers"], b["valid_input_lengths"],
            b["valid_output_lengths"], b["mel_targets"],
            duration_targets=b.get("durations"), pitch_targets=b["pitch_contours"],
            energy_targets=b["energy_contours"], attn_priors=b.get("attn_priors"),
            deterministic=True)
    return fwd


def _t_forward(model, b):
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        return model(t["input_lings"], t["input_emotions"], t["input_speakers"],
                     t["valid_input_lengths"], t["valid_output_lengths"],
                     t["mel_targets"], duration_targets=t.get("durations"),
                     pitch_targets=t["pitch_contours"],
                     energy_targets=t["energy_contours"],
                     attn_priors=t.get("attn_priors"))


AM_OUTPUTS = ("dec_outputs", "postnet_outputs", "pitch_predictions",
              "energy_predictions", "log_duration_predictions")


@pytest.mark.parametrize("mas", [False, True], ids=["durations", "mas"])
def test_sambert_forward_bf16_matches_jax(am_pair, mas):
    """The teacher-forced forward; with MAS the alignment maps are float32
    in both packages (``ConvAttention`` stays float32), so K1 sees the same
    maps as under float32."""
    b = _am_batch(mas)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want = {}
    for bf16 in (False, True):
        _, jm, params = am_pair(mas, bf16)
        want[bf16] = run_jax(_j_forward(jm), params, jb)
    port = am_pair(mas, True)[0]
    got = _t_forward(port, b)
    for k in AM_OUTPUTS:
        assert got[k].dtype == torch.float32, k
        assert_bf16_close(got[k], want[True][k], want[False][k], k)
    if mas:
        np.testing.assert_array_equal(_f32(got["attn_soft"]),
                                      _f32(_t_forward(am_pair(True, False)[0],
                                                      b)["attn_soft"]))


def test_sambert_dtype_census_matches_jax(am_pair):
    """The encoder's FFT blocks and the PNCA decoder in bf16, everything
    else float32, op for op as in the JAX jaxpr (MAS on)."""
    b = _am_batch(True)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    census = {}
    for bf16 in (True, False):
        port, jm, params = am_pair(True, bf16)
        want = jax_census(jax.make_jaxpr(_j_forward(jm))(params, jb))
        with TorchCensus(port) as got:
            _t_forward(port, b)
        assert dict(got.count) == want, bf16
        census[bf16] = want
    assert census[True][BF16] > 0 and set(census[False]) == {"float32"}
    assert sum(census[True].values()) == census[False]["float32"]


def test_pnca_incremental_decode_bf16_matches_jax(am_pair):
    """``sambert_infer``: the AR duration loop and the PNCA decode step by
    step, whose key/value caches hold bf16."""
    b = _am_batch(False)
    args = [b["input_lings"], b["input_emotions"], b["input_speakers"],
            b["valid_input_lengths"]]
    want = {}
    for bf16 in (False, True):
        _, jm, params = am_pair(False, bf16)
        want[bf16] = run_jax(lambda p, *a: j_sambert_infer(jm, {"params": p}, *a, 36),
                             params, *[jnp.asarray(a) for a in args])
    port = am_pair(False, True)[0]
    cache_dtypes = set()
    step = t_pnca.MultiHeadPNCAAttention.step

    def spy(self, x_t, t, cache_k, *rest):
        cache_dtypes.add(cache_k.dtype)
        return step(self, x_t, t, cache_k, *rest)

    t_pnca.MultiHeadPNCAAttention.step = spy
    try:
        got = sambert_infer(port, *[torch.from_numpy(a) for a in args], 36)
    finally:
        t_pnca.MultiHeadPNCAAttention.step = step
    assert cache_dtypes == {torch.bfloat16}
    np.testing.assert_array_equal(got["LR_length_rounded"].numpy(),
                                  np.asarray(want[True]["LR_length_rounded"]))
    for k in ("dec_outputs", "postnet_outputs", "duration_predictions"):
        assert_bf16_close(got[k], want[True][k], want[False][k], k)


# --------------------------------------------------------------- generator

NSF = {"nb_harmonics": 7, "sampling_rate": 16000}


def _gen_pair(nsf: bool):
    """-> (cfg, JAX params, port bf16, JAX f32, JAX bf16, mel (2, 21, C)); an
    NSF mel carries f0 (100-300 Hz) and uv as its last two channels."""
    cfg = dict(small_generator_cfg(), nsf_params=NSF if nsf else None)
    mel = np.random.RandomState(5).randn(2, 21, 82 if nsf else 80).astype(np.float32)
    if nsf:
        mel[..., -2] = 100.0 + 50.0 * np.abs(mel[..., -2])
        mel[..., -1] = mel[..., -1] > 0
    j32, j16 = JGenerator(**cfg), JGenerator(**cfg, dtype=jnp.bfloat16)
    params = _np(jax.jit(lambda m: j32.init({"params": jax.random.PRNGKey(0),
                                             "noise": jax.random.PRNGKey(1)},
                                            m))(jnp.asarray(mel))["params"])
    port = Generator(**cfg, dtype=torch.bfloat16)
    port.load_state_dict(hifigan_state_dict_from_jax(params, cfg), strict=True)
    return cfg, params, port.eval(), j32, j16, mel


@pytest.mark.parametrize("nsf", [False, True], ids=["plain", "nsf_excitation"])
def test_generator_bf16_matches_jax(nsf):
    """The output is bf16 in both packages. NSF with one excitation injected
    (the source's draws differ between the packages)."""
    cfg, params, port, j32, j16, mel = _gen_pair(nsf)
    exc = None
    if nsf:
        exc = np.tanh(np.random.RandomState(6).randn(2, 21 * 16, 1)).astype(np.float32)
    want = {}
    for dt, jm in ((False, j32), (True, j16)):
        want[dt] = run_jax(lambda p, m, e: jm.apply({"params": p}, m, excitation=e),
                           params, jnp.asarray(mel),
                           None if exc is None else jnp.asarray(exc))
    assert want[True].dtype == jnp.bfloat16
    with torch.no_grad():
        got = port(torch.from_numpy(mel),
                   excitation=None if exc is None else torch.from_numpy(exc))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 21 * 16, 1)
    assert_bf16_close(got, want[True], want[False], "generator")


@pytest.mark.parametrize("nsf", [False, True], ids=["plain", "nsf"])
def test_generator_dtype_census_matches_jax(nsf):
    """Every convolution in bf16, the NSF source's ``ffn`` included."""
    cfg, params, port, _, j16, mel = _gen_pair(nsf)
    want = jax_census(jax.make_jaxpr(lambda p, m: j16.apply(
        {"params": p}, m, rngs={"noise": jax.random.PRNGKey(2)}))(params,
                                                                  jnp.asarray(mel)))
    with TorchCensus(port) as census, torch.no_grad():
        port(torch.from_numpy(mel), generator=torch.Generator().manual_seed(0))
    assert dict(census.count) == want and set(want) == {BF16}


# ---------------------------------------------------------- discriminators

DISC_CASES = {
    "msd_dwt_spectral": (JMSD, MultiScaleDiscriminator, msd_state_dict_from_jax,
                         MSD_CFG),
    "mpd": (JMPD, MultiPeriodDiscriminator, mpd_state_dict_from_jax, MPD_CFG),
    "multispec": (JMSpecD, MultiSpecDiscriminator, mspecd_state_dict_from_jax,
                  {"fft_sizes": (128, 64), "hop_sizes": (16, 8),
                   "win_lengths": (64, 32),
                   "discriminator_params": {"channels": 4}}),
}


@pytest.mark.parametrize("case", list(DISC_CASES))
def test_discriminator_bf16_matches_jax(case):
    """A bf16 waveform (as the bf16 generator makes it) through each
    discriminator: scores and every feature map."""
    jcls, cls, bridge, cfg = DISC_CASES[case]
    wav = (0.3 * np.random.RandomState(1).randn(2, 160, 1)).astype(np.float32)
    wav16 = jnp.asarray(wav, dtype=jnp.bfloat16)
    j32, j16 = jcls(**cfg), jcls(**cfg, dtype=jnp.bfloat16)
    variables = _np(jax.jit(j32.init)(jax.random.PRNGKey(3), jnp.asarray(wav)))
    want = {}
    for bf16, jd in ((False, j32), (True, j16)):
        want[bf16] = run_jax(lambda v, w: jd.apply(v, w), variables,
                             wav16.astype(jnp.float32) if not bf16 else wav16)
    disc = cls(**cfg, dtype=torch.bfloat16)
    disc.load_state_dict(bridge(variables["params"], cfg,
                                variables.get("spectral")), strict=True)
    with torch.no_grad():
        out, fmaps = disc(torch.from_numpy(wav).to(torch.bfloat16).transpose(1, 2))
    for i, (got, w16, w32) in enumerate(zip(out, want[True][0], want[False][0])):
        assert got.dtype == torch.bfloat16
        assert_bf16_close(got, w16, w32, f"score {i}")
    for i, (fmap, f16, f32) in enumerate(zip(fmaps, want[True][1], want[False][1])):
        for j, (got, w16, w32) in enumerate(zip(fmap, f16, f32)):
            assert_bf16_close(np.moveaxis(_f32(got), 1, -1), w16, w32, f"fmap {i}.{j}")


def test_criteria_on_a_bf16_waveform_match_jax():
    """The mel and multi-resolution STFT losses of a bf16 fake against a
    float32 real waveform (both packages take the STFT in float32), and the
    adversarial and feature-matching losses of bf16 scores and maps."""
    rng = np.random.RandomState(4)
    y_hat = (0.3 * rng.randn(2, 1600)).astype(np.float32)
    y = (0.3 * rng.randn(2, 1600)).astype(np.float32)
    y16 = jnp.asarray(y_hat, dtype=jnp.bfloat16)
    mel_kw = LOSS_CFG["Loss"]["mel_loss"]["params"]
    res = dict(fft_sizes=(256, 128), hop_sizes=(32, 16), win_lengths=(128, 64))
    j_crit = {"mel": jl.MelSpectrogramLoss(**mel_kw),
              "stft": jl.MultiResolutionSTFTLoss(**res)}
    t_crit = {"mel": tl.MelSpectrogramLoss(**mel_kw),
              "stft": tl.MultiResolutionSTFTLoss(**res)}
    for name in j_crit:
        want = {bf16: run_jax(j_crit[name], y16 if bf16 else jnp.asarray(y_hat),
                              jnp.asarray(y)) for bf16 in (False, True)}
        got = t_crit[name](torch.from_numpy(y_hat).to(torch.bfloat16),
                           torch.from_numpy(y))
        assert_bf16_close(np.stack([_f32(g) for g in got]) if name == "stft" else got,
                          np.stack(want[True]) if name == "stft" else want[True],
                          np.stack(want[False]) if name == "stft" else want[False],
                          name)
    scores = [rng.randn(2, n).astype(np.float32) for n in (9, 5, 17)]
    fmaps = [[rng.randn(2, 4, 9).astype(np.float32), rng.randn(2, 8, 5).astype(np.float32)]
             for _ in range(2)]

    def both(fn_j, fn_t, *trees):
        want = {bf16: run_jax(fn_j, *jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32), trees))
            for bf16 in (False, True)}
        got = fn_t(*jax.tree_util.tree_map(
            lambda a: torch.from_numpy(a).to(torch.bfloat16), trees))
        return got, want

    got, want = both(jl.GeneratorAdversarialLoss(False), tl.GeneratorAdversarialLoss(False),
                     scores)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, want[True], want[False], "generator adversarial")
    got, want = both(jl.DiscriminatorAdversarialLoss(False),
                     tl.DiscriminatorAdversarialLoss(False), scores, scores[::-1])
    assert_bf16_close(np.stack([_f32(g) for g in got]), np.stack(want[True]),
                      np.stack(want[False]), "discriminator adversarial")
    got, want = both(jl.FeatureMatchLoss(False, False), tl.FeatureMatchLoss(False, False),
                     fmaps, fmaps[::-1])
    assert_bf16_close(got, want[True], want[False], "feature matching")


# ------------------------------------------------------------------- steps

def _dtypes_after(params, optimizer):
    """Every parameter and every optimizer state tensor is float32."""
    assert all(p.dtype == torch.float32 for p in params)
    moments = [v for s in optimizer.state.values() for v in s.values()
               if isinstance(v, torch.Tensor) and v.is_floating_point()]
    assert moments and all(v.dtype == torch.float32 for v in moments)
    assert not torch.is_autocast_enabled()


ADAM = {"type": "Adam", "params": {"lr": 1e-3}}


def test_bf16_sambert_step_matches_jax(am_pair):
    """One ``make_sambert_step`` (MAS, dropout off) in bf16: its losses
    against the JAX step's on the same weights, then float32 parameters and
    Adam moments. The JAX side is its eval step (``deterministic``), whose
    losses are the train step's without dropout."""
    b = _am_batch(True)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    loss_cfg = {"Loss": MAS_LOSSES}
    want = {}
    for bf16 in (False, True):
        _, jm, params = am_pair(True, bf16)
        tx, _ = j_optimizer_builder(ADAM, None)
        state = TrainState(params, tx.init(params), jnp.asarray(0, jnp.int32))
        step = j_make_sambert_step(jm, jl.criterion_builder(loss_cfg), tx,
                                   with_mas=True, fp_enable=False, train=False)
        want[bf16] = step.lower(state, jb, 50).compile(NO_EXCESS)(state, jb, 50)
    port = KanTtsSAMBERT(_am_cfg(True, True))
    port.load_state_dict(am_pair(True, True)[0].state_dict())
    _zero_dropout(port)
    optimizer, scheduler, clip = optimizer_builder(port.parameters(), ADAM, None)
    step = make_sambert_step(port, criterion_builder(loss_cfg), optimizer,
                             scheduler, clip, with_mas=True)
    got = step({k: torch.from_numpy(v) for k, v in b.items()}, 50)
    for k in ("mel_loss_", "mel_loss", "pitch_loss", "energy_loss", "dur_loss",
              "TotalLoss"):
        assert_bf16_close(got[k], want[True][k], want[False][k], k)
    _dtypes_after(list(port.parameters()), optimizer)


def _gan_setup(bf16: bool):
    """The tiny generator and MPD of ``test_torch_port_gan`` in the JAX
    package, computing in bf16 or float32, with the JAX init's weights. (The
    MSD's DWT and spectral norm are held to JAX by
    ``test_discriminator_bf16_matches_jax``; leaving the MSD out here halves
    the compile time of the JAX step.)"""
    rng = np.random.RandomState(0)
    mel = rng.randn(2, 8, 20).astype(np.float32)
    wav = (0.3 * rng.randn(2, 8 * 16, 1)).astype(np.float32)
    dt = {"dtype": jnp.bfloat16} if bf16 else {}
    gen, mpd = JGenerator(**GEN, **dt), JMPD(**MPD_CFG, **dt)
    gen_params = _np(jax.jit(JGenerator(**GEN).init)(jax.random.PRNGKey(0),
                                                     jnp.asarray(mel))["params"])
    disc_params = {"MultiPeriodDiscriminator": _np(jax.jit(JMPD(**MPD_CFG).init)(
        jax.random.PRNGKey(1), jnp.asarray(wav))["params"])}
    tx, _ = j_optimizer_builder(ADAM, None)
    state = GanTrainState(gen_params, tx.init(gen_params), disc_params,
                          {n: tx.init(p) for n, p in disc_params.items()},
                          {"MultiPeriodDiscriminator": {}},
                          jnp.asarray(0, dtype=jnp.int32))
    step = j_make_gan_step(gen, {"MultiPeriodDiscriminator": mpd},
                           jl.criterion_builder(LOSS_CFG), tx,
                           {"MultiPeriodDiscriminator": tx})
    return wav, mel, state, step


def test_bf16_gan_step_matches_jax():
    """One ``make_gan_step`` in bf16 against the JAX step with
    ``mixed_precision`` on the same weights and batch: every loss, then
    float32 parameters and Adam moments in both networks."""
    want = {}
    for bf16 in (False, True):
        wav, mel, state, step = _gan_setup(bf16)
        args = (state, jnp.asarray(wav), jnp.asarray(mel), jax.random.PRNGKey(7))
        want[bf16] = _np(step.lower(*args).compile(NO_EXCESS)(*args)[1])
    gen = Generator(**GEN, dtype=torch.bfloat16)
    gen.load_state_dict(hifigan_state_dict_from_jax(state.gen_params, GEN))
    mpd = MultiPeriodDiscriminator(**MPD_CFG, dtype=torch.bfloat16)
    mpd.load_state_dict(mpd_state_dict_from_jax(
        state.disc_params["MultiPeriodDiscriminator"], MPD_CFG))
    opts = {n: optimizer_builder(m.parameters(), ADAM, None)
            for n, m in (("Generator", gen), ("MultiPeriodDiscriminator", mpd))}
    step = make_gan_step(gen.train(), {"MultiPeriodDiscriminator": mpd.train()},
                         criterion_builder(LOSS_CFG), *opts["Generator"][:2],
                         {"MultiPeriodDiscriminator": opts["MultiPeriodDiscriminator"][0]},
                         {"MultiPeriodDiscriminator": opts["MultiPeriodDiscriminator"][1]})
    got = step(torch.from_numpy(wav), torch.from_numpy(mel))
    assert got.keys() == want[True].keys()
    for k in want[True]:
        assert_bf16_close(got[k], want[True][k], want[False][k], k)
    _dtypes_after(list(gen.parameters()), opts["Generator"][0])
    _dtypes_after(list(mpd.parameters()), opts["MultiPeriodDiscriminator"][0])

"""The port's NSF voice against the JAX package, at TINY widths on the CPU: the
harmonic-plus-noise source, the NSF generator, the f0 denormalisation and uv
binarisation between the stages, NSF SAM-BERT inference and its training
gradients, the NSF items of both datasets, chunked NSF vocoding, and
``text_to_wav`` on NSF checkpoints.

The source's random draws cannot match across frameworks, so they are
injected: a spy records what ``jax.random.uniform`` and ``jax.random.normal``
return inside the JAX source (it changes nothing the JAX code computes), and
the port's source takes those arrays as ``phase`` and ``noise``; the
generator takes one excitation in both packages (``excitation=``).
Tolerances: the source and the generator atol 1e-5 (the f32 phase cumsum
runs over at most 64 x 16 samples here); the denormalisation, binarisation
and dataset items exactly; NSF SAM-BERT inference 2e-4 and its gradients as
``tests/test_torch_port_train.py`` holds them (total loss rtol 1e-5, each
gradient leaf max|diff| <= 1e-4 * max|g|); chunked against plain 1e-5.
"""

import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from kantts_tpu import losses as jl
from kantts_tpu.bin.infer_hifigan import binarize as j_binarize
from kantts_tpu.bin.infer_sambert import denorm_f0 as j_denorm_f0
from kantts_tpu.data import dataset as jdata
from kantts_tpu.models.hifigan.generator import Generator as JGenerator
from kantts_tpu.models.hifigan.layers import SourceModule as JSourceModule
from kantts_tpu.models.sambert.sambert import KanTtsSAMBERT as JSAMBERT
from kantts_tpu.models.sambert.sambert import sambert_infer as j_sambert_infer
from kantts_tpu.utils import config as jconfig
from kantts_tpu.utils.torch_convert import convert_sambert
from kantts_tpu_torch.bin import infer_hifigan
from kantts_tpu_torch.bin.infer_hifigan import binarize
from kantts_tpu_torch.bin.infer_sambert import (
    denorm_f0,
    encode_symbol_inputs,
    nsf_denormaliser,
)
from kantts_tpu_torch.configs import get_config
from kantts_tpu_torch.data import dataset as tdata
from kantts_tpu_torch.infer.chunked import chunked_apply
from kantts_tpu_torch.losses import criterion_builder
from kantts_tpu_torch.models.builder import (
    build_sambert,
    hifigan_model_builder,
    sambert_params,
    save_checkpoint,
)
from kantts_tpu_torch.models.hifigan.layers import SourceModule
from kantts_tpu_torch.models.sambert.sambert import KanTtsSAMBERT, sambert_infer
from kantts_tpu_torch.text.ling_unit import KanTtsLinguisticUnit
from kantts_tpu_torch.train.steps import sambert_losses
from kantts_tpu_torch.utils.convert import hifigan_state_dict_from_jax, sambert_state_dict_from_jax
from kantts_tpu_torch.utils.corpus import write_am_corpus, write_voc_corpus
from test_sambert import TINY
from test_torch_port_hifigan import small_generator_cfg
from test_torch_port_slice import ROOT, TEXTS, _symbols
from test_torch_port_stream import _capture_wavs
from test_torch_port_train import (
    MAS_LOSSES,
    EPOCH,
    _flat,
    _jax_total,
    _train_batch,
    _zero_dropout,
)

ATOL = 1e-5
NSF = {"nb_harmonics": 7, "sampling_rate": 16000}
CONFIGS = os.path.join(ROOT, "kantts_tpu", "configs")
HOP = 16  # prod(small_generator_cfg()["upsample_scales"])


def nsf_generator_cfg(causal: bool = True, in_channels: int = 80) -> dict:
    return dict(small_generator_cfg(causal), in_channels=in_channels, nsf_params=NSF)


def nsf_mel(rng, b: int, frames: int, n_mels: int = 80) -> np.ndarray:
    """(b, frames, n_mels + 2): a random mel, f0 of 80-300 Hz, uv 0/1."""
    mel = rng.randn(b, frames, n_mels + 2).astype(np.float32)
    mel[..., -2] = rng.uniform(80.0, 300.0, (b, frames))
    mel[..., -1] = (rng.rand(b, frames) > 0.3).astype(np.float32)
    return mel


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def spied_draws(monkeypatch):
    """Record what jax.random.uniform and jax.random.normal return, where the
    value is concrete (an init that traces draws nothing it keeps)."""
    draws = {}
    for name in ("uniform", "normal"):
        real = getattr(jax.random, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            out = _real(*args, **kwargs)
            if not isinstance(out, jax.core.Tracer):
                draws[_name] = np.asarray(out)
            return out

        monkeypatch.setattr(jax.random, name, spy)
    return draws


# ------------------------------------------------------------------ source


def test_source_module_matches_jax_with_spied_draws(spied_draws):
    rng = np.random.RandomState(0)
    B, T = 2, 64
    pitch = rng.uniform(80.0, 400.0, (B, T, 1)).astype(np.float32)
    uv = (rng.rand(B, T, 1) > 0.3).astype(np.float32)
    j_src = JSourceModule(nb_harmonics=7, upsample_ratio=HOP, sampling_rate=16000)
    variables = j_src.init({"params": jax.random.PRNGKey(0),
                            "noise": jax.random.PRNGKey(1)},
                           jnp.asarray(pitch), jnp.asarray(uv))
    spied_draws.clear()
    want = np.asarray(j_src.apply(variables, jnp.asarray(pitch), jnp.asarray(uv),
                                  rngs={"noise": jax.random.PRNGKey(2)}))
    phase, noise = spied_draws["uniform"], spied_draws["normal"]
    assert phase.shape == (B, 1, 8) and noise.shape == (B, T * HOP, 8)

    src = SourceModule(7, HOP, 16000)
    ffn = _np(variables["params"]["ffn"])
    src.load_state_dict({"ffn.0.weight_v": torch.from_numpy(ffn["kernel_v"].transpose(2, 1, 0)),
                         "ffn.0.weight_g": torch.from_numpy(ffn["kernel_g"].reshape(1, 1, 1)),
                         "ffn.0.bias": torch.from_numpy(ffn["bias"])}, strict=True)
    args = (torch.from_numpy(pitch), torch.from_numpy(uv))
    with torch.no_grad():
        got = src(*args, phase=torch.from_numpy(phase), noise=torch.from_numpy(noise))
        assert got.shape == (B, T * HOP, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        # drawing: from the generator passed, and only from one
        a = src(*args, generator=torch.Generator().manual_seed(3))
        b = src(*args, generator=torch.Generator().manual_seed(3))
        assert torch.equal(a, b) and not torch.equal(a, got)
        with pytest.raises(ValueError, match="torch.Generator"):
            src(*args)


# --------------------------------------------------------------- generator


def _jax_nsf_generator(cfg, mel, seed=0):
    gen = JGenerator(**cfg)
    variables = gen.init({"params": jax.random.PRNGKey(seed),
                          "noise": jax.random.PRNGKey(seed + 1)}, jnp.asarray(mel))
    return gen, variables


def port_generator(cfg, variables):
    """The port's generator on the JAX weights (seeded weights without)."""
    config = {"model_type": "hifigan", "Model": {"Generator": {"params": cfg}}}
    port = hifigan_model_builder(config)
    if variables is not None:
        port.load_state_dict(hifigan_state_dict_from_jax(_np(variables["params"]), cfg),
                             strict=True)
    return port.eval()


@pytest.mark.parametrize("causal", [True, False])
def test_nsf_generator_matches_jax(causal, spied_draws):
    """One excitation drawn by the JAX generator (``excitation_only``), fed
    to both; then the port's source on the JAX draws equals that
    excitation, so the generator slices f0 and uv as the JAX one does."""
    cfg = nsf_generator_cfg(causal)
    mel = nsf_mel(np.random.RandomState(1), 2, 21)
    gen, variables = _jax_nsf_generator(cfg, mel)
    spied_draws.clear()
    exc = gen.apply(variables, jnp.asarray(mel), excitation_only=True,
                    rngs={"noise": jax.random.PRNGKey(5)})
    want = np.asarray(gen.apply(variables, jnp.asarray(mel), excitation=exc))

    port = port_generator(cfg, variables)
    t_mel = torch.from_numpy(mel)
    with torch.no_grad():
        got = port(t_mel, excitation=torch.from_numpy(np.asarray(exc)))
        assert got.shape == (2, 21 * HOP, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        src = port.source_module(t_mel[..., -2:-1], t_mel[..., -1:],
                                 phase=torch.from_numpy(spied_draws["uniform"]),
                                 noise=torch.from_numpy(spied_draws["normal"]))
        np.testing.assert_allclose(src.numpy(), np.asarray(exc), atol=ATOL, rtol=0)
        # excitation_only is the source itself, and the forward draws it so
        g = torch.Generator().manual_seed(0)
        e = port(t_mel, excitation_only=True, generator=g)
        assert e.shape == (2, 21 * HOP, 1)
        np.testing.assert_array_equal(
            port(t_mel, generator=torch.Generator().manual_seed(0)).numpy(),
            port(t_mel, excitation=e).numpy())
    plain = port_generator(small_generator_cfg(causal), None)
    with pytest.raises(ValueError, match="NSF-only"):
        plain(t_mel[..., :80], excitation=e)


@pytest.mark.parametrize("T,n_chunks", [(37, 4), (100, 8)])
def test_chunked_nsf_matches_plain(T, n_chunks):
    """The source is drawn once on the whole utterance and windowed, so the
    chunked output equals the plain forward on the same draws."""
    cfg = nsf_generator_cfg(True, in_channels=20)
    config = {"model_type": "hifigan", "Model": {"Generator": {"params": cfg}}}
    port = hifigan_model_builder(config, seed=2)
    mel = torch.from_numpy(nsf_mel(np.random.RandomState(7), 1, T, n_mels=20))
    with torch.no_grad():
        full = port(mel, generator=torch.Generator().manual_seed(1))
        chunked = chunked_apply(port, mel, n_chunks, rng=torch.Generator().manual_seed(1))
    assert chunked.shape == full.shape == (1, T * HOP, 1)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), atol=ATOL, rtol=1e-5)


# ------------------------------------------------- between the two stages


@pytest.mark.parametrize("norm_type", ["mean_std", "global"])
def test_denorm_f0_and_binarize_match_jax(norm_type):
    rng = np.random.RandomState(2)
    mel = rng.randn(40, 82).astype(np.float32)
    mel[:, -1] = rng.rand(40)
    feature = (np.array([[170.0], [35.0]]) if norm_type == "mean_std"
               else [730.0, 30.0])
    want = j_denorm_f0(mel.copy(), norm_type=norm_type, f0_feature=feature)
    got = denorm_f0(mel.copy(), norm_type=norm_type, f0_feature=feature)
    np.testing.assert_array_equal(got, want)
    assert (got[:, -2] >= 30).all() and set(np.unique(got[:, -1])) == {0.0, 1.0}
    np.testing.assert_array_equal(binarize(mel), j_binarize(mel))
    np.testing.assert_array_equal(binarize(mel)[:, :-1], mel[:, :-1])


def test_nsf_denormaliser_reads_its_statistics(tmp_path):
    """``mean_std`` from mvn.npy two directories above the checkpoint,
    ``global`` from the config; a non-NSF model has none."""
    ckpt = tmp_path / "stage" / "ckpt" / "am.pt"
    ckpt.parent.mkdir(parents=True)
    mvn = np.array([[160.0], [30.0]], np.float32)
    np.save(tmp_path / "stage" / "mvn.npy", mvn)
    mel = np.random.RandomState(3).rand(12, 82).astype(np.float32)
    denorm = nsf_denormaliser({"NSF": True}, str(ckpt))
    np.testing.assert_array_equal(denorm(mel), j_denorm_f0(mel.copy(), f0_feature=mvn))
    glob_ = nsf_denormaliser({"NSF": True, "nsf_norm_type": "global",
                              "nsf_f0_global_maximum": 500.0}, str(ckpt))
    np.testing.assert_array_equal(glob_(mel), j_denorm_f0(
        mel.copy(), norm_type="global", f0_feature=[500.0, 30.0]))
    assert nsf_denormaliser({"NSF": False}, str(ckpt)) is None


# ------------------------------------------------------- NSF SAM-BERT


@pytest.fixture(scope="module")
def nsf_models(tmp_path_factory):
    """TINY NSF SAM-BERT (82 mel channels, durations) and a small NSF
    vocoder, saved as the port's checkpoints, with mvn.npy beside the
    acoustic model's stage directory; the JAX counterparts on the same
    weights."""
    am_cfg = get_config("sambert_16k_MAS")
    am_cfg["Model"]["KanTtsSAMBERT"]["params"] = dict(
        TINY, num_mels=82, MAS=False, NSF=True, dur_pred_bias_init=2.2)
    voc_cfg = get_config("hifigan_v1_16k")
    voc_cfg["Model"]["Generator"]["params"] = nsf_generator_cfg()
    am, voc = build_sambert(am_cfg, seed=0), hifigan_model_builder(voc_cfg, seed=1)
    root = tmp_path_factory.mktemp("nsf")
    (root / "am" / "ckpt").mkdir(parents=True)
    np.save(root / "am" / "mvn.npy", np.array([[170.0], [40.0]], np.float32))
    am_ckpt, voc_ckpt = root / "am" / "ckpt" / "am.pt", root / "voc.pt"
    save_checkpoint(str(am_ckpt), am, am_cfg)
    save_checkpoint(str(voc_ckpt), voc, voc_cfg)
    params = sambert_params(am_cfg)
    return {"root": root, "am": am, "params": params, "am_ckpt": str(am_ckpt),
            "voc_ckpt": str(voc_ckpt), "ling_unit": KanTtsLinguisticUnit(am_cfg),
            "j_am": JSAMBERT(params), "j_am_vars": {"params": convert_sambert(
                {k: v.numpy() for k, v in am.state_dict().items()}, params)}}


def test_nsf_sambert_infer_matches_jax(nsf_models):
    """82 output channels; the port fed the JAX durations, as in
    ``tests/test_torch_port_slice.py``."""
    m, L_in = nsf_models, 32
    parts = [encode_symbol_inputs(m["ling_unit"], s, L_in) for s in _symbols()]
    ling, emo, spk, lengths = (np.concatenate([p[i] for p in parts]) for i in range(4))
    want = jax.jit(lambda v, *a: j_sambert_infer(m["j_am"], v, *a, L_in * 24))(
        m["j_am_vars"], *(jnp.asarray(a) for a in (ling, emo, spk, lengths)))
    want = {k: np.array(v) for k, v in want.items()}
    args = [torch.from_numpy(a).long() for a in (ling, emo, spk)] + [
        torch.from_numpy(lengths)]
    got = sambert_infer(m["am"], *args, L_in * 24, duration_override=torch.from_numpy(
        want["duration_predictions"]))
    np.testing.assert_array_equal(got["LR_length_rounded"].numpy(),
                                  want["LR_length_rounded"])
    assert got["postnet_outputs"].shape[-1] == 82
    for key in ("dec_outputs", "postnet_outputs"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=2e-4, rtol=0)


def test_nsf_sambert_gradients_match_jax():
    """The training forward and criteria of an 82-channel NSF model with
    token durations, as ``test_gradients_match_jax`` holds the others."""
    cfg = dict(TINY, MAS=False, NSF=True, num_mels=12)
    batch = _train_batch(cfg, False)
    j_model = JSAMBERT(cfg)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda b: j_model.init(
        {"params": jax.random.PRNGKey(0)}, b["input_lings"], b["input_emotions"],
        b["input_speakers"], b["valid_input_lengths"], b["valid_output_lengths"],
        b["mel_targets"], duration_targets=b["durations"],
        pitch_targets=b["pitch_contours"], energy_targets=b["energy_contours"],
        deterministic=True))(j_batch)
    params = _np(variables["params"])
    loss_cfg = {"Loss": {k: v for k, v in MAS_LOSSES.items()
                         if not k.startswith("Attention")}}
    j_loss, j_grads = _jax_total(j_model, jl.criterion_builder(loss_cfg), False,
                                 None)(params, j_batch)
    port = KanTtsSAMBERT(cfg)
    port.load_state_dict(sambert_state_dict_from_jax(params, cfg), strict=True)
    _zero_dropout(port)
    t_loss, _ = sambert_losses(port, criterion_builder(loss_cfg),
                               {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
                               EPOCH, False)
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in port.named_parameters()}
    mapped = dict(_flat(convert_sambert(grads, cfg)))
    want = dict(_flat(_np(j_grads)))
    assert mapped.keys() == want.keys()
    for key, g in want.items():
        assert np.abs(mapped[key] - g).max() <= 1e-4 * np.abs(g).max(), key


# ----------------------------------------------------------------- datasets


def test_nsf_voc_items_match_jax(tmp_path):
    """A 24 kHz NSF tone corpus written twice from one seed; both packages'
    items (mel, then f0 in Hz and uv) are equal, and the f0 is the tone's."""
    model_yaml = os.path.join(CONFIGS, "hifigan_v1_nsf_24k.yaml")
    items = []
    for mod, name in ((tdata, "port"), (jdata, "jax")):
        root = str(tmp_path / name)
        write_voc_corpus(root, 5, (0.4, 0.6), seed=2, sampling_rate=24000, nsf=True)
        config = dict(jconfig.load_merged_config(root, model_yaml), batch_max_steps=2400)
        train, valid = mod.get_voc_datasets(config, [root])
        items.append([ds[i] for ds in (train, valid) for i in range(len(ds))])
    assert len(items[0]) == len(items[1]) == 5
    for (w_t, m_t), (w_j, m_j) in zip(*items):
        np.testing.assert_array_equal(w_t, w_j)
        np.testing.assert_array_equal(m_t, m_j)
        f0, uv = m_t[:, -2], m_t[:, -1]
        assert m_t.shape[1] == 82 and set(np.unique(uv)) == {0.0, 1.0}
        assert 90 * 0.85 - 1e-3 <= f0.min() and f0.max() <= 260 * 1.15 + 1e-3


@pytest.mark.parametrize("norm_type", ["mean_std", "global"])
def test_nsf_am_items_match_jax(norm_type, tmp_path):
    """An NSF duration corpus written twice from one seed: every item and
    the collated batch of both packages are equal."""
    model_yaml = os.path.join(CONFIGS, "sambert_nsf_24k.yaml")
    batches = []
    for mod, name in ((tdata, "port"), (jdata, "jax")):
        root = str(tmp_path / name)
        write_am_corpus(root, 8, (5, 8), (20, 30), seed=3, durations=True, nsf=True,
                        sampling_rate=24000)
        config = jconfig.load_merged_config(root, model_yaml)
        config["Model"]["KanTtsSAMBERT"]["params"]["nsf_norm_type"] = norm_type
        train, _ = mod.get_am_datasets([os.path.join(root, "raw_metafile.txt")],
                                       [root], config, input_bucket=8, frame_bucket=12)
        assert train.with_duration
        batches.append(train.collate_fn([train[i] for i in range(len(train))]))
    got, want = batches
    assert got.keys() == want.keys()
    assert got["mel_targets"].shape[-1] == 82
    for k in want:
        if want[k] is None:
            assert got[k] is None
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ----------------------------------------------------------------- the CLIs


def test_infer_hifigan_nsf_chunked_equals_plain(nsf_models, tmp_path, monkeypatch):
    """``infer_hifigan`` on NSF mels: uv binarised, and ``--chunked 3``
    gives the plain path's waveforms (both draw from the key 0)."""
    mel_dir = tmp_path / "mels"
    mel_dir.mkdir()
    rng = np.random.RandomState(8)
    lengths = {"a": 45, "b": 130}
    for name, T in lengths.items():
        mel = nsf_mel(rng, 1, T)[0]
        mel[:, -1] = rng.rand(T)  # an acoustic model's uv, not yet binary
        np.save(mel_dir / f"{name}.npy", mel)
    runs = {}
    for name, chunked in (("plain", 0), ("chunked", 3)):
        runs[name] = _capture_wavs(monkeypatch, infer_hifigan)
        infer_hifigan.hifigan_infer(str(mel_dir), nsf_models["voc_ckpt"],
                                    str(tmp_path / name), device="cpu", chunked=chunked)
    for utt, T in lengths.items():
        assert runs["plain"][utt].shape == (T * HOP,)
        np.testing.assert_allclose(runs["chunked"][utt], runs["plain"][utt],
                                   atol=ATOL, rtol=0, err_msg=utt)


def test_text_to_wav_nsf_cli(nsf_models, tmp_path):
    """The whole CLI on the NSF pair, on the CPU: one wav per text line at
    the vocoder's rate, finite and in [-1, 1]; the mels handed to the
    vocoder carry f0 >= 30 Hz and a binary uv."""
    txt = tmp_path / "in.txt"
    txt.write_text("\n".join(TEXTS) + "\n", encoding="utf-8")
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "kantts_tpu_torch.bin.text_to_wav", "--txt", str(txt),
         "--am_ckpt", nsf_models["am_ckpt"], "--voc_ckpt", nsf_models["voc_ckpt"],
         "--output_dir", str(out), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        # one thread: beside busy test workers, a process whose OpenMP
        # threads outnumber the free cores waits on its own barriers
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    wavs = sorted(glob.glob(str(out / "res_wavs" / "*.wav")))
    assert len(wavs) == len(TEXTS)
    for path in wavs:
        sr, data = wavfile.read(path)
        assert sr == 16000 and data.size > 0 and np.isfinite(data).all()
    mels = sorted(glob.glob(str(out / "feat" / "*_mel.npy")))
    assert mels
    for path in mels:
        mel = np.load(path)
        assert mel.shape[1] == 82 and (mel[:, -2] >= 30).all()
        assert set(np.unique(mel[:, -1])) <= {0.0, 1.0}
    for path in glob.glob(str(out / "wav_chunks" / "*.wav")):
        utt = os.path.basename(path)[:-len(".wav")]
        frames = np.load(out / "feat" / f"{utt}.npy").shape[0]
        assert wavfile.read(path)[1].shape[0] == frames * HOP

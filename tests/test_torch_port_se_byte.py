"""The byte-input and speaker-embedding (SE) SAM-BERT voices of the PyTorch
port against the JAX package, on the CPU at TINY widths, in float32: the
teacher-forced forward (MAS on for the byte voice), ``sambert_infer``, the
loss and gradients of one train step, the dataset's batches, and
``text_to_wav --se_file`` end to end.

The same weights (moved by the weight bridge) and numpy inputs go through
both packages. Tolerances are those of ``tests/test_torch_port_sambert.py``
and ``tests/test_torch_port_train.py``: outputs atol 1e-5, the loss rtol
1e-5, each gradient leaf max|diff| <= 1e-4 * max|g|; batches exactly.
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

from kantts_tpu import data as jdata
from kantts_tpu import losses as jl
from kantts_tpu.models.sambert.sambert import KanTtsSAMBERT as JSAMBERT
from kantts_tpu.models.sambert.sambert import sambert_infer as j_sambert_infer
from kantts_tpu.utils import config as jconfig
from kantts_tpu.utils.torch_convert import convert_sambert
from kantts_tpu_torch.bin.infer_sambert import encode_symbol_inputs
from kantts_tpu_torch.data import dataset as tdata
from kantts_tpu_torch.losses import criterion_builder
from kantts_tpu_torch.models.builder import (
    build_sambert,
    hifigan_model_builder,
    sambert_params,
    save_checkpoint,
)
from kantts_tpu_torch.models.sambert.sambert import sambert_infer
from kantts_tpu_torch.text.ling_unit import KanTtsLinguisticUnit
from kantts_tpu_torch.train.optim import optimizer_builder
from kantts_tpu_torch.train.steps import make_sambert_step
from kantts_tpu_torch.utils.config import load_yaml
from kantts_tpu_torch.utils.corpus import write_am_corpus
from test_sambert import TINY
from test_torch_port_nsf import nsf_generator_cfg
from test_torch_port_train import MAS_LOSSES, EPOCH, _flat, _jax_total, _zero_dropout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "kantts_tpu_torch", "resources", "configs")
ATOL = 1e-5
SE_UNITS = 8  # TINY's speaker_units
VOICES = {  # name: (config file, TINY overrides)
    "byte": ("sambert_16k_MAS_byte", dict(num_mels=80, MAS=True, using_byte=True)),
    "se": ("sambert_se_nsf_global_16k", dict(num_mels=82, MAS=False, NSF=True,
                                              nsf_norm_type="global", SE=True)),
}


def _config(voice):
    """The voice's published config with TINY widths and a duration head
    that decodes about 8 frames a phone."""
    name, overrides = VOICES[voice]
    cfg = load_yaml(os.path.join(CONFIGS, f"{name}.yaml"))
    cfg["Model"]["KanTtsSAMBERT"]["params"] = dict(
        TINY, **overrides, dur_pred_bias_init=2.2)
    return cfg


@pytest.fixture(scope="module")
def voices():
    """-> {voice: (config, params, port model, JAX model, JAX params)}."""
    out = {}
    for voice in VOICES:
        cfg = _config(voice)
        params = sambert_params(cfg)
        port = build_sambert(cfg, seed=0)
        j_params = convert_sambert({k: v.numpy() for k, v in
                                    port.state_dict().items()}, params)
        out[voice] = (cfg, params, port, JSAMBERT(params), j_params)
    return out


def test_voices_take_their_inputs(voices):
    """A byte voice has the byte embedding only (256 bytes + 3 specials); an
    SE voice has no speaker table."""
    byte_port, se_port = voices["byte"][2], voices["se"][2]
    names = {k.split(".")[1] for k in byte_port.state_dict()
             if k.startswith("text_encoder.") and k.endswith("_emb.weight")}
    assert names == {"byte_index_emb"}
    assert byte_port.text_encoder.byte_index_emb.num_embeddings == 259
    assert not any(k.startswith("spk_tokenizer") for k in se_port.state_dict())
    assert "spk_tokenizer.weight" in byte_port.state_dict()


def _batch(voice, params, seed=4):
    """A numpy batch with the dataset's keys, as in
    ``test_torch_port_train._train_batch``: one byte track for the byte voice
    (MAS: frame-level prosody and a prior), and for the SE voice durations
    and a (B, T_in, speaker_units) embedding, zero on the padding."""
    rng = np.random.RandomState(seed)
    B, T_in, T_mel = 3, 12, 36
    in_lens, out_lens = np.array([12, 9, 7]), np.array([36, 30, 20])
    if voice == "byte":
        ling = rng.randint(0, params["byte_index"], (B, T_in, 1))
        spk = rng.randint(0, params["speaker"], (B, T_in))
    else:
        ling = np.stack([rng.randint(0, params[k], (B, T_in)) for k in
                         ("sy", "tone", "syllable_flag", "word_segment")], -1)
        se = rng.randn(SE_UNITS).astype(np.float32)
        spk = np.where((np.arange(T_in)[None] <= in_lens[:, None])[..., None],
                       se, 0.0).astype(np.float32)
    batch = dict(input_lings=ling, input_emotions=rng.randint(0, params["emotion"],
                                                              (B, T_in)),
                 input_speakers=spk, valid_input_lengths=in_lens,
                 valid_output_lengths=out_lens,
                 mel_targets=rng.randn(B, T_mel, params["num_mels"]).astype(np.float32))
    mas = params["MAS"]
    n_feat = T_mel if mas else T_in
    batch["pitch_contours"] = np.abs(rng.randn(B, n_feat)).astype(np.float32)
    batch["energy_contours"] = np.abs(rng.randn(B, n_feat)).astype(np.float32)
    if mas:
        prior = np.abs(rng.randn(B, T_mel, T_in)).astype(np.float32) + 0.1
        batch["attn_priors"] = prior / prior.sum(-1, keepdims=True)
    else:
        durs = np.zeros((B, T_in), np.float32)
        for b in range(B):
            n, m = in_lens[b], out_lens[b]
            durs[b, :n] = 1 + rng.multinomial(m - n, np.full(n, 1.0 / n))
            if n < T_in:
                durs[b, n] = T_mel - m
        batch["durations"] = durs
    return batch


@pytest.mark.parametrize("voice", list(VOICES))
def test_forward_matches_jax(voices, voice):
    """The teacher-forced forward; for the byte voice the MAS alignment too
    (its keys are the byte embeddings times sqrt(d_model), the reference's
    aliasing, as for the phone voices)."""
    _, params, port, jm, j_params = voices[voice]
    b = _batch(voice, params)
    want = jax.jit(lambda p, b: jm.apply(
        {"params": p}, b["input_lings"], b["input_emotions"], b["input_speakers"],
        b["valid_input_lengths"], b["valid_output_lengths"], b["mel_targets"],
        duration_targets=b.get("durations"), pitch_targets=b["pitch_contours"],
        energy_targets=b["energy_contours"], attn_priors=b.get("attn_priors"),
        deterministic=True))(j_params, {k: jnp.asarray(v) for k, v in b.items()})
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        got = port(t["input_lings"], t["input_emotions"], t["input_speakers"],
                   t["valid_input_lengths"], t["valid_output_lengths"],
                   t["mel_targets"], duration_targets=t.get("durations"),
                   pitch_targets=t["pitch_contours"],
                   energy_targets=t["energy_contours"],
                   attn_priors=t.get("attn_priors"))
    keys = ["dec_outputs", "postnet_outputs", "pitch_predictions",
            "energy_predictions", "log_duration_predictions", "LR_spk_outputs"]
    if voice == "byte":
        keys += ["attn_soft", "attn_hard", "duration_targets"]
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL,
                                   rtol=0, err_msg=k)


SYMBOLS = {  # two utterances per voice
    "byte": ["{104$emotion_neutral$F7} {105$emotion_neutral$F7} "
             "{228$emotion_neutral$F7} {189$emotion_neutral$F7} "
             "{160$emotion_neutral$F7} {46$emotion_neutral$F7}",
             "{110$emotion_neutral$F7} {105$emotion_neutral$F7} "
             "{46$emotion_neutral$F7}"],
    "se": ["{n_c$tone3$s_begin$word_begin$emotion_neutral$F7} "
           "{i_c$tone3$s_end$word_end$emotion_neutral$F7} "
           "{h_c$tone3$s_begin$word_begin$emotion_neutral$F7} "
           "{ao_c$tone3$s_end$word_end$emotion_neutral$F7}",
           "{sh_c$tone4$s_begin$word_begin$emotion_neutral$F7} "
           "{i_c$tone4$s_end$word_end$emotion_neutral$F7}"],
}


@pytest.mark.parametrize("voice", list(VOICES))
def test_sambert_infer_matches_jax(voices, voice):
    """A byte sequence, and phones with an SE vector repeated over the input
    budget (as ``encode_symbol_inputs`` makes it); the port is fed the JAX
    durations, as in ``tests/test_torch_port_slice.py``."""
    cfg, params, port, jm, j_params = voices[voice]
    lu = KanTtsLinguisticUnit(cfg)
    L_in, budget = 16, 16 * 12
    se = np.random.RandomState(7).randn(SE_UNITS).astype(np.float32) \
        if voice == "se" else None
    parts = [encode_symbol_inputs(lu, s, L_in, 1 if voice == "byte" else 4, se)
             for s in SYMBOLS[voice]]
    ling, emo, spk, lengths = (np.concatenate([p[i] for p in parts]) for i in range(4))
    assert ling.shape[-1] == (1 if voice == "byte" else 4)
    if se is not None:
        assert spk.shape == (2, L_in, SE_UNITS) and (spk == se).all()
    want = jax.jit(lambda p, *a: j_sambert_infer(jm, {"params": p}, *a, budget))(
        j_params, *(jnp.asarray(a) for a in (ling, emo, spk, lengths)))
    want = {k: np.array(v) for k, v in want.items()}
    assert want["LR_length_rounded"].min() > 0
    got = sambert_infer(port, torch.from_numpy(ling).long(),
                        torch.from_numpy(emo).long(),
                        torch.from_numpy(spk) if se is not None
                        else torch.from_numpy(spk).long(),
                        torch.from_numpy(lengths), budget,
                        duration_override=torch.from_numpy(
                            want["duration_predictions"]))
    np.testing.assert_array_equal(got["LR_length_rounded"].numpy(),
                                  want["LR_length_rounded"])
    for k in ("dec_outputs", "postnet_outputs", "log_duration_predictions",
              "pitch_predictions"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("voice", list(VOICES))
def test_train_step_matches_jax(voices, voice):
    """One ``make_sambert_step`` with dropout off: its total loss and the
    gradients it applies against the JAX loss and gradients on the same
    weights and batch; then the update moved the weights."""
    cfg, params, port, jm, j_params = voices[voice]
    mas = params["MAS"]
    b = _batch(voice, params)
    loss_cfg = {"Loss": {k: v for k, v in MAS_LOSSES.items()
                         if mas or not k.startswith("Attention")}}
    j_loss, j_grads = _jax_total(jm, jl.criterion_builder(loss_cfg), mas, None)(
        j_params, {k: jnp.asarray(v) for k, v in b.items()})
    model = build_sambert(cfg, seed=0)
    _zero_dropout(model)
    optimizer, scheduler, clip = optimizer_builder(
        model.parameters(), {"type": "SGD", "params": {"lr": 1e-3}}, None)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    grads = {}

    def keep_grads():
        grads.update({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                      .clone().numpy() for k, p in model.named_parameters()})

    step = make_sambert_step(model, criterion_builder(loss_cfg), optimizer,
                             scheduler, keep_grads, mas)
    metrics = step({k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}, EPOCH)
    np.testing.assert_allclose(float(metrics["TotalLoss"]), float(j_loss), rtol=1e-5)
    mapped = dict(_flat(convert_sambert(grads, params)))
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, j_grads)))
    assert mapped.keys() == want.keys()
    for key, g in want.items():
        diff = np.abs(mapped[key] - g).max()
        assert diff <= 1e-4 * np.abs(g).max(), f"{key}: max|diff| {diff}"
    moved = [k for k, v in model.state_dict().items() if not torch.equal(before[k], v)]
    assert moved


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if w[k] is None:
                assert g[k] is None, k
            else:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("voice", list(VOICES))
def test_dataset_batches_match_jax(voice, tmp_path):
    """Two copies of one corpus (a byte MAS corpus; an SE corpus with
    durations, NSF features and ``se/se.npy``), the port's loader on one and
    the JAX package's on the other: the same split and every batch."""
    name = VOICES[voice][0]
    roots = [str(tmp_path / "port"), str(tmp_path / "jax")]
    for root in roots:
        write_am_corpus(root, 10, (5, 9), (20, 40), seed=4, byte=voice == "byte",
                        durations=voice == "se", nsf=voice == "se",
                        se_units=192 if voice == "se" else 0)
    loaders = []
    for mod, root in zip((tdata, jdata), roots):
        config = dict(jconfig.load_merged_config(
            root, os.path.join(ROOT, "kantts_tpu", "configs", f"{name}.yaml")),
            batch_size=3)
        train, valid = mod.get_am_datasets(
            [os.path.join(root, "raw_metafile.txt")], [root], config,
            se_enable=voice == "se", input_bucket=16, frame_bucket=12)
        loaders.append(mod.DataLoader(train, 3, sampler=mod.DistributedSampler(
            len(train), shuffle=True)))
    with open(os.path.join(roots[0], "am_train.lst")) as f, \
            open(os.path.join(roots[1], "am_train.lst")) as g:
        assert f.read() == g.read()
    got, want = list(loaders[0]), list(loaders[1])
    _assert_batches_equal(got, want)
    if voice == "se":
        spk = got[0]["input_speakers"]
        assert spk.shape[-1] == 192 and spk.dtype == np.float32
    else:
        assert got[0]["input_lings"].shape[-1] == 1


def test_text_to_wav_se_cli(tmp_path):
    """``text_to_wav --device cpu --se_file`` on a TINY SE + NSF (global
    norm) voice and a small NSF vocoder: one finite wav per text line; the
    same symbols with another speaker embedding give another waveform."""
    am_cfg = _config("se")
    voc_cfg = load_yaml(os.path.join(CONFIGS, "hifigan_noncausal_nsf_global_v1_16k.yaml"))
    voc_cfg["Model"]["Generator"]["params"] = nsf_generator_cfg()
    voc_cfg["audio_config"] = {"sampling_rate": 16000}
    am_ckpt, voc_ckpt = str(tmp_path / "am.pt"), str(tmp_path / "voc.pt")
    save_checkpoint(am_ckpt, build_sambert(am_cfg, seed=0), am_cfg)
    save_checkpoint(voc_ckpt, hifigan_model_builder(voc_cfg, seed=1), voc_cfg)
    symbols = tmp_path / "symbols.lst"
    symbols.write_text("".join(f"u{i}\t{s}\n" for i, s in enumerate(SYMBOLS["se"])),
                       encoding="utf-8")
    wavs = {}
    for seed in (0, 1):
        se = tmp_path / f"se{seed}.npy"
        np.save(se, np.random.RandomState(seed).randn(SE_UNITS).astype(np.float32))
        out = tmp_path / f"out{seed}"
        proc = subprocess.run(
            [sys.executable, "-m", "kantts_tpu_torch.bin.text_to_wav",
             "--symbols_file", str(symbols), "--am_ckpt", am_ckpt,
             "--voc_ckpt", voc_ckpt, "--se_file", str(se), "--output_dir", str(out),
             "--device", "cpu"],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        assert proc.returncode == 0, proc.stderr[-3000:]
        paths = sorted(glob.glob(str(out / "res_wavs" / "*.wav")))
        assert len(paths) == 2
        wavs[seed] = [wavfile.read(p)[1] for p in paths]
        assert all(w.size > 0 and np.isfinite(w).all() for w in wavs[seed])
    assert any(a.shape != b.shape or not np.array_equal(a, b)
               for a, b in zip(wavs[0], wavs[1]))

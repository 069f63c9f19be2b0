"""The port's slice end to end against the JAX package, at TINY widths on the
CPU: acoustic inference, the teacher-forced MAS forward, and text -> wav.
Weights are made once by the port's builder and handed to JAX through the
JAX package's converter.

Tolerances: durations 1e-4 (log-domain outputs of an autoregressive LSTM
loop, exponentiated); mels and wavs 2e-4 (the 12-step-deep float32 decode
and postnet reassociate sums differently); hard alignments and MAS
durations exactly. Acoustic inference feeds the port the JAX durations, so
that a rounding flip at floor(d + 0.5) cannot fork the comparison.
"""

import glob
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from kantts_tpu.bin.infer_sambert import am_synthesis_batch as j_am_synthesis_batch
from kantts_tpu.models.hifigan.generator import Generator as JGenerator
from kantts_tpu.models.sambert.sambert import KanTtsSAMBERT as JSAMBERT
from kantts_tpu.models.sambert.sambert import sambert_infer as j_sambert_infer
from kantts_tpu.text import pinyin_frontend
from kantts_tpu.text.ling_unit import KanTtsLinguisticUnit
from kantts_tpu.utils.torch_convert import convert_hifigan_generator, convert_sambert
from kantts_tpu_torch.bin.infer_sambert import encode_symbol_inputs
from kantts_tpu_torch.bin.text_to_wav import text_to_wav
from kantts_tpu_torch.configs import get_config
from kantts_tpu_torch.models.builder import (
    build_sambert,
    hifigan_model_builder,
    sambert_params,
    save_checkpoint,
)
from kantts_tpu_torch.models.sambert.sambert import sambert_infer
from kantts_tpu_torch.utils.corpus import write_mas_corpus
from test_sambert import TINY
from test_torch_port_hifigan import small_generator_cfg
from test_torch_port_train import train_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["ni3 hao3 , shi4 jie4 .", "wo3 men5 qu4 bei3 jing1 kan4 kan4 ."]
L_IN = 32  # the acoustic model's input bucket
BUDGET = L_IN * 24  # frames: 24 per padded symbol, as the CLIs set it


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def slice_models(tmp_path_factory):
    am_cfg = get_config("sambert_16k_MAS")
    am_cfg["Model"]["KanTtsSAMBERT"]["params"] = dict(
        TINY, num_mels=80, MAS=True, dur_pred_bias_init=2.2)
    voc_cfg = get_config("hifigan_v1_16k")
    voc_cfg["Model"]["Generator"]["params"] = small_generator_cfg()
    am, voc = build_sambert(am_cfg, seed=0), hifigan_model_builder(voc_cfg, seed=1)
    params = sambert_params(am_cfg)
    ckpt_dir = tmp_path_factory.mktemp("ckpt")
    save_checkpoint(str(ckpt_dir / "am.pt"), am, am_cfg)
    save_checkpoint(str(ckpt_dir / "voc.pt"), voc, voc_cfg)
    return {
        "cfg": params, "am": am, "ckpt_dir": ckpt_dir,
        "ling_unit": KanTtsLinguisticUnit(am_cfg),
        "j_am": JSAMBERT(params),
        "j_am_vars": {"params": convert_sambert(_numpy(am.state_dict()), params)},
        "j_voc": JGenerator(**small_generator_cfg()),
        "j_voc_vars": {"params": convert_hifigan_generator(
            _numpy(voc.state_dict()), small_generator_cfg())},
    }


def _symbols():
    return [seq for seqs in pinyin_frontend.text_to_symbols(TEXTS) for seq in seqs]


def test_sambert_infer_matches_jax(slice_models):
    m = slice_models
    parts = [encode_symbol_inputs(m["ling_unit"], s, L_IN) for s in _symbols()]
    ling, emo, spk, lengths = (np.concatenate([p[i] for p in parts]) for i in range(4))
    want = jax.jit(lambda v, *a: j_sambert_infer(m["j_am"], v, *a, BUDGET))(
        m["j_am_vars"], *(jnp.asarray(a) for a in (ling, emo, spk, lengths)))
    want = {k: np.array(v) for k, v in want.items()}
    args = [torch.from_numpy(a).long() for a in (ling, emo, spk)] + [
        torch.from_numpy(lengths)]

    got = sambert_infer(m["am"], *args, BUDGET)
    np.testing.assert_allclose(got["duration_predictions"].numpy(),
                               want["duration_predictions"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["pitch_predictions"].numpy(),
                               want["pitch_predictions"], atol=1e-5, rtol=0)

    got = sambert_infer(m["am"], *args, BUDGET, duration_override=torch.from_numpy(
        want["duration_predictions"]))
    np.testing.assert_array_equal(got["LR_length_rounded"].numpy(),
                                  want["LR_length_rounded"])
    np.testing.assert_array_equal(got["x_band_width"].numpy(), want["x_band_width"])
    # the biased duration head gives utterances of several frames per phone
    assert (want["LR_length_rounded"] >= 4 * lengths).all()
    for key in ("dec_outputs", "postnet_outputs"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=2e-4, rtol=0)


def test_batch_composition_does_not_change_an_utterance(slice_models):
    """Per-item band widths: each utterance of a B=2 forward equals its own
    B=1 forward (which takes the scalar band-width branch)."""
    m = slice_models
    parts = [encode_symbol_inputs(m["ling_unit"], s, L_IN) for s in _symbols()]
    batched = sambert_infer(m["am"], *_torch_inputs(parts), BUDGET)
    for i, part in enumerate(parts):
        alone = sambert_infer(m["am"], *_torch_inputs([part]), BUDGET)
        n = int(alone["LR_length_rounded"][0])
        assert n == int(batched["LR_length_rounded"][i])
        np.testing.assert_allclose(batched["postnet_outputs"][i, :n].numpy(),
                                   alone["postnet_outputs"][0, :n].numpy(),
                                   atol=1e-5, rtol=0)


def _torch_inputs(parts):
    ling, emo, spk, lengths = (torch.from_numpy(np.concatenate([p[i] for p in parts]))
                               for i in range(4))
    return ling.long(), emo.long(), spk.long(), lengths


def test_mas_forward_matches_jax(slice_models):
    m, cfg = slice_models, slice_models["cfg"]
    rng = np.random.RandomState(0)
    B, T_in, T_mel = 3, 12, 36
    in_lens = np.array([12, 9, 7])
    out_lens = np.array([36, 30, 20])
    prior = np.abs(rng.randn(B, T_mel, T_in)).astype(np.float32) + 0.1
    prior /= prior.sum(axis=2, keepdims=True)
    ling = np.stack([rng.randint(0, cfg[k], (B, T_in)) for k in
                     ("sy", "tone", "syllable_flag", "word_segment")], -1)
    batch = [ling, rng.randint(0, cfg["emotion"], (B, T_in)),
             rng.randint(0, cfg["speaker"], (B, T_in)), in_lens, out_lens,
             rng.randn(B, T_mel, 80).astype(np.float32)]
    targets = dict(pitch_targets=np.abs(rng.randn(B, T_mel)).astype(np.float32),
                   energy_targets=np.abs(rng.randn(B, T_mel)).astype(np.float32),
                   attn_priors=prior)
    want = m["j_am"].apply(m["j_am_vars"], *(jnp.asarray(a) for a in batch),
                           **{k: jnp.asarray(v) for k, v in targets.items()},
                           deterministic=True)
    with torch.no_grad():
        got = m["am"](*(torch.from_numpy(a) for a in batch),
                      **{k: torch.from_numpy(v) for k, v in targets.items()})
    np.testing.assert_array_equal(got["attn_hard"].numpy(), np.asarray(want["attn_hard"]))
    np.testing.assert_array_equal(got["duration_targets"].numpy(),
                                  np.asarray(want["duration_targets"]))
    assert got["duration_targets"].sum(1).tolist() == [T_mel] * B
    for key in ("attn_soft", "pitch_targets", "log_duration_predictions"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5, rtol=0, err_msg=key)
    for key in ("dec_outputs", "postnet_outputs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=2e-4, rtol=0, err_msg=key)


def _write_texts(slice_models, out_dir):
    """-> (text file, [AM checkpoint, vocoder checkpoint])."""
    text = os.path.join(out_dir, "text.txt")
    os.makedirs(out_dir, exist_ok=True)
    with open(text, "w", encoding="utf-8") as f:
        f.write("\n".join(TEXTS) + "\n")
    d = slice_models["ckpt_dir"]
    return text, [str(d / "am.pt"), str(d / "voc.pt")]


def test_text_to_wav_matches_jax(slice_models, tmp_path):
    m = slice_models
    text, (am_ckpt, voc_ckpt) = _write_texts(m, str(tmp_path))
    stats = text_to_wav(str(tmp_path / "out"), am_ckpt, voc_ckpt, text, am_batch=2,
                        device=torch.device("cpu"))
    assert stats["audio_seconds"] > 0

    symbols = _symbols()
    mels = [r[1] for r in j_am_synthesis_batch(symbols, m["j_am"], m["j_am_vars"],
                                               m["ling_unit"], batch_pad_to=2)]
    for i, mel in enumerate(mels):
        want = np.asarray(m["j_voc"].apply(m["j_voc_vars"], jnp.asarray(mel[None])))
        sr, pcm = wavfile.read(str(tmp_path / "out" / "wav_chunks" / f"{i}_0_mel.wav"))
        got = pcm.astype(np.float32) / 32768.0
        assert sr == 16000 and got.shape == (mel.shape[0] * 16,)
        # PCM16 adds at most one step of 1/32768 on top of the model error
        np.testing.assert_allclose(got, want[0, :, 0], atol=2e-4, rtol=0)
    joined = sorted(os.listdir(tmp_path / "out" / "res_wavs"))
    assert joined == ["0.wav", "1.wav"]


def test_text_to_wav_runs_without_jax(slice_models, tmp_path):
    """The CLIs in a fresh process where importing jax, flax, optax or the
    JAX package fails: text_to_wav, then two train steps of train_sambert,
    both on the CPU because they are asked to be."""
    text, (am_ckpt, voc_ckpt) = _write_texts(slice_models, str(tmp_path))
    out = str(tmp_path / "out")
    data, stage = str(tmp_path / "data"), str(tmp_path / "stage")
    write_mas_corpus(data, 6, (4, 6), (15, 24), seed=2)
    train_cfg = train_config(stage, train_max_steps=2)
    code = (
        "import runpy, sys\n"
        "for name in ('jax', 'flax', 'optax', 'kantts_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"sys.argv = ['text_to_wav', '--txt', {text!r}, '--am_ckpt', {am_ckpt!r},"
        f" '--voc_ckpt', {voc_ckpt!r}, '--output_dir', {out!r}, '--device', 'cpu']\n"
        "runpy.run_module('kantts_tpu_torch.bin.text_to_wav', run_name='__main__')\n"
        "import kantts_tpu_torch.losses, kantts_tpu_torch.train.optim\n"
        "import kantts_tpu_torch.train.schedulers, kantts_tpu_torch.train.steps\n"
        "from kantts_tpu_torch.bin.train_sambert import train\n"
        f"trainer = train({train_cfg!r}, {data!r}, {stage!r}, device='cpu')\n"
        "assert trainer.steps_taken == 2, trainer.steps_taken\n"
        "assert all(sys.modules[n] is None\n"
        "           for n in ('jax', 'flax', 'optax', 'kantts_tpu'))\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats["device"] == "cpu" and stats["audio_seconds"] > 0
    assert len(glob.glob(os.path.join(out, "res_wavs", "*.wav"))) == len(TEXTS)
    assert os.path.exists(os.path.join(stage, "ckpt", "checkpoint_2.ckpt"))


def test_port_sources_import_no_jax():
    """No file of the port, and not chip_smoke.py, imports JAX, Flax, optax
    or anything of the JAX package."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax)\b", re.M)
    package = re.compile(r"^\s*(import|from)\s+kantts_tpu(\.|\s|$)", re.M)
    files = glob.glob(os.path.join(ROOT, "kantts_tpu_torch", "**", "*.py"),
                      recursive=True)
    assert len(files) > 10
    for path in files + [os.path.join(ROOT, "chip_smoke.py")]:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        assert not pattern.search(src), path
        assert not package.search(src), path


def _serving_calls(tmp_path):
    from kantts_tpu_torch.bin import infer_hifigan, infer_sambert
    from kantts_tpu_torch.bin import text_to_wav as t2w

    out, ckpt, text = str(tmp_path / "out"), str(tmp_path / "none.pt"), str(
        tmp_path / "none.txt")
    return {
        "am_infer": lambda: infer_sambert.am_infer(text, ckpt, out),
        "hifigan_infer": lambda: infer_hifigan.hifigan_infer(text, ckpt, out),
        "text_to_wav": lambda: t2w.text_to_wav(out, ckpt, ckpt, text),
        "infer_sambert_cli": lambda: infer_sambert.main(
            ["--sentence", text, "--ckpt", ckpt, "--output_dir", out]),
        "infer_hifigan_cli": lambda: infer_hifigan.main(
            ["--ckpt", ckpt, "--input_mel", text, "--output_dir", out]),
        "text_to_wav_cli": lambda: t2w.main(
            ["--txt", text, "--am_ckpt", ckpt, "--voc_ckpt", ckpt,
             "--output_dir", out]),
    }


@pytest.mark.parametrize("entry", ["am_infer", "hifigan_infer", "text_to_wav",
                                   "infer_sambert_cli", "infer_hifigan_cli",
                                   "text_to_wav_cli"])
def test_serving_without_a_device_needs_the_card(entry, tmp_path, monkeypatch):
    """Given no device, each serving entry point runs on the card: without
    one it raises, as the trainers do, before it reads or writes a file."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device; pass --device cpu"):
        _serving_calls(tmp_path)[entry]()
    assert not os.path.exists(tmp_path / "out")

"""The port's serving artifact (``infer/exported.py``, ``bin/export_tts.py``)
at tiny widths on the CPU: artifacts exported once (float32, int8, and an
NSF voice with speaker embeddings), loaded in a subprocess that cannot
import the port's model classes, and run on utterances whose lengths are
not the one traced at export.

Tolerances: the artifact against the live ``fused_infer`` 1e-5 (the same
operations, run from exported programs); against the JAX package's fused
program 2e-4, as the slice test (the 2-layer float32 decode and postnet);
the int8 artifact within rel 0.05 of the float32 one, as the JAX package's
own artifact test.
"""

import copy
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from kantts_tpu.infer.e2e import make_fused_infer
from kantts_tpu.models.hifigan.generator import Generator as JGenerator
from kantts_tpu.models.sambert.sambert import KanTtsSAMBERT as JSAMBERT
from kantts_tpu.text import pinyin_frontend
from kantts_tpu.utils.torch_convert import convert_hifigan_generator, convert_sambert
from kantts_tpu_torch.bin import export_tts
from kantts_tpu_torch.bin.infer_hifigan import load_vocoder
from kantts_tpu_torch.bin.infer_sambert import load_am
from kantts_tpu_torch.configs import get_config
from kantts_tpu_torch.infer.e2e import fused_infer
from kantts_tpu_torch.infer.exported import ExportedTTS, export_fused_tts
from kantts_tpu_torch.infer.symbols import encode_symbol_inputs
from kantts_tpu_torch.models.builder import (
    build_sambert,
    hifigan_model_builder,
    sambert_params,
    save_checkpoint,
)
from test_sambert import TINY
from test_torch_port_hifigan import small_generator_cfg
from test_torch_port_nsf import nsf_generator_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L_IN, BUDGET, HOP = 16, 48, 16
# two utterances of 6 and 11 symbols; the programs were traced at 16
TEXTS = ["ni3 hao3 .", "wo3 men5 qu4 bei3 jing1 ."]
SE_DIM = TINY["speaker_units"]

SYNTH = """
import json, os, sys
import numpy as np
for name in ("jax", "flax", "kantts_tpu", "kantts_tpu_torch.models"):
    sys.modules[name] = None
import kantts_tpu_torch.utils.audio as audio
from kantts_tpu_torch.bin import export_tts
from kantts_tpu_torch.infer.exported import ExportedTTS
spec = json.load(open(sys.argv[1]))
out = {}
save = audio.save_wav

def capture(wav, path, sr):  # the float waveform the synth CLI writes
    out["f32_" + os.path.basename(path)[1:-4]] = np.array(wav)
    save(wav, path, sr)

audio.save_wav = capture
export_tts.main(["synth", "--artifact", spec["artifacts"]["f32"], "--symbols_file",
                 spec["symbols_file"], "--output_dir", spec["wav_dir"], "--device", "cpu"])
for name in ("int8", "nsf"):
    tts = ExportedTTS(spec["artifacts"][name], device="cpu")
    se = np.load(spec["se"]) if tts.meta["se_enable"] else None
    for i, seq in enumerate(spec["symbols"]):
        out[f"{name}_{i}"], n = tts.synthesize(seq, se=se, rng_seed=3)
        out[f"{name}_{i}_frames"] = np.asarray(n)
np.savez(spec["out"], **out)
assert not any(m.startswith("kantts_tpu_torch.models") for m in sys.modules if sys.modules[m])
"""


def _symbols():
    return [s for seqs in pinyin_frontend.text_to_symbols(TEXTS) for s in seqs]


def _models(root, nsf_se: bool = False):
    am_cfg = get_config("sambert_16k_MAS")
    params = dict(TINY, num_mels=80, MAS=True, dur_pred_bias_init=1.0)
    voc_cfg = get_config("hifigan_v1_16k")
    voc_cfg["Model"]["Generator"]["params"] = small_generator_cfg()
    if nsf_se:
        params.update(num_mels=82, MAS=False, NSF=True, SE=True)
        voc_cfg["Model"]["Generator"]["params"] = nsf_generator_cfg()
    am_cfg["Model"]["KanTtsSAMBERT"]["params"] = params
    am, voc = build_sambert(am_cfg, seed=0), hifigan_model_builder(voc_cfg, seed=1)
    am_ckpt, voc_ckpt = str(root / "am.pt"), str(root / "voc.pt")
    save_checkpoint(am_ckpt, am, am_cfg)
    save_checkpoint(voc_ckpt, voc, voc_cfg)
    return am_cfg, am_ckpt, voc_ckpt


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Three artifacts and their synthesis in a subprocess without the
    model classes; the float32 and NSF ones by ``export_fused_tts``, the
    int8 one through the CLI."""
    root = tmp_path_factory.mktemp("export")
    (root / "plain").mkdir()
    (root / "nsf").mkdir()
    am_cfg, am_ckpt, voc_ckpt = _models(root / "plain")
    nsf_cfg, nsf_am, nsf_voc = _models(root / "nsf", nsf_se=True)
    arts = {"f32": str(root / "art_f32"), "int8": str(root / "art_int8"),
            "nsf": str(root / "art_nsf")}
    metas = {"f32": export_fused_tts(am_ckpt, voc_ckpt, arts["f32"], L_IN, BUDGET,
                                     platforms=("cpu",), device="cpu"),
             "nsf": export_fused_tts(nsf_am, nsf_voc, arts["nsf"], L_IN, BUDGET,
                                     platforms=("cpu",), device="cpu")}
    export_tts.main(["export", "--am_ckpt", am_ckpt, "--voc_ckpt", voc_ckpt,
                     "--output_dir", arts["int8"], "--max_input_len", str(L_IN),
                     "--max_output_len", str(BUDGET), "--int8", "--platforms", "cpu",
                     "--device", "cpu"])
    se = np.random.RandomState(7).randn(SE_DIM).astype(np.float32)
    np.save(root / "se.npy", se)
    symbols = _symbols()
    (root / "symbols.txt").write_text(
        "".join(f"u{i}\t{s}\n" for i, s in enumerate(symbols)), encoding="utf-8")
    spec = {"artifacts": arts, "symbols": symbols, "se": str(root / "se.npy"),
            "symbols_file": str(root / "symbols.txt"), "wav_dir": str(root / "wavs"),
            "out": str(root / "out.npz")}
    (root / "spec.json").write_text(json.dumps(spec))
    proc = subprocess.run([sys.executable, "-c", SYNTH, str(root / "spec.json")],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {"root": root, "arts": arts, "metas": metas, "symbols": symbols, "se": se,
            "out": dict(np.load(root / "out.npz")), "am_cfg": am_cfg,
            "ckpts": (am_ckpt, voc_ckpt), "nsf_ckpts": (nsf_am, nsf_voc),
            "nsf_cfg": nsf_cfg}


def _fused(am_ckpt, voc_ckpt, seq, se=None, rng_seed=0):
    am, ling_unit = load_am(am_ckpt, torch.device("cpu"))
    gen, _ = load_vocoder(voc_ckpt, torch.device("cpu"))
    ling, emo, spk, lengths = (torch.from_numpy(a) for a in encode_symbol_inputs(
        ling_unit, seq, L_IN, 4, se))
    wav, n = fused_infer(am, gen, ling.long(), emo.long(),
                         spk if se is not None else spk.long(), lengths, BUDGET,
                         rng_seed=rng_seed)
    n = int(n[0])
    return wav[0, :n * HOP, 0].numpy(), n


def test_artifact_layout_and_meta(artifacts):
    for name, art in artifacts["arts"].items():
        meta = json.load(open(os.path.join(art, "meta.json")))
        for key in ("kind", "platforms", "max_input_len", "max_output_len",
                    "n_chunks", "outputs_per_step", "n_ling", "se_enable", "se_dim",
                    "hop_total", "sampling_rate", "nsf_enable", "int8", "programs",
                    "torch_version"):
            assert key in meta, (name, key)
        assert meta["max_output_len"] == BUDGET and meta["hop_total"] == HOP
        assert meta["int8"] == (name == "int8")
        for rel in meta["programs"].values():
            assert os.path.getsize(os.path.join(art, rel)) > 0
        assert os.path.exists(os.path.join(art, "config.yaml"))
    assert artifacts["metas"]["nsf"]["nsf_enable"] and artifacts["metas"]["nsf"]["se_enable"]


def test_artifact_matches_fused_infer_and_jax(artifacts):
    """Two utterances of untraced lengths: the artifact's waveforms equal
    the live ``fused_infer`` within 1e-5 and the JAX package's fused
    program on the bridged weights within 2e-4. They are the float
    waveforms the synth CLI wrote."""
    out, cfg = artifacts["out"], artifacts["am_cfg"]
    am_ckpt, voc_ckpt = artifacts["ckpts"]
    am, ling_unit = load_am(am_ckpt, torch.device("cpu"))
    gen, voc_cfg = load_vocoder(voc_ckpt, torch.device("cpu"))
    params = sambert_params(cfg)
    j_am_vars = {"params": convert_sambert(
        {k: v.numpy() for k, v in am.state_dict().items()}, params)}
    j_voc_vars = {"params": convert_hifigan_generator(
        {k: v.numpy() for k, v in gen.state_dict().items()}, small_generator_cfg())}
    fn = make_fused_infer(JSAMBERT(params), JGenerator(**small_generator_cfg()), BUDGET)
    frames = []
    for i, seq in enumerate(artifacts["symbols"]):
        got = out[f"f32_{i}"]
        want, n = _fused(am_ckpt, voc_ckpt, seq)
        assert 0 < n < BUDGET and got.shape == (n * HOP,)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        ling, emo, spk, lengths = encode_symbol_inputs(ling_unit, seq, L_IN)
        j_wav, j_n = fn(j_am_vars, j_voc_vars, ling, emo, spk, lengths,
                        jax.random.PRNGKey(0))
        assert int(np.asarray(j_n)[0]) == n
        np.testing.assert_allclose(got, np.asarray(j_wav)[0, :n * HOP, 0], atol=2e-4,
                                   rtol=0)
        assert os.path.exists(artifacts["root"] / "wavs" / f"u{i}.wav")
        frames.append(n)
    assert frames[0] != frames[1]


def test_int8_artifact_close_to_f32(artifacts):
    out = artifacts["out"]
    for i in range(len(artifacts["symbols"])):
        wav, wav8 = out[f"f32_{i}"], out[f"int8_{i}"]
        assert wav8.shape == wav.shape and np.isfinite(wav8).all()
        rel = np.linalg.norm(wav8 - wav) / max(np.linalg.norm(wav), 1e-9)
        assert 0 < rel < 0.05, rel


def test_nsf_se_artifact_matches_fused_infer(artifacts):
    """An NSF voice with speaker embeddings: the artifact's source draws
    are the live vocoder's for the same seed; without ``se=`` it refuses."""
    out = artifacts["out"]
    am_ckpt, voc_ckpt = artifacts["nsf_ckpts"]
    for i, seq in enumerate(artifacts["symbols"]):
        want, n = _fused(am_ckpt, voc_ckpt, seq, se=artifacts["se"], rng_seed=3)
        assert int(out[f"nsf_{i}_frames"]) == n
        np.testing.assert_allclose(out[f"nsf_{i}"], want, atol=1e-5, rtol=0)
    tts = ExportedTTS(artifacts["arts"]["nsf"], device="cpu")
    with pytest.raises(ValueError, match="pass se="):
        tts.synthesize(artifacts["symbols"][0])


def test_export_refusals(artifacts, tmp_path):
    """A multi-band generator, int8 with the chunked epilogue and a budget
    that is not a multiple of r are refused, as in the JAX package; an
    artifact refuses a device outside its platforms."""
    am_ckpt, voc_ckpt = artifacts["ckpts"]
    payload = torch.load(voc_ckpt, map_location="cpu", weights_only=True)
    mb_cfg = copy.deepcopy(payload["config"])
    mb_cfg["Model"]["Generator"]["params"]["out_channels"] = 4
    mb_ckpt = str(tmp_path / "mb.pt")
    save_checkpoint(mb_ckpt, hifigan_model_builder(mb_cfg, seed=1), mb_cfg)
    with pytest.raises(ValueError, match="fullband"):
        export_fused_tts(am_ckpt, mb_ckpt, str(tmp_path / "a"), L_IN, BUDGET,
                         platforms=("cpu",), device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        export_fused_tts(am_ckpt, voc_ckpt, str(tmp_path / "b"), L_IN, BUDGET,
                         n_chunks=2, platforms=("cpu",), int8=True, device="cpu")
    with pytest.raises(ValueError, match="multiple of r"):
        export_fused_tts(am_ckpt, voc_ckpt, str(tmp_path / "c"), L_IN, BUDGET + 1,
                         platforms=("cpu",), device="cpu")
    with pytest.raises(ValueError, match="exported for"):
        ExportedTTS(artifacts["arts"]["f32"], device="cuda")

"""The port's vocoder serving variants against the JAX package, at TINY
widths on the CPU: exact streaming, chunked-batch vocoding, the fused
acoustic + vocoder path, and ``infer_hifigan``'s bucketed, chunked and
batched paths (the repair of F1: a non-causal generator's output depends on
the bucket padding, so the port pads as the JAX package does).

Weights are made by JAX and carried to the port by the weight bridge.
Tolerance 1e-5 throughout, the generator's (tests/test_torch_port_hifigan.py).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import kantts_tpu.bin.infer_hifigan as j_infer_hifigan
from kantts_tpu.infer.chunked import chunked_apply as j_chunked_apply
from kantts_tpu.infer.streaming import causal_receptive_field_frames as j_rf
from kantts_tpu.infer.streaming import stream_synthesis as j_stream_synthesis
from kantts_tpu.models.hifigan.generator import Generator as JGenerator
import kantts_tpu_torch.bin.infer_hifigan as infer_hifigan
from kantts_tpu_torch.bin.infer_sambert import encode_symbol_inputs
from kantts_tpu_torch.configs import get_config
from kantts_tpu_torch.infer.chunked import chunked_apply
from kantts_tpu_torch.infer.e2e import fused_infer
from kantts_tpu_torch.infer.streaming import (
    causal_receptive_field_frames,
    stream_synthesis,
)
from kantts_tpu_torch.models.builder import save_checkpoint
from kantts_tpu_torch.models.hifigan.generator import Generator
from kantts_tpu_torch.models.sambert.sambert import sambert_infer
from kantts_tpu_torch.utils.convert import hifigan_state_dict_from_jax
from test_torch_port_hifigan import small_generator_cfg
from test_torch_port_slice import L_IN, _symbols, slice_models  # noqa: F401

ATOL = 1e-5
HOP = 16  # prod(small_generator_cfg()["upsample_scales"])


def _generator_pair(cfg, seed=0):
    """-> (JAX generator, its params, the port's generator on the same
    weights)."""
    j_gen = JGenerator(**cfg)
    params = j_gen.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 80)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    port = Generator(**cfg)
    port.load_state_dict(hifigan_state_dict_from_jax(params, cfg), strict=True)
    return j_gen, params, port.eval()


@pytest.fixture(scope="module")
def causal_pair():
    return _generator_pair(small_generator_cfg())


@pytest.mark.parametrize("T,chunk", [(57, 16), (40, 10)])
def test_stream_synthesis_matches_jax_and_whole(causal_pair, T, chunk):
    j_gen, params, port = causal_pair
    mel = np.random.RandomState(T).randn(T, 80).astype(np.float32)
    got = list(stream_synthesis(port, mel, chunk_frames=chunk))
    assert len(got) == -(-T // chunk)
    assert all(c.shape == (chunk * HOP, 1) for c in got[:-1])
    got = np.concatenate(got)
    want = np.concatenate(list(j_stream_synthesis(j_gen, {"params": params}, mel,
                                                  chunk_frames=chunk)))
    with torch.no_grad():
        whole = port(torch.from_numpy(mel[None]))[0].numpy()
    assert got.shape == want.shape == whole.shape == (T * HOP, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, whole, atol=ATOL, rtol=0)


@pytest.mark.parametrize("cfg", [
    small_generator_cfg(),
    get_config("hifigan_v1_16k")["Model"]["Generator"]["params"],
    dict(kernel_size=5, upsample_scales=(8, 8, 2, 2),
         resblock_kernel_sizes=(3, 7, 11), resblock_dilations=((1, 3, 5),) * 3),
    dict(kernel_size=3, upsample_scales=(5, 2), resblock_kernel_sizes=(3,),
         resblock_dilations=((1, 2),)),
])
def test_receptive_field_matches_jax(cfg):
    args = [cfg[k] for k in ("kernel_size", "upsample_scales",
                             "resblock_kernel_sizes", "resblock_dilations")]
    assert causal_receptive_field_frames(*args) == j_rf(*args) > 1


@pytest.mark.parametrize("T,n_chunks", [(57, 4), (40, 3)])
def test_chunked_apply_matches_jax(causal_pair, T, n_chunks):
    j_gen, params, port = causal_pair
    mel = np.random.RandomState(T + n_chunks).randn(1, T, 80).astype(np.float32)
    want = np.asarray(j_chunked_apply(j_gen, {"params": params}, jnp.asarray(mel),
                                      jax.random.PRNGKey(0), n_chunks))
    with torch.no_grad():
        got = chunked_apply(port, torch.from_numpy(mel), n_chunks).numpy()
        whole = port(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (1, T * HOP, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, whole, atol=ATOL, rtol=0)


def test_chunked_and_streaming_refuse_noncausal():
    port = Generator(**small_generator_cfg(causal=False)).eval()
    mel = np.zeros((20, 80), dtype=np.float32)
    with pytest.raises(AssertionError, match="causal"):
        chunked_apply(port, torch.from_numpy(mel[None]), 2)
    with pytest.raises(AssertionError, match="causal"):
        next(stream_synthesis(port, mel, chunk_frames=8))


@pytest.mark.parametrize("n_chunks", [0, 3])
def test_fused_infer_matches_two_calls(slice_models, causal_pair, n_chunks):
    m, port = slice_models, causal_pair[2]
    seq = _symbols()[0]
    args = [torch.from_numpy(a) for a in encode_symbol_inputs(m["ling_unit"], seq, L_IN)]
    args = [a.long() for a in args[:3]] + [args[3]]
    budget = L_IN * 24
    wav, n_frames = fused_infer(m["am"], port, *args, budget, n_chunks=n_chunks)
    mel = sambert_infer(m["am"], *args, budget)
    with torch.no_grad():
        want = port(mel["postnet_outputs"])
    assert wav.shape == (1, budget * HOP, 1)
    assert int(n_frames[0]) == int(mel["LR_length_rounded"][0]) > 0
    np.testing.assert_allclose(wav.numpy(), want.numpy(), atol=ATOL, rtol=0)


def _write_checkpoints(tmp_path, cfg, seed=0):
    """The same weights as a JAX msgpack checkpoint (laid out as
    tests/test_infer_hifigan_cli.py does) and a port checkpoint. -> (JAX
    checkpoint, JAX config, port checkpoint)."""
    _, params, port = _generator_pair(cfg, seed)
    j_ckpt = tmp_path / "ckpt_0.msgpack"
    j_ckpt.write_bytes(serialization.msgpack_serialize(
        {"model": {"generator": params}}))
    config = {"model_type": "hifigan", "Model": {"Generator": {"params": dict(cfg)}},
              "audio_config": {"sampling_rate": 16000}}
    t_ckpt = str(tmp_path / "voc.pt")
    save_checkpoint(t_ckpt, port, config)
    return str(j_ckpt), config, t_ckpt


def _capture_wavs(monkeypatch, module) -> dict:
    """Record the float waveforms ``module`` hands to save_wav, by utterance."""
    wavs = {}
    save = module.save_wav

    def capture(wav, path, sr):
        wavs[os.path.splitext(os.path.basename(path))[0]] = np.array(wav)
        save(wav, path, sr)

    monkeypatch.setattr(module, "save_wav", capture)
    return wavs


@pytest.mark.parametrize("causal", [False, True])
def test_hifigan_infer_matches_jax(causal, tmp_path, monkeypatch):
    """F1: both packages' hifigan_infer on the same weights and mels. The
    21-frame mel pads to the 100-frame bucket; a non-causal generator's
    last frames depend on that padding (0.17 apart without it)."""
    j_ckpt, config, t_ckpt = _write_checkpoints(tmp_path, small_generator_cfg(causal))
    mel_dir = tmp_path / "mels"
    mel_dir.mkdir()
    rng = np.random.RandomState(3)
    for name, T in (("a", 21), ("b", 130)):
        np.save(mel_dir / f"{name}.npy", rng.randn(T, 80).astype(np.float32))
    want = _capture_wavs(monkeypatch, j_infer_hifigan)
    got = _capture_wavs(monkeypatch, infer_hifigan)
    j_infer_hifigan.hifigan_infer(str(mel_dir), j_ckpt, str(tmp_path / "jax"),
                                  config=config)
    infer_hifigan.hifigan_infer(str(mel_dir), t_ckpt, str(tmp_path / "port"),
                                device="cpu")
    assert sorted(got) == sorted(want) == ["a", "b"]
    for utt, T in (("a", 21), ("b", 130)):
        assert got[utt].shape == want[utt].shape == (T * HOP,)
        np.testing.assert_allclose(got[utt], want[utt], atol=ATOL, rtol=0)


def test_hifigan_infer_chunked_and_batched_match_plain(tmp_path, monkeypatch):
    """--chunked 3 and --batch 2 (three mels: one group of two, one padded
    with a zero mel) give the plain path's waveforms."""
    _, _, t_ckpt = _write_checkpoints(tmp_path, small_generator_cfg())
    mel_dir = tmp_path / "mels"
    mel_dir.mkdir()
    rng = np.random.RandomState(4)
    lengths = {"a": 37, "b": 120, "c": 64}
    for name, T in lengths.items():
        np.save(mel_dir / f"{name}.npy", rng.randn(T, 80).astype(np.float32))
    runs = {}
    for name, kwargs in (("plain", {}), ("chunked", {"chunked": 3}),
                         ("batch", {"batch": 2})):
        runs[name] = _capture_wavs(monkeypatch, infer_hifigan)
        stats = infer_hifigan.hifigan_infer(str(mel_dir), t_ckpt,
                                            str(tmp_path / name), device="cpu",
                                            **kwargs)
        assert stats["audio_seconds"] == pytest.approx(
            sum(lengths.values()) * HOP / 16000)
        assert len(glob.glob(str(tmp_path / name / "*.wav"))) == 3
    for name in ("chunked", "batch"):
        for utt, T in lengths.items():
            assert runs[name][utt].shape == (T * HOP,)
            np.testing.assert_allclose(runs[name][utt], runs["plain"][utt],
                                       atol=ATOL, rtol=0, err_msg=f"{name} {utt}")


def test_hifigan_infer_refusals(tmp_path):
    _, _, causal_ckpt = _write_checkpoints(tmp_path, small_generator_cfg())
    noncausal = tmp_path / "noncausal"
    noncausal.mkdir()
    _, _, noncausal_ckpt = _write_checkpoints(noncausal, small_generator_cfg(False))
    mel_dir = str(tmp_path)
    with pytest.raises(SystemExit, match="mutually exclusive"):
        infer_hifigan.hifigan_infer(mel_dir, causal_ckpt, str(tmp_path / "o"),
                                    device="cpu", chunked=2, batch=2)
    with pytest.raises(SystemExit, match="causal"):
        infer_hifigan.hifigan_infer(mel_dir, noncausal_ckpt, str(tmp_path / "o"),
                                    device="cpu", chunked=2)
    with pytest.raises(SystemExit, match="--chunked and --int8"):
        infer_hifigan.main(["--ckpt", causal_ckpt, "--input_mel", mel_dir,
                            "--output_dir", str(tmp_path / "o"), "--int8",
                            "--chunked", "2", "--device", "cpu"])

"""The port's preprocessing (``kantts_tpu_torch.bin.process_data`` and what
it runs) against the JAX package's, on the CPU at small sizes, with inputs
made from a seed. Tolerances:

- ``kaldi_fbank``: atol 1e-6 (the same numpy code);
- the pitch trackers and ``get_pitch``: bit-equal (the same C++ source
  built with the same flags);
- ``get_energy``: rtol 1e-5 with atol 1e-6 (the port's STFT rule,
  ``tests/test_torch_port_dsp.py``); written energies likewise, once each
  side is de-normalised with its own written mean and std;
- the D-TDNN: atol 1e-4 on the embedding, and on speaker embeddings;
- mels: atol 1e-5 before normalisation (the feature-extraction mel's rule),
  written mels within 1e-5 / std of their bin, ``mel_mean.txt`` and
  ``mel_std.txt`` within 2e-6 (two roundings to six decimals);
- texts, metafiles, splits, badlists, durations, f0 and uv: equal;
- Griffin-Lim with the phase injected: atol 1e-4 on waveforms of peak ~4,
  and 5e-5 on the normalised linear spectrogram;
- ``mcd_between_wavs``: rtol 1e-4 (a log of float32 STFT mels), the
  numpy-only metrics exactly.

The FP processor shuffles its lines with Python's ``random``, which both
packages' runs here seed alike. JAX runs on the CPU; the module skips where
JAX is absent, as on the card's machine.
"""

import filecmp
import glob
import os
import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kantts_tpu.bin import process_data as j_pd  # noqa: E402
from kantts_tpu.dsp import griffin_lim as j_gl  # noqa: E402
from kantts_tpu.dsp import mel as j_mel  # noqa: E402
from kantts_tpu.dsp import stft as j_stft  # noqa: E402
from kantts_tpu.native import pitch as j_pitch  # noqa: E402
from kantts_tpu.preprocess import audio_utils as j_au  # noqa: E402
from kantts_tpu.preprocess import se_processor as j_se  # noqa: E402
from kantts_tpu.utils import metrics as j_metrics  # noqa: E402
from kantts_tpu_torch.bin import process_data as t_pd  # noqa: E402
from kantts_tpu_torch.configs import get_config  # noqa: E402
from kantts_tpu_torch.data.dataset import (  # noqa: E402
    DataLoader,
    get_am_datasets,
    get_voc_datasets,
)
from kantts_tpu_torch.dsp import griffin_lim as t_gl  # noqa: E402
from kantts_tpu_torch.native import pitch as t_pitch  # noqa: E402
from kantts_tpu_torch.preprocess import audio_processor as t_ap  # noqa: E402
from kantts_tpu_torch.preprocess import audio_utils as t_au  # noqa: E402
from kantts_tpu_torch.preprocess import se_processor as t_se  # noqa: E402
from kantts_tpu_torch.utils import metrics as t_metrics  # noqa: E402
from kantts_tpu_torch.utils.config import load_merged_config  # noqa: E402
from kantts_tpu_torch.utils.corpus import (  # noqa: E402
    dtdnn_state_dict,
    write_voice_dir,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_CONFIGS = os.path.join(ROOT, "kantts_tpu", "configs")
T_CONFIGS = os.path.join(ROOT, "kantts_tpu_torch", "resources", "configs")
SR = 16000
# a narrow D-TDNN at the full (12, 24, 16) depth
NARROW_DTDNN = {"head": 8, "tdnn": 16, "growth": 4, "bottleneck": 8, "embedding": 32}


def _harmonic(seconds: float, seed: int, sr: int = SR) -> np.ndarray:
    """A harmonic tone whose f0 glides around 120-220 Hz, with an unvoiced
    stretch and a little noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(120, 220) * (1 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(np.sin(k * phase) / k for k in range(1, 6))
    wav[len(t) // 3: len(t) // 2] = 0.0
    return (0.4 * wav / np.abs(wav).max() + 0.01 * rng.randn(len(t))).astype(np.float32)


# ------------------------------------------------------------- host features


@pytest.mark.parametrize("n", [16000, 7777])
def test_kaldi_fbank_matches_jax(n):
    wav = _harmonic(n / SR, 0)
    want = j_se.kaldi_fbank(wav, SR, num_mel_bins=80)
    got = t_se.kaldi_fbank(wav, SR, num_mel_bins=80)
    assert got.shape == want.shape == (1 + (n - 400) // 160, 80)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("fn", ["rapt", "yin", "get_pitch"])
def test_pitch_bit_equal(fn):
    wav = _harmonic(1.5, 1)
    if fn == "get_pitch":
        want, got = j_au.get_pitch(wav, SR, 200), t_au.get_pitch(wav, SR, 200)
        assert got is not None and len(got) == len(want) == 3
        assert got[1].min() == 0 and got[1].max() == 1  # voiced and unvoiced frames
    else:
        want = [getattr(j_pitch, fn)(wav, SR, 200, 40.0, 800.0)]
        got = [getattr(t_pitch, fn)(wav, SR, 200, 40.0, 800.0)]
        assert (got[0] > 0).any()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["short", "unvoiced"])
def test_get_pitch_none(case):
    wav = (_harmonic(0.05, 2) if case == "short" else np.zeros(SR, np.float32))
    assert j_au.get_pitch(wav, SR, 200) is None
    assert t_au.get_pitch(wav, SR, 200) is None


def test_failed_pitch_build_raises(tmp_path, monkeypatch):
    """A source the compiler refuses raises with its output; get_pitch
    raises too, so no stand-in tracker runs."""
    src = tmp_path / "pitch.cpp"
    src.write_text("int rapt_pitch( {\n")
    monkeypatch.setattr(t_pitch, "library", t_pitch.PitchLibrary(
        str(src), str(tmp_path / "build")))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on .*pitch.cpp"):
        t_pitch.rapt(_harmonic(0.5, 3), SR, 200)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        t_au.get_pitch(_harmonic(0.5, 3), SR, 200)
    assert not os.listdir(tmp_path / "build")


def _energy_float64(wav: np.ndarray, hop: int, win: int, n_fft: int) -> np.ndarray:
    """``get_energy`` in float64 numpy: a periodic Hann window of ``win``
    centred in ``n_fft``, reflect padding of n_fft // 2, |rfft| summed."""
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win) / win)
    lpad = (n_fft - win) // 2
    window = np.pad(window, (lpad, n_fft - win - lpad))
    x = np.pad(wav.astype(np.float64), n_fft // 2, mode="reflect")
    frames = np.stack([x[i:i + n_fft] for i in range(0, len(x) - n_fft + 1, hop)])
    mag = np.abs(np.fft.rfft(frames * window, axis=-1))
    return np.sqrt(np.sum(mag ** 2, axis=1)).reshape(-1, 1)


@pytest.mark.parametrize("n_fft,hop,win", [(2048, 200, 1000), (1024, 240, 1024)])
def test_get_energy_matches_jax(n_fft, hop, win):
    """Each side is first held to the float64 energy under the same
    tolerance, so that a miss names the side that moved (both sit far
    inside it)."""
    wav = _harmonic(1.1, 4)
    want = j_au.get_energy(wav, hop, win, n_fft)
    got = t_au.get_energy(wav, hop, win, n_fft, "cpu")
    assert got.shape == want.shape == (1 + len(wav) // hop, 1)
    assert got.dtype == np.float32
    exact = _energy_float64(wav, hop, win, n_fft)
    np.testing.assert_allclose(want, exact, rtol=1e-5, atol=1e-6,
                               err_msg="the JAX package's energy against float64")
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-6,
                               err_msg="the port's energy against float64")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("T", [230, 57])
def test_dtdnn_matches_jax(T):
    """The port's module against ``dtdnn_embed`` at narrow widths and full
    depth; odd T runs the stride-2 TDNN on an odd length."""
    sd = dtdnn_state_dict(5, NARROW_DTDNN)
    model = t_se.DTDNN(sd)
    feat = np.random.RandomState(T).randn(2, T, 80).astype(np.float32)
    want = j_se.dtdnn_embed({k: v.numpy() for k, v in sd.items()}, feat)
    with torch.no_grad():
        got = model(torch.from_numpy(feat)).numpy()
    assert got.shape == want.shape == (2, NARROW_DTDNN["embedding"])
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    with pytest.raises(KeyError, match="head.bn1.running_var"):
        t_se.DTDNN({k: v for k, v in sd.items() if k != "head.bn1.running_var"})


# ------------------------------------------------------- process_data: plain


def _recording(cls, name, store):
    class Recording(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            store[name] = self
    return Recording


@pytest.fixture(scope="module")
def plain_voice(tmp_path_factory):
    """A 6-utterance prosody voice with intervals through both packages'
    ``process_data`` (the port's through its CLI with ``--device cpu``),
    with each side's ``AudioProcessor`` kept."""
    root = str(tmp_path_factory.mktemp("plain"))
    voice = os.path.join(root, "voice")
    write_voice_dir(voice, 6, (2.0, 4.0), seed=1)
    processors = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in (("jax", j_pd), ("port", t_pd)):
            mp.setattr(mod, "AudioProcessor",
                       _recording(mod.AudioProcessor, name, processors))
        j_pd.process_data(voice, os.path.join(root, "jax"),
                          os.path.join(J_CONFIGS, "audio_config_16k.yaml"), "F7")
        t_pd.main(["--voice_input_dir", voice, "--voice_output_dir",
                   os.path.join(root, "port"), "--audio_config",
                   os.path.join(T_CONFIGS, "audio_config_16k.yaml"),
                   "--speaker", "F7", "--device", "cpu"])
    return root, processors


def _same_file(root, rel):
    a, b = os.path.join(root, "jax", rel), os.path.join(root, "port", rel)
    assert os.path.exists(a) and os.path.exists(b), rel
    assert filecmp.cmp(a, b, shallow=False), rel


@pytest.mark.parametrize("name", ["raw_metafile.txt", "Script.xml", "train.lst",
                                  "valid.lst", "am_train.lst", "am_valid.lst",
                                  "badlist.txt"])
def test_plain_voice_texts_equal(plain_voice, name):
    root, _ = plain_voice
    _same_file(root, name)
    if name in ("raw_metafile.txt", "am_train.lst", "train.lst"):
        with open(os.path.join(root, "port", name), encoding="utf-8") as f:
            assert len(f.read().splitlines()) >= 3


@pytest.mark.parametrize("sub", ["raw_duration", "duration", "f0", "frame_f0",
                                 "frame_uv"])
def test_plain_voice_features_equal(plain_voice, sub):
    root, _ = plain_voice
    names = sorted(os.listdir(os.path.join(root, "jax", sub)))
    assert sorted(os.listdir(os.path.join(root, "port", sub))) == names
    assert sum(n.endswith(".npy") for n in names) >= 6
    for name in names:
        rel = os.path.join(sub, name)
        if name.endswith(".npy"):
            a, b = (np.load(os.path.join(root, side, rel)) for side in ("jax", "port"))
            assert a.dtype == b.dtype, rel
            np.testing.assert_array_equal(b, a, err_msg=rel)
        else:
            _same_file(root, rel)


def test_plain_voice_durations_cover_the_mels(plain_voice):
    root, _ = plain_voice
    for path in glob.glob(os.path.join(root, "port", "duration", "*.npy")):
        utt = os.path.basename(path)
        frames = np.load(os.path.join(root, "port", "mel", utt)).shape[0]
        assert np.load(path).sum() == frames
        for sub in ("frame_f0", "frame_uv", "frame_energy"):
            assert len(np.load(os.path.join(root, "port", sub, utt))) == frames


def test_plain_voice_mels(plain_voice):
    """The un-normalised mels, the corpus statistics and the written mels."""
    root, processors = plain_voice
    want, got = processors["jax"].mel_dict, processors["port"].mel_dict
    assert got.keys() == want.keys() and len(got) >= 6
    for utt in want:
        np.testing.assert_allclose(got[utt], want[utt], atol=1e-5, rtol=0, err_msg=utt)
    stats = {}
    for name in ("mel_mean.txt", "mel_std.txt"):
        a, b = (np.loadtxt(os.path.join(root, side, "mel", name))
                for side in ("jax", "port"))
        np.testing.assert_allclose(b, a, atol=2e-6, rtol=0)
        stats[name] = a
    std = stats["mel_std.txt"]
    for utt in want:
        a, b = (np.load(os.path.join(root, side, "mel", utt + ".npy"))
                for side in ("jax", "port"))
        np.testing.assert_array_equal(np.isnan(b), np.isnan(a))
        err = np.nan_to_num(np.abs(b - a)) * std
        assert err.max() <= 1e-5, (utt, err.max())


@pytest.mark.parametrize("sub", ["energy", "frame_energy"])
def test_plain_voice_energy(plain_voice, sub):
    root, _ = plain_voice
    for side_a in glob.glob(os.path.join(root, "jax", sub, "utt*.npy")):
        raw = []
        for side in ("jax", "port"):
            mean, std = (np.loadtxt(os.path.join(root, side, "energy", f"energy_{s}.txt"))
                         for s in ("mean", "std"))
            x = np.load(side_a.replace(os.sep + "jax" + os.sep, os.sep + side + os.sep))
            raw.append(np.where(x == 0.0, 0.0, x * std + mean))
        np.testing.assert_array_equal(raw[1] == 0.0, raw[0] == 0.0)
        np.testing.assert_allclose(raw[1], raw[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("use", ["mas", "duration", "voc"])
def test_processed_voice_loads(plain_voice, use):
    """The port's output feeds the port's datasets: a MAS and a duration
    acoustic config, and the vocoder; one batch of each collates."""
    root, _ = plain_voice
    data = os.path.join(root, "port")
    if use == "voc":
        config = dict(load_merged_config(data, os.path.join(T_CONFIGS, "hifigan_v1_16k.yaml")),
                      batch_size=2, batch_max_steps=2400)
        train, _ = get_voc_datasets(config, [data])
        wav, mel = train.collate_fn([train[0], train[1]], np.random.RandomState(0))
        assert wav.shape == (2, 2400, 1) and mel.shape == (2, 12, 80)
        return
    config = get_config("sambert_16k_MAS")
    config.update(load_merged_config(data, os.path.join(T_CONFIGS, "sambert_16k_MAS.yaml")))
    config["Model"]["KanTtsSAMBERT"]["params"]["MAS"] = use == "mas"
    train, valid = get_am_datasets([os.path.join(data, "raw_metafile.txt")], [data],
                                   config)
    assert len(train) >= 3 and len(valid) >= 1
    batch = next(iter(DataLoader(train, 2)))
    assert batch["mel_targets"].shape[2] == 80
    if use == "mas":
        assert batch["durations"] is None and batch["attn_priors"] is not None
    else:
        # the EOS slot after each item's symbols stashes the mel padding
        for durs, n_in, n_out in zip(batch["durations"], batch["valid_input_lengths"],
                                     batch["valid_output_lengths"]):
            assert durs[:n_in].sum() == n_out
            assert durs.sum() == batch["mel_targets"].shape[1]


# ------------------------------------------- process_data: byte, FP and SE


def _process_both(voice, root, config_name, **kwargs):
    outs = []
    for side, mod, configs, extra in (("jax", j_pd, J_CONFIGS, {}),
                                      ("port", t_pd, T_CONFIGS, {"device": "cpu"})):
        random.seed(0)
        out = os.path.join(root, side)
        mod.process_data(voice, out, os.path.join(configs, config_name), "F7",
                         **kwargs, **extra)
        outs.append(out)
    return outs


@pytest.mark.parametrize("mode", ["byte", "fp", "se"])
def test_voice_modes_match_jax(mode, tmp_path):
    root = str(tmp_path)
    voice = os.path.join(root, "voice")
    kwargs, config = {}, "audio_config_16k.yaml"
    if mode == "se":
        write_voice_dir(voice, 2, (2.0, 3.0), seed=3)
        kwargs["se_model"] = os.path.join(root, "se.model")
        torch.save(dtdnn_state_dict(3, NARROW_DTDNN), kwargs["se_model"])
        config = "audio_config_se_16k.yaml"
    else:
        write_voice_dir(voice, 5, (2.0, 3.5), seed=4, interval=mode == "fp", mode=mode)
    jax_out, port_out = _process_both(voice, root, config, **kwargs)
    names = ["raw_metafile.txt", "train.lst", "valid.lst", "am_train.lst",
             "am_valid.lst", "badlist.txt"]
    if mode == "fp":
        names += [f"{v}_metafile.txt" for v in ("fpadd", "fprm")] + [
            f"am_{v}_{s}.lst" for v in ("fpadd", "fprm") for s in ("train", "valid")]
    for name in names:
        _same_file(root, name)
    with open(os.path.join(port_out, "raw_metafile.txt"), encoding="utf-8") as f:
        meta = f.read()
    if mode == "byte":
        assert "$emotion_neutral$F7}" in meta and "_c$" not in meta
    if mode == "fp":
        with open(os.path.join(port_out, "fpadd_metafile.txt"), encoding="utf-8") as f:
            assert "emotion_disgust" in f.read()
    if mode == "se":
        files = sorted(os.listdir(os.path.join(jax_out, "se")))
        assert files == sorted(os.listdir(os.path.join(port_out, "se")))
        assert "se.npy" in files and len(files) == 3
        for name in files:
            a, b = (np.load(os.path.join(out, "se", name)) for out in (jax_out, port_out))
            assert a.shape == b.shape == (1, NARROW_DTDNN["embedding"])
            np.testing.assert_allclose(b, a, atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("entry", ["process_data", "AudioProcessor",
                                   "SpeakerEmbeddingProcessor"])
def test_preprocessing_without_a_device_needs_the_card(entry, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "process_data": lambda: t_pd.process_data(
            str(tmp_path / "voice"), str(tmp_path / "out"),
            os.path.join(T_CONFIGS, "audio_config_16k.yaml")),
        "AudioProcessor": lambda: t_ap.AudioProcessor({}),
        "SpeakerEmbeddingProcessor": lambda: t_se.SpeakerEmbeddingProcessor(),
    }
    with pytest.raises(RuntimeError, match="no CUDA device; pass --device cpu"):
        calls[entry]()
    assert not os.path.exists(tmp_path / "out")


# ---------------------------------------------------------------- Griffin-Lim


@pytest.mark.parametrize("fn", ["griffin_lim", "inv_mel_spectrogram",
                                "inv_spectrogram", "spectrogram"])
def test_griffin_lim_matches_jax(fn):
    n_fft, hop, win = 1024, 256, 1024
    wav = _harmonic(0.5, 6)
    x = torch.from_numpy(wav)
    if fn == "spectrogram":
        want = np.asarray(j_gl.spectrogram(jnp.asarray(wav), n_fft, hop, win))
        got = t_gl.spectrogram(x, n_fft, hop, win).numpy()
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
        return
    if fn == "griffin_lim":
        feat = np.asarray(jnp.abs(j_stft.stft_complex(jnp.asarray(wav), n_fft, hop, win)))
        shape, args = feat.shape, (n_fft, hop, win, 8)
    elif fn == "inv_spectrogram":
        feat = np.asarray(j_gl.spectrogram(jnp.asarray(wav), n_fft, hop, win))
        shape, args = feat.shape, (n_fft, hop, win)
    else:
        feat = np.asarray(j_mel.melspectrogram(jnp.asarray(wav), SR, n_fft, hop, win, 80,
                                               fmin=50.0, fmax=8000.0))
        shape, args = (feat.shape[0], n_fft // 2 + 1), (SR, n_fft, hop, win, 80)
    kw = {} if fn == "griffin_lim" else {"n_iter": 8}
    # the JAX package's initial phase: uniform in [0, 2 pi) from key 0
    angles = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), shape,
                                           minval=0.0, maxval=2 * np.pi))
    want = np.asarray(getattr(j_gl, fn)(jnp.asarray(feat), *args, **kw))
    got = getattr(t_gl, fn)(torch.from_numpy(feat), *args, **kw,
                            angles=torch.from_numpy(angles)).numpy()
    assert got.shape == want.shape and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# -------------------------------------------------------------------- metrics


def _tone(freq, n_sec=0.6, noise=0.0, seed=0):
    t = np.arange(int(SR * n_sec)) / SR
    rng = np.random.RandomState(seed)
    return (0.5 * np.sin(2 * np.pi * freq * t)
            + noise * rng.randn(len(t))).astype(np.float32)


@pytest.mark.parametrize("case", ["identity", "orders_distortion", "dtw_offset",
                                  "dtw_path", "different_content"])
def test_metrics_match_jax(case):
    """The cases of ``tests/test_metrics.py``, through both copies."""
    if case == "dtw_path":
        cost = np.random.RandomState(0).rand(10, 14)
        for a, b in zip(t_metrics.dtw_path(cost), j_metrics.dtw_path(cost)):
            np.testing.assert_array_equal(a, b)
        return
    if case == "dtw_offset":
        a = _tone(300, n_sec=0.5)
        b = np.concatenate([np.zeros(1600, dtype=np.float32), a])
        fb = j_mel.mel_filterbank(SR, 1024, 80, 50.0, 8000.0)
        la, lb = (np.log(np.maximum(np.asarray(j_stft.stft_magnitude(
            jnp.asarray(w), 1024, 256, 1024)) @ fb.T, 1e-8)) for w in (a, b))
        for dtw in (True, False):
            assert (t_metrics.mel_cepstral_distortion(la, lb, use_dtw=dtw)
                    == j_metrics.mel_cepstral_distortion(la, lb, use_dtw=dtw))
        return
    pairs = {"identity": [(_tone(220), _tone(220))],
             "orders_distortion": [(_tone(220), _tone(220, noise=0.01, seed=1)),
                                   (_tone(220), _tone(220, noise=0.2, seed=2))],
             "different_content": [(_tone(150), _tone(600))]}[case]
    for a, b in pairs:
        want = j_metrics.mcd_between_wavs(a, b, SR)
        got = t_metrics.mcd_between_wavs(a, b, SR)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)

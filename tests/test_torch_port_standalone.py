"""The port's own copies of the JAX package's host-side modules against the
originals, on the CPU: the front-ends and the linguistic unit (symbol
strings and ids), the AM and vocoder loaders (every array of every batch for
one seed), the config loader and the YAML configs, the beta-binomial prior
and the weight converters. Everything here is exact: the copies must behave
identically.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from kantts_tpu import data as jdata
from kantts_tpu.data import data_types as j_types
from kantts_tpu.preprocess import audio_utils as j_au
from kantts_tpu.preprocess import se_processor as j_se
from kantts_tpu.preprocess import script_convertor as j_script
from kantts_tpu.text import lexicon_frontend as j_lexicon
from kantts_tpu.text import pinyin_frontend as j_pinyin
from kantts_tpu.text.ling_unit import KanTtsLinguisticUnit as JLingUnit
from kantts_tpu.text.ling_unit import get_fpdict as j_get_fpdict
from kantts_tpu.utils import config as jconfig
from kantts_tpu.utils import metrics as j_metrics
from kantts_tpu.utils import profiling as j_profiling
from kantts_tpu.utils import torch_convert as jconvert
from kantts_tpu_torch.bin.train_hifigan import VocLoader
from kantts_tpu_torch.configs import get_config
from kantts_tpu_torch.data import data_types as t_types
from kantts_tpu_torch.data import dataset as tdata
from kantts_tpu_torch.models.builder import (
    build_sambert,
    build_sybert,
    hifigan_model_builder,
    sambert_params,
    sybert_params,
)
from kantts_tpu_torch.models.hifigan.discriminators import (
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
)
from kantts_tpu_torch.preprocess import audio_utils as t_au
from kantts_tpu_torch.preprocess import script_convertor as t_script
from kantts_tpu_torch.preprocess import se_processor as t_se
from kantts_tpu_torch.text import lexicon_frontend as t_lexicon
from kantts_tpu_torch.text import pinyin_frontend as t_pinyin
from kantts_tpu_torch.text.ling_unit import KanTtsLinguisticUnit, get_fpdict
from kantts_tpu_torch.utils import config as tconfig
from kantts_tpu_torch.utils import convert as tconvert
from kantts_tpu_torch.utils import metrics as t_metrics
from kantts_tpu_torch.utils import profiling as t_profiling
from kantts_tpu_torch.utils import torch_convert as tconvert_fwd
from kantts_tpu_torch.utils.audio import save_wav
from kantts_tpu_torch.utils.corpus import (
    write_mas_corpus,
    write_voc_corpus,
    write_voice_dir,
)
from test_sambert import TINY
from test_torch_port_hifigan import small_generator_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "kantts_tpu", "configs")
PINYIN_LINES = [  # the lines chip_smoke.py synthesizes
    "ni3 hao3 , huan1 ying2 lai2 dao4 bei3 jing1 .",
    "jin1 tian1 tian1 qi4 hen3 hao3 , wo3 men5 qu4 gong1 yuan2 san4 bu4 ba5 .",
    "zhe4 shi4 yi2 ge4 yu3 yin1 he2 cheng2 de5 ce4 shi4 .",
    "qing3 zai4 shuo1 yi2 bian4 , xie4 xie5 ."]
HANZI_LINES = ["你好，世界。", "今天天气很好，我们去公园散步吧。",
               "这是一个语音合成的测试。", "请再说一遍，谢谢。"]


def _ids(ling_unit, seq):
    return [a.tolist() for a in ling_unit.encode_symbol_sequence(seq)]


@pytest.mark.parametrize("line", PINYIN_LINES)
def test_pinyin_frontend_symbols_and_ids(line):
    cfg = get_config("sambert_16k_MAS")
    got = t_pinyin.text_to_symbols([line])
    want = j_pinyin.text_to_symbols([line])
    assert got == want and got[0]
    t_unit, j_unit = KanTtsLinguisticUnit(cfg), JLingUnit(cfg)
    for seq in got[0]:
        assert _ids(t_unit, seq) == _ids(j_unit, seq)


@pytest.mark.parametrize("line", HANZI_LINES + ["ni3 hao3 , 世界 ."])
def test_lexicon_frontend_symbols(line):
    assert (t_lexicon.make_frontend().text_to_symbols([line])
            == j_lexicon.make_frontend().text_to_symbols([line]))


@pytest.mark.parametrize("name", ["sambert_16k_MAS", "sambert_sichuan_16k",
                                  "sambert_16k_MAS_byte"])
def test_ling_unit_vocabularies(name):
    cfg = jconfig.load_yaml(os.path.join(CONFIGS, f"{name}.yaml"))
    t_unit, j_unit = KanTtsLinguisticUnit(cfg), JLingUnit(cfg)
    assert t_unit.get_unit_size() == j_unit.get_unit_size()
    for lfeat in t_unit.lfeat_type_list:
        assert t_unit.pad_id(lfeat) == j_unit.pad_id(lfeat)
        assert t_unit.vocabs[lfeat].symbols == j_unit.vocabs[lfeat].symbols


@pytest.mark.parametrize("name", ["sambert_16k_MAS", "sambert_fp_8k", "sybert",
                                  "sambert_16k_MAS_byte"])
def test_ling_unit_decode_mask_and_fpdict(name):
    """The decoding half, the special ids and the FP filler triples."""
    cfg = jconfig.load_yaml(os.path.join(CONFIGS, f"{name}.yaml"))
    t_unit, j_unit = KanTtsLinguisticUnit(cfg), JLingUnit(cfg)
    for lfeat in t_unit.lfeat_type_list:
        assert (t_unit.eos_id(lfeat), t_unit.mask_id(lfeat)) == (
            j_unit.eos_id(lfeat), j_unit.mask_id(lfeat))
    seq = ("{63$emotion_neutral$F7} {97$emotion_neutral$F7}" if t_unit.using_byte()
           else "{ni_c$tone3$s_begin$word_begin$emotion_neutral$F7} "
                "{#1$tone_none$s_none$word_none$emotion_happy$F7}")
    ids = t_unit.encode_symbol_sequence(seq)
    assert t_unit.decode_symbol_sequence(ids) == j_unit.decode_symbol_sequence(ids)
    if not t_unit.using_byte():
        got, want = get_fpdict(cfg), j_get_fpdict(cfg)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", ["sambert_16k_MAS", "hifigan_v1_16k"])
def test_load_merged_config(name, tmp_path):
    write_mas_corpus(str(tmp_path), 2, (3, 4), (8, 10), seed=0)
    path = os.path.join(CONFIGS, f"{name}.yaml")
    assert (tconfig.load_merged_config(str(tmp_path), path)
            == jconfig.load_merged_config(str(tmp_path), path))


@pytest.mark.parametrize("name", ["sambert_16k_MAS", "hifigan_v1_16k",
                                  "hifigan_noncausal_v1_16k", "hifigan_v1_nsf_24k",
                                  "hifigan_noncausal_nsf_v1_16k",
                                  "hifigan_noncausal_nsf_global_v1_16k",
                                  "sambert_nsf_16k", "sambert_nsf_24k",
                                  "sambert_16k_MAS_byte",
                                  "sambert_se_nsf_global_16k", "audio_config_24k",
                                  "sambert_fp_8k", "sybert", "hifigan_v1_8k",
                                  "audio_config_8k", "audio_config_16k",
                                  "audio_config_se_16k", "audio_config_48k",
                                  "hifigan_v1_24k", "hifigan_v1_48k", "sambert_16k",
                                  "sambert_24k", "sambert_48k",
                                  "sambert_sichuan_16k"])
def test_config_copies_equal_the_originals(name):
    """The port's copies of the JAX package's YAML configs, all 24."""
    copy = os.path.join(ROOT, "kantts_tpu_torch", "resources", "configs", f"{name}.yaml")
    with open(copy, "rb") as f, open(os.path.join(CONFIGS, f"{name}.yaml"), "rb") as g:
        assert f.read() == g.read()


def test_byte_symbols_and_ids(tmp_path):
    """``turn_text_into_bytes`` on hanzi lines (and one ending in '?', which
    gets no full stop), and the byte voice's ids of its output."""
    text = tmp_path / "text.txt"
    text.write_text("".join(f"{i}\t{line}\n" for i, line in
                            enumerate(HANZI_LINES + ["ni hao?"])), encoding="utf-8")
    outs = [tmp_path / "port.lst", tmp_path / "jax.lst"]
    t_script.turn_text_into_bytes(str(text), str(outs[0]), "F7")
    j_script.TextScriptConvertor.turn_text_into_bytes(str(text), str(outs[1]), "F7")
    got = outs[0].read_text(encoding="utf-8")
    assert got == outs[1].read_text(encoding="utf-8")
    cfg = jconfig.load_yaml(os.path.join(CONFIGS, "sambert_16k_MAS_byte.yaml"))
    t_unit, j_unit = KanTtsLinguisticUnit(cfg), JLingUnit(cfg)
    assert t_unit.using_byte() and t_unit.get_unit_size() == j_unit.get_unit_size()
    lines = got.splitlines()
    assert len(lines) == 5 and lines[-1].endswith("{63$emotion_neutral$F7}")
    for line in lines:
        seq = line.split("\t")[1]
        assert _ids(t_unit, seq) == _ids(j_unit, seq)


def test_beta_binomial_prior():
    for p, m in ((7, 30), (40, 257)):
        np.testing.assert_array_equal(tdata.beta_binomial_prior_distribution(p, m),
                                      jdata.beta_binomial_prior_distribution(p, m))


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert g.keys() == w.keys()
            g, w = [g[k] for k in w], list(w.values())
        for a, b in zip(g, w):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_am_batches(num_workers, tmp_path):
    """Two copies of one MAS corpus, the port's loader on one and the JAX
    package's on the other: the same split and every batch of two epochs."""
    roots = [str(tmp_path / "port"), str(tmp_path / "jax")]
    for root in roots:
        write_mas_corpus(root, 14, (5, 9), (20, 40), seed=4)
    model_yaml = os.path.join(CONFIGS, "sambert_16k_MAS.yaml")
    loaders = []
    for mod, root in zip((tdata, jdata), roots):
        config = dict(jconfig.load_merged_config(root, model_yaml), batch_size=3)
        train, valid = mod.get_am_datasets(
            [os.path.join(root, "raw_metafile.txt")], [root], config,
            input_bucket=16, frame_bucket=12)
        sampler = mod.DistributedSampler(len(train), shuffle=True)
        loaders.append((mod.DataLoader(train, 3, sampler=sampler,
                                       num_workers=num_workers), sampler, valid))
    for name in ("am_train.lst", "am_valid.lst"):
        with open(os.path.join(roots[0], name)) as f, \
                open(os.path.join(roots[1], name)) as g:
            assert f.read() == g.read()
    (t_loader, t_sampler, t_valid), (j_loader, j_sampler, j_valid) = loaders
    for epoch in range(2):
        t_sampler.set_epoch(epoch)
        j_sampler.set_epoch(epoch)
        _assert_batches_equal(t_loader, j_loader)
    _assert_batches_equal([t_valid.collate_fn([t_valid[i] for i in range(len(t_valid))])],
                          [j_valid.collate_fn([j_valid[i] for i in range(len(j_valid))])])


def test_voc_batches(tmp_path):
    """The vocoder loaders' crops from one seed, as train_hifigan draws them."""
    roots = [str(tmp_path / "port"), str(tmp_path / "jax")]
    for root in roots:
        write_voc_corpus(root, 8, (0.3, 0.5), seed=5)
    with open(os.path.join(CONFIGS, "hifigan_v1_16k.yaml")) as f:
        model_cfg = yaml.safe_load(f)
    batches = []
    for mod, root in zip((tdata, jdata), roots):
        config = dict(jconfig.load_merged_config(root, os.path.join(
            CONFIGS, "hifigan_v1_16k.yaml")), batch_size=2, batch_max_steps=1200)
        config["Model"] = model_cfg["Model"]
        train, _ = mod.get_voc_datasets(config, [root])
        sampler = mod.DistributedSampler(len(train), shuffle=True)
        if mod is tdata:
            loader = VocLoader(train, 2, sampler, seed=7)
        else:
            rng = np.random.RandomState(7)
            loader = mod.DataLoader(train, 2, sampler,
                                    collate_fn=lambda b, ds=train: ds.collate_fn(b, rng))
        batches.append([b for _ in range(2) for b in loader])
    _assert_batches_equal(*batches)


def _random_state_dict(module, seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*v.shape).astype(np.float32)
            for k, v in module.state_dict().items()}


def _trees_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _trees_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def _round_trip(sd, back):
    """The port's inverse of the converter gives the state dict back."""
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("voice", ["phones", "byte", "se", "fp"])
def test_convert_sambert_round_trip(voice):
    """The forward converter and its inverse, for a phone MAS voice, a byte
    voice (``byte_index_emb``), an SE voice (no speaker table) and an FP
    voice (``FP_predictor``)."""
    name = {"phones": "sambert_16k_MAS", "byte": "sambert_16k_MAS_byte",
            "se": "sambert_se_nsf_global_16k", "fp": "sambert_fp_8k"}[voice]
    cfg = jconfig.load_yaml(os.path.join(CONFIGS, f"{name}.yaml"))
    flags = {"phones": dict(MAS=True), "byte": dict(MAS=True, using_byte=True),
             "se": dict(SE=True), "fp": dict(FP=True)}[voice]
    cfg["Model"]["KanTtsSAMBERT"]["params"] = dict(TINY, num_mels=80, **flags)
    params = sambert_params(cfg)
    sd = _random_state_dict(build_sambert(cfg), 0)
    tree = jconvert.convert_sambert(sd, params)
    _trees_equal(tconvert_fwd.convert_sambert(sd, params), tree)
    _round_trip(sd, tconvert.sambert_state_dict_from_jax(tree, params))


def test_convert_sybert_round_trip():
    """Textsy-BERT: the text encoder without ``ling_proj``, and ``fc``."""
    cfg = jconfig.load_yaml(os.path.join(CONFIGS, "sybert.yaml"))
    params = cfg["Model"]["KanTtsTextsyBERT"]["params"]
    params.update({k: TINY[k] for k in params if k in TINY})
    sd = _random_state_dict(build_sybert(cfg), 6)
    tree = jconvert.convert_sybert(sd, sybert_params(cfg))
    _trees_equal(tconvert_fwd.convert_sybert(sd, sybert_params(cfg)), tree)
    assert "ling_proj" not in tree["text_encoder"] and "fc" in tree
    _round_trip(sd, tconvert.sybert_state_dict_from_jax(tree, sybert_params(cfg)))


def test_convert_hifigan_generator_round_trip():
    cfg = get_config("hifigan_v1_16k")
    cfg["Model"]["Generator"]["params"] = small_generator_cfg()
    sd = _random_state_dict(hifigan_model_builder(cfg), 1)
    tree = jconvert.convert_hifigan_generator(sd, small_generator_cfg())
    _trees_equal(tconvert_fwd.convert_hifigan_generator(sd, small_generator_cfg()),
                 tree)
    _round_trip(sd, tconvert.hifigan_state_dict_from_jax(tree, small_generator_cfg()))


MPD_CFG = {"periods": (2, 3),
           "discriminator_params": {"channels": 4, "max_downsample_channels": 8,
                                    "downsample_scales": [3, 3, 1]}}
MSD_CFG = {"discriminator_params": {"channels": 16, "max_downsample_channels": 32,
                                    "max_groups": 4, "downsample_scales": [2, 2, 1]},
           "follow_official_norm": False}


def test_convert_discriminators_round_trip():
    """MPD (weight norm) and MSD (weight norm, DWT), at narrow widths."""
    mpd, msd = MultiPeriodDiscriminator(**MPD_CFG), MultiScaleDiscriminator(**MSD_CFG)
    periods = [d.period for d in mpd.discriminators]
    n_mpd = len(mpd.discriminators[0].convs)
    sd = _random_state_dict(mpd, 2)
    tree = jconvert.convert_mpd(sd, periods, n_mpd)
    _trees_equal(tconvert_fwd.convert_mpd(sd, periods, n_mpd), tree)
    _round_trip(sd, tconvert.mpd_state_dict_from_jax(tree, MPD_CFG))
    scales, n_msd = len(msd.discriminators), len(msd.discriminators[0].convs) - 2
    sd = _random_state_dict(msd, 3)
    tree = jconvert.convert_msd(sd, scales, n_msd, msd.dwt)
    _trees_equal(tconvert_fwd.convert_msd(sd, scales, n_msd, msd.dwt), tree)
    _round_trip(sd, tconvert.msd_state_dict_from_jax(tree, MSD_CFG))


def test_pitch_source_is_a_byte_copy():
    with open(os.path.join(ROOT, "kantts_tpu_torch", "native", "pitch.cpp"), "rb") as f, \
            open(os.path.join(ROOT, "kantts_tpu", "native", "pitch.cpp"), "rb") as g:
        assert f.read() == g.read()


def _equal(got, want):
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _interval_file(tmp_path):
    write_voice_dir(str(tmp_path / "voice"), 1, (2.0, 2.5), seed=3)
    return str(tmp_path / "voice" / "interval" / "utt0000.interval")


AUDIO_UTILS_CASES = {
    "trim_silence": lambda mod, rng, tmp: mod.trim_silence(
        np.concatenate([np.zeros(3000), 0.4 * rng.randn(9000), 1e-4 * rng.randn(2500)]
                       ).astype(np.float32), 40, 200, 1000),
    "trim_silence_with_interval": lambda mod, rng, tmp: [mod.trim_silence_with_interval(
        rng.randn(4000).astype(np.float32), d, 200) for d in
        (np.array([3, 5, 2]), np.array([0, 5, 0]), None)],
    "interp_f0": lambda mod, rng, tmp: mod.interp_f0(
        np.where(rng.rand(50) < 0.3, 0.0, rng.uniform(80, 300, 50)).astype(np.float32)),
    "smooth": lambda mod, rng, tmp: [mod.smooth(rng.randn(40), w) for w in (4, 5)],
    "align_length": lambda mod, rng, tmp: [mod.align_length(
        rng.randn(n, 1), np.zeros((100, 80)), "u") for n in (90, 100, 113, 121)],
    "compute_mean_std": lambda mod, rng, tmp: mod.compute_mean_std(
        [rng.randn(30, 4), None, rng.randn(7, 4) + 2], dims=4),
    "norm_mean_std": lambda mod, rng, tmp: [
        mod.f0_norm_mean_std(np.where(rng.rand(20, 1) < 0.3, 0.0, rng.randn(20, 1)),
                             np.array([[0.5]]), np.array([[2.0]])),
        mod.norm_mean_std(rng.randn(6, 3), rng.randn(1, 3), rng.rand(1, 3) + 0.5)],
    "parse_interval_file": lambda mod, rng, tmp: mod.parse_interval_file(
        _interval_file(tmp), 16000, 200),
    "average_by_duration": lambda mod, rng, tmp: [mod.average_by_duration(
        np.where(rng.rand(30) < 0.2, 0.0, rng.randn(30)), np.array([4, 0, 10, 16])),
        mod.average_by_duration(None, np.array([1]))],
    "encode_16bits": lambda mod, rng, tmp: [mod.encode_16bits(
        (0.5 * rng.randn(100)).clip(-0.99, 0.99)), mod.encode_16bits(rng.randn(5) * 3)],
}


@pytest.mark.parametrize("case", sorted(AUDIO_UTILS_CASES))
def test_audio_utils_copy_is_exact(case, tmp_path):
    results = [AUDIO_UTILS_CASES[case](mod, np.random.RandomState(11), tmp_path)
               for mod in (t_au, j_au)]
    _equal(*results)


def test_volume_normalize_copy_is_exact(tmp_path):
    """The corpus RMS histogram matched to the anchor table: the same int16
    samples, and the same amplitude statistics."""
    rng = np.random.RandomState(12)
    src = tmp_path / "src"
    src.mkdir()
    for i in range(7):
        save_wav(np.exp(rng.uniform(-3, -0.5)) * np.sin(np.arange(8000) * 0.05 * (i + 1)),
                 str(src / f"u{i}.wav"), 16000)
    for mod, out in ((t_au, "port"), (j_au, "jax")):
        assert mod.volume_normalize(str(src), str(tmp_path / out), 2)
    for i in range(7):
        infos = [mod.amp_info(str(tmp_path / out / f"u{i}.wav"))
                 for mod, out in ((t_au, "port"), (j_au, "jax"))]
        assert infos[0] == infos[1]
        with open(tmp_path / "port" / f"u{i}.wav", "rb") as f, \
                open(tmp_path / "jax" / f"u{i}.wav", "rb") as g:
            assert f.read() == g.read()


def test_data_types_copy_is_exact(tmp_path):
    rng = np.random.RandomState(13)
    (tmp_path / "a.txt").write_text("x y\nz\n", encoding="utf-8")
    save_wav(0.3 * rng.randn(500), str(tmp_path / "a.wav"), 16000)
    np.save(tmp_path / "a.npy", rng.randn(3, 4))
    rng.randn(9).astype(np.float32).tofile(tmp_path / "a.bin")
    assert sorted(t_types.DATA_TYPE_DICT) == sorted(j_types.DATA_TYPE_DICT)
    for ext in t_types.DATA_TYPE_DICT:
        path = str(tmp_path / f"a.{ext}")
        _equal(t_types.get_loader(ext)(path), j_types.get_loader(ext)(path))
    for mod in (t_types, j_types):
        with pytest.raises(KeyError, match="no loader registered for .flac"):
            mod.get_loader("flac")


def test_metrics_numpy_copy_is_exact():
    rng = np.random.RandomState(14)
    a, b = rng.randn(23, 80), rng.randn(31, 80)
    _equal(t_metrics.mel_cepstrum(a, 13), j_metrics.mel_cepstrum(a, 13))
    cost = rng.rand(9, 12)
    _equal(t_metrics.dtw_path(cost), j_metrics.dtw_path(cost))
    for dtw in (True, False):
        assert (t_metrics.mel_cepstral_distortion(a, b, 10, dtw)
                == j_metrics.mel_cepstral_distortion(a, b, 10, dtw))


@pytest.mark.parametrize("audio,wall", [(5.0, 0.25), (1e-12, 0.5), (3.2, 0.0)])
def test_rtf_report_copy_is_exact(audio, wall, caplog):
    with caplog.at_level("INFO"):
        got = t_profiling.rtf_report(audio, wall, "vocoder")
        want = j_profiling.rtf_report(audio, wall, "vocoder")
    assert got == want
    assert [r.getMessage() for r in caplog.records][-2:] == [
        caplog.records[-1].getMessage()] * 2


@pytest.mark.parametrize("sr,bins,n", [(16000, 80, 4000), (8000, 40, 1234),
                                       (16000, 80, 300)])
def test_kaldi_fbank_copy_is_exact(sr, bins, n):
    wav = (0.3 * np.random.RandomState(n).randn(n)).astype(np.float32)
    _equal(t_se.kaldi_fbank(wav, sr, bins), j_se.kaldi_fbank(wav, sr, bins))


@pytest.mark.parametrize("voice", ["erhua", "fp", "prosody"])
def test_text_script_convertor(voice, tmp_path):
    """Script.xml and the metafile from a prosody file: lines with erhua,
    a neutral tone and '/' word groups, a voice with FP annotation blocks,
    and a plain synthetic voice."""
    prosody = tmp_path / "prosody.txt"
    if voice == "erhua":
        prosody.write_text("utt001\t这儿#2你好#4\n\tzher4 ni3 hao3\n"
                           "utt002\t这是#1测试#3句子\n\tzhe4 shi4 / ce4 shi4 / jv4 zi5\n",
                           encoding="utf-8")
    else:
        write_voice_dir(str(tmp_path / "voice"), 4, (2.0, 3.0), seed=15, mode=voice)
        prosody = tmp_path / "voice" / "prosody" / "prosody.txt"
    outs = []
    for side, mod in (("port", t_script), ("jax", j_script)):
        tsc = mod.TextScriptConvertor("PinYin", "EnUS", None, "F7")
        xml, meta = tmp_path / f"{side}.xml", tmp_path / f"{side}.txt"
        tsc.process(str(prosody), str(xml), str(meta))
        outs.append((xml.read_bytes(), meta.read_text(encoding="utf-8")))
    assert outs[0] == outs[1]
    assert len(outs[0][1].splitlines()) == (2 if voice == "erhua" else 4)


def test_new_modules_import_without_jax():
    """The preprocessing, data-parallel, tensor/pipeline-parallel, int8,
    export and tooling modules import with JAX and the JAX package made
    unimportable."""
    code = ("import sys\n"
            "for name in ('jax', 'flax', 'optax', 'kantts_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import kantts_tpu_torch.bin.process_data, kantts_tpu_torch.data.data_types\n"
            "import kantts_tpu_torch.dsp.griffin_lim, kantts_tpu_torch.native.pitch\n"
            "import kantts_tpu_torch.preprocess.se_processor\n"
            "import kantts_tpu_torch.utils.metrics\n"
            "import kantts_tpu_torch.parallel.mesh, kantts_tpu_torch.bin.train_sybert\n"
            "import kantts_tpu_torch.parallel.tp, kantts_tpu_torch.parallel.pp\n"
            "import kantts_tpu_torch.ops.int8_conv, kantts_tpu_torch.infer.exported\n"
            "import kantts_tpu_torch.infer.symbols, kantts_tpu_torch.bin.export_tts\n"
            "import kantts_tpu_torch.bin.infer_hifigan, kantts_tpu_torch.bin.serve_tts\n"
            "import kantts_tpu_torch.utils.profiling, kantts_tpu_torch.utils.plot\n"
            "import kantts_tpu_torch.train.trainer\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]

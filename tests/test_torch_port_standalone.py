"""The port's own copies of the JAX package's host-side modules against the
originals, on the CPU: the front-ends and the linguistic unit (symbol
strings and ids), the AM and vocoder loaders (every array of every batch for
one seed), the config loader, the beta-binomial prior and the weight
converters. Everything here is exact: the copies must behave identically.
"""

import os

import numpy as np
import pytest
import yaml

from kantts_tpu import data as jdata
from kantts_tpu.text import lexicon_frontend as j_lexicon
from kantts_tpu.text import pinyin_frontend as j_pinyin
from kantts_tpu.text.ling_unit import KanTtsLinguisticUnit as JLingUnit
from kantts_tpu.utils import config as jconfig
from kantts_tpu.utils import torch_convert as jconvert
from kantts_tpu_torch.bin.train_hifigan import VocLoader
from kantts_tpu_torch.configs import get_config
from kantts_tpu_torch.data import dataset as tdata
from kantts_tpu_torch.models.builder import (
    build_sambert,
    hifigan_model_builder,
    sambert_params,
)
from kantts_tpu_torch.models.hifigan.discriminators import (
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
)
from kantts_tpu_torch.text import lexicon_frontend as t_lexicon
from kantts_tpu_torch.text import pinyin_frontend as t_pinyin
from kantts_tpu_torch.text.ling_unit import KanTtsLinguisticUnit
from kantts_tpu_torch.utils import config as tconfig
from kantts_tpu_torch.utils import convert as tconvert
from kantts_tpu_torch.utils import torch_convert as tconvert_fwd
from kantts_tpu_torch.utils.corpus import write_mas_corpus, write_voc_corpus
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


@pytest.mark.parametrize("name", ["sambert_16k_MAS", "sambert_sichuan_16k"])
def test_ling_unit_vocabularies(name):
    cfg = jconfig.load_yaml(os.path.join(CONFIGS, f"{name}.yaml"))
    t_unit, j_unit = KanTtsLinguisticUnit(cfg), JLingUnit(cfg)
    assert t_unit.get_unit_size() == j_unit.get_unit_size()
    for lfeat in t_unit.lfeat_type_list:
        assert t_unit.pad_id(lfeat) == j_unit.pad_id(lfeat)
        assert t_unit.vocabs[lfeat].symbols == j_unit.vocabs[lfeat].symbols


@pytest.mark.parametrize("name", ["sambert_16k_MAS", "hifigan_v1_16k"])
def test_load_merged_config(name, tmp_path):
    write_mas_corpus(str(tmp_path), 2, (3, 4), (8, 10), seed=0)
    path = os.path.join(CONFIGS, f"{name}.yaml")
    assert (tconfig.load_merged_config(str(tmp_path), path)
            == jconfig.load_merged_config(str(tmp_path), path))


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


def test_convert_sambert_round_trip():
    cfg = get_config("sambert_16k_MAS")
    cfg["Model"]["KanTtsSAMBERT"]["params"] = dict(TINY, num_mels=80, MAS=True)
    params = sambert_params(cfg)
    sd = _random_state_dict(build_sambert(cfg), 0)
    tree = jconvert.convert_sambert(sd, params)
    _trees_equal(tconvert_fwd.convert_sambert(sd, params), tree)
    _round_trip(sd, tconvert.sambert_state_dict_from_jax(tree, params))


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

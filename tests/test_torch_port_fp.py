"""Filled pauses (FP) in the PyTorch port against the JAX package, on the
CPU at TINY widths: the host-side plan and its copies (``fp.py``,
``get_fpdict``, ``get_fp_label``, ``fp_processor``), the FP collate, the FP
forward with a plan, ``FpCELoss``, the gradients of an FP train step,
``sambert_infer_fp`` and the bf16 dtype census of an FP forward.

The same weights (the port's, seeded, moved to JAX by the JAX package's
converter) and the same numpy inputs go through both packages, dropout off.
Tolerances: host-side results exactly; ``fp_predictions`` atol 1e-5; mels
atol 2e-4 (the SAM-BERT forward's: a deep float32 decode and postnet that
reassociate sums differently); ``FpCELoss`` rtol 1e-6; the total loss rtol
1e-5 and each gradient leaf max|diff| <= 1e-4 * max|g|.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from kantts_tpu import losses as jl
from kantts_tpu.data import dataset as jdata
from kantts_tpu.models.sambert import fp as jfp
from kantts_tpu.models.sambert.sambert import KanTtsSAMBERT as JSAMBERT
from kantts_tpu.models.sambert.sambert import sambert_infer_fp as j_sambert_infer_fp
from kantts_tpu.preprocess.fp_processor import FpProcessor as JFpProcessor
from kantts_tpu.text.ling_unit import get_fpdict as j_get_fpdict
from kantts_tpu.utils import config as jconfig
from kantts_tpu.utils.torch_convert import convert_sambert
from kantts_tpu_torch.data import dataset as tdata
from kantts_tpu_torch.losses import criterion_builder
from kantts_tpu_torch.losses import losses as tl
from kantts_tpu_torch.models.builder import build_sambert, sambert_params
from kantts_tpu_torch.models.sambert import fp as tfp
from kantts_tpu_torch.models.sambert.sambert import sambert_infer_fp
from kantts_tpu_torch.preprocess.fp_processor import FpProcessor
from kantts_tpu_torch.text.ling_unit import get_fpdict
from kantts_tpu_torch.train.optim import optimizer_builder
from kantts_tpu_torch.train.steps import make_sambert_step, sambert_forward, sambert_losses
from kantts_tpu_torch.utils.corpus import write_fp_corpus
from test_sambert import TINY
from test_torch_port_bf16 import TorchCensus, jax_census

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "kantts_tpu", "configs")
FP_LOSSES = {
    "MelReconLoss": {"enable": True, "params": {"loss_type": "mae"}},
    "ProsodyReconLoss": {"enable": True, "params": {"loss_type": "mae"}},
    "FpCELoss": {"enable": True, "params": {"loss_type": "ce",
                                            "weight": [1, 4, 4, 8]}},
}


def fp_config(**params):
    """sambert_fp_8k.yaml at TINY widths (its FP flag, 80 mels and
    linguistic unit kept), with the FP losses."""
    cfg = jconfig.load_yaml(os.path.join(CONFIGS, "sambert_fp_8k.yaml"))
    cfg["Model"]["KanTtsSAMBERT"]["params"] = dict(TINY, FP=True, num_mels=80,
                                                   **params)
    cfg["Loss"] = dict(FP_LOSSES)
    return cfg


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fp_corpus"))
    write_fp_corpus(root, 12, (5, 9), (30, 50), seed=3)
    return root


def _datasets(corpus, mod):
    config = dict(jconfig.load_merged_config(
        corpus, os.path.join(CONFIGS, "sambert_fp_8k.yaml")))
    config["Model"]["KanTtsSAMBERT"]["params"] = dict(TINY, FP=True)
    return mod.get_am_datasets([os.path.join(corpus, "raw_metafile.txt")], [corpus],
                               config, input_bucket=8, frame_bucket=12)


@pytest.fixture(scope="module")
def batch(corpus):
    """The port's collate of the whole FP training set, as numpy."""
    train, _ = _datasets(corpus, tdata)
    return train.collate_fn([train[i] for i in range(len(train))]), train.fp_dict_lings


@pytest.fixture(scope="module")
def models():
    """-> pair(bf16) -> (port model, JAX model, JAX params): one seeded set
    of weights, the port's, with the duration head's bias at 1.0."""
    made = {}

    def pair(bf16: bool = False):
        if bf16 not in made:
            cfg = fp_config(dur_pred_bias_init=1.0)
            cfg["mixed_precision"] = bf16
            port = build_sambert(cfg, seed=0)
            params = sambert_params(cfg)
            made[bf16] = (port, JSAMBERT(params), convert_sambert(
                {k: v.numpy() for k, v in port.state_dict().items()}, params))
        return made[bf16]

    return pair


# ------------------------------------------------------------- host side


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_functions_match_jax(seed):
    rng = np.random.RandomState(seed)
    B, T_in = 4, 11
    probs = rng.rand(B, T_in, 4).astype(np.float32)
    lengths = rng.randint(1, T_in + 1, B)
    masks = np.arange(T_in)[None] >= lengths[:, None]
    classes = tfp.fp_classes_from_predictions(probs, masks)
    np.testing.assert_array_equal(classes, jfp.fp_classes_from_predictions(probs, masks))
    for out_len in (None, 12, 40):
        got = tfp.build_fp_insertion_plan(classes, lengths, out_len, bucket=8)
        want = jfp.build_fp_insertion_plan(classes, lengths, out_len, bucket=8)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    x = rng.randint(0, 9, (B, T_in))
    np.testing.assert_array_equal(tfp.extend_wraparound(x, 25),
                                  jfp.extend_wraparound(x, 25))


def test_apply_fp_insertion_matches_jax():
    rng = np.random.RandomState(4)
    classes = rng.randint(0, 4, (3, 9)) * (rng.rand(3, 9) < 0.3)
    lengths = np.array([9, 6, 2])
    src, f_cls, f_ph, _, _ = tfp.build_fp_insertion_plan(classes, lengths, bucket=8)
    text = rng.randn(3, 9, 5).astype(np.float32)
    bank = rng.randn(3, 3, 5).astype(np.float32)
    got = tfp.apply_fp_insertion(*(torch.from_numpy(a) for a in
                                   (text, bank, src, f_cls, f_ph)))
    want = jfp.apply_fp_insertion(*(jnp.asarray(a) for a in
                                    (text, bank, src, f_cls, f_ph)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (f_cls > 0).any()


def test_get_fpdict_matches_jax():
    cfg = fp_config()
    got, want = get_fpdict(cfg), j_get_fpdict(cfg)
    assert got.keys() == want.keys() == {1, 2, 3}
    for k in want:
        assert got[k].shape == (3, 4)
        np.testing.assert_array_equal(got[k], want[k])


TOKEN = "{%s$tone3$%s$%s$emotion_neutral$F7}"
BASE = [TOKEN % (p, f, w) for p, f, w in (
    ("n_c", "s_begin", "word_begin"), ("i_c", "s_end", "word_end"),
    ("h_c", "s_begin", "word_begin"), ("ao_c", "s_end", "word_end"),
    ("b_c", "s_begin", "word_begin"), ("a_c", "s_end", "word_end"))]


def _filler(onset, coda):
    return [f"{{{onset}$tone5$s_begin$word_begin$emotion_disgust$F7}}",
            f"{{{coda}$tone5$s_end$word_end$emotion_disgust$F7}}",
            "{#3$tone_none$s_none$word_none$emotion_neutral$F7}"]


@pytest.mark.parametrize("places", [(0,), (2,), (6,), (2, 4), (0, 6)],
                         ids=["start", "middle", "end", "two_middle", "start_end"])
def test_get_fp_label_matches_jax(places):
    tokens = []
    for j in range(len(BASE) + 1):
        if j in places:
            tokens += _filler(*(("ga", "a_c"), ("ge", "en_c"), ("ge", "e_c"))[j % 3])
        if j < len(BASE):
            tokens.append(BASE[j])
    line = " ".join(tokens)
    got = tdata.get_fp_label(line)
    np.testing.assert_array_equal(got, jdata.get_fp_label(line))
    assert len(got) == len(BASE) + 1 and (got > 0).sum() == len(places)


def _prosody_corpus(root, n=8, seed=5):
    """A seeded prosody file (FP annotation blocks and plain pron lines) and
    its raw metafile lines."""
    rng = np.random.RandomState(seed)
    prosody, raw = [], []
    for i in range(n):
        name = f"utt{i:03d}"
        n_syl = rng.randint(3, 8)
        tokens = []
        for _ in range(n_syl):
            emo = ("emotion_neutral", "emotion_happy")[rng.randint(2)]
            if rng.rand() < 0.5:
                tokens.append(TOKEN.replace("emotion_neutral", emo)
                              % ("a_c", "s_both", "word_both"))
            else:
                tokens += [TOKEN.replace("emotion_neutral", emo) % (p, f, w) for p, f, w
                           in (("g_c", "s_begin", "word_begin"),
                               ("ai_c", "s_end", "word_end"))]
            if rng.rand() < 0.3:
                tokens.append("{#1$tone_none$s_none$word_none$emotion_neutral$F7}")
        raw.append(f"{name}\t{' '.join(tokens)}\n")
        prosody.append(f"{name}\t#{i}\n")
        if i % 4 == 3:
            prosody.append(" ".join(["ni3"] * n_syl) + "\n")
        else:
            labels = rng.choice(["N", "FP", "I", "Q"], n_syl, p=[0.6, 0.2, 0.1, 0.1])
            prosody += [" ".join(labels) + "\n", "a\n", "b\n", "c\n"]
    path = os.path.join(root, "prosody.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.writelines(prosody)
    with open(os.path.join(root, "raw_metafile.txt"), "w", encoding="utf-8") as f:
        f.writelines(raw)
    return path, raw


def test_fp_processor_copy_matches_jax(tmp_path):
    """``addfp``, ``removefp`` and ``process`` (its shuffle seeded) write the
    same files in both packages."""
    prosody, raw = _prosody_corpus(str(tmp_path))
    outs = {}
    for name, proc in (("port", FpProcessor()), ("jax", JFpProcessor())):
        out = tmp_path / name
        out.mkdir()
        fpadd = proc.addfp(str(out), prosody, raw)
        proc.removefp(str(out), fpadd, raw)
        random.seed(9)
        (out / "shuffled").mkdir()
        proc.process(str(out / "shuffled"), prosody, str(tmp_path / "raw_metafile.txt"))
        outs[name] = {p: (out / p).read_text(encoding="utf-8") for p in
                      ("fpadd_metafile.txt", "fprm_metafile.txt",
                       "shuffled/fpadd_metafile.txt", "shuffled/fprm_metafile.txt")}
    assert outs["port"] == outs["jax"]
    assert "emotion_disgust" in outs["port"]["fpadd_metafile.txt"]
    assert "emotion_disgust" not in outs["port"]["fprm_metafile.txt"]


def test_fp_collate_matches_jax(corpus):
    """Every array of the FP batches, the plan and the durations padded to its
    length among them, on a corpus with fillers at the start, in the middle
    and at the end; then the metafiles both packages read."""
    (t_train, t_valid), (j_train, j_valid) = (_datasets(corpus, m) for m in (tdata, jdata))
    np.testing.assert_array_equal(t_train.fp_dict_lings, j_train.fp_dict_lings)
    for t_ds, j_ds in ((t_train, j_train), (t_valid, j_valid)):
        for idx in (list(range(min(3, len(t_ds)))), list(range(len(t_ds)))):
            got = t_ds.collate_fn([t_ds[i] for i in idx])
            want = j_ds.collate_fn([j_ds[i] for i in idx])
            assert got.keys() == want.keys()
            for key, value in want.items():
                if value is None:
                    assert got[key] is None, key
                    continue
                pairs = zip(got[key], value) if key == "fp_plan" else [(got[key], value)]
                for a, b in pairs:
                    assert a.dtype == b.dtype, key
                    np.testing.assert_array_equal(a, b, err_msg=key)
    b = t_train.collate_fn([t_train[i] for i in range(len(t_train))])
    src_idx, _, _, inter = b["fp_plan"]
    assert (inter > b["valid_input_lengths"]).any()
    assert b["durations"].shape[1] == src_idx.shape[1]
    assert (b["durations"].sum(1) == b["mel_targets"].shape[1]).all()


# ------------------------------------------------------------ the model


def _t(b):
    return {k: (tuple(torch.from_numpy(a) for a in v) if isinstance(v, tuple)
                else torch.from_numpy(v)) for k, v in b.items() if v is not None}


def _j(b):
    return {k: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple)
                else jnp.asarray(v)) for k, v in b.items() if v is not None}


def _j_forward(model, fp_dict_lings):
    def fwd(params, b):
        return model.apply(
            {"params": params}, b["input_lings"], b["input_emotions"],
            b["input_speakers"], b["valid_input_lengths"],
            b["valid_output_lengths"], b["mel_targets"],
            duration_targets=b["durations"], pitch_targets=b["pitch_contours"],
            energy_targets=b["energy_contours"], fp_label=b["fp_label"],
            fp_plan=b["fp_plan"], fp_dict_lings=jnp.asarray(fp_dict_lings),
            deterministic=True)
    return fwd


def _t_forward(model, b, fp_dict_lings):
    with torch.no_grad():
        return sambert_forward(model, _t(b),
                               fp_dict_lings=torch.from_numpy(fp_dict_lings))


def test_fp_forward_matches_jax(models, batch):
    b, fp_dict = batch
    port, jm, params = models()
    want = jax.jit(_j_forward(jm, fp_dict))(params, _j(b))
    got = _t_forward(port.eval(), b, fp_dict)
    np.testing.assert_allclose(got["fp_predictions"].numpy(),
                               np.asarray(want["fp_predictions"]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["valid_inter_lengths"].numpy(),
                                  np.asarray(want["valid_inter_lengths"]))
    for key in ("log_duration_predictions", "pitch_predictions"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5, rtol=0, err_msg=key)
    for key in ("dec_outputs", "postnet_outputs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=2e-4, rtol=0, err_msg=key)
    assert got["fp_predictions"].dtype == torch.float32


def test_fp_ce_loss_matches_jax():
    """The double softmax: cross-entropy over log_softmax of the
    probabilities, which -w * log(p) is not."""
    rng = np.random.RandomState(6)
    B, T = 3, 10
    p = rng.rand(B, T, 4).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    label = rng.randint(0, 4, (B, T))
    lengths = np.array([10, 7, 3])
    got = tl.FpCELoss(weight=[1, 4, 4, 8])(*(torch.from_numpy(a) for a in
                                            (lengths, p, label)))
    want = jl.FpCELoss(weight=[1, 4, 4, 8])(*(jnp.asarray(a) for a in
                                             (lengths, p, label)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    w = np.array([1, 4, 4, 8], np.float32)[label]
    valid = np.arange(T)[None] < lengths[:, None]
    log_p = (-w * np.log(np.take_along_axis(p, label[..., None], -1)[..., 0]))
    assert abs(float(got) - (log_p * valid).sum() / valid.sum()) > 0.1


def _zero_dropout(model: nn.Module) -> nn.Module:
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    return model.train()


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, np.asarray(v)


def test_fp_train_step_matches_jax(models, batch):
    """The gradients of the FP train step's total (mel, prosody over the
    spliced lengths, FP cross-entropy); then one step of
    ``make_sambert_step`` reports ``fp_loss``."""
    b, fp_dict = batch
    port, jm, params = models()
    j_crit = jl.criterion_builder({"Loss": FP_LOSSES})
    fwd = _j_forward(jm, fp_dict)

    def total(p, jb):
        res = fwd(p, jb)
        out = sum(j_crit["MelReconLoss"](jb["valid_output_lengths"], jb["mel_targets"],
                                         res["dec_outputs"], res["postnet_outputs"]))
        out += sum(j_crit["ProsodyReconLoss"](
            res["valid_inter_lengths"], res["duration_targets"], res["pitch_targets"],
            res["energy_targets"], res["log_duration_predictions"],
            res["pitch_predictions"], res["energy_predictions"]))
        return out + j_crit["FpCELoss"](jb["valid_input_lengths"],
                                        res["fp_predictions"], jb["fp_label"])

    j_loss, j_grads = jax.jit(jax.value_and_grad(total))(params, _j(b))
    model = build_sambert(fp_config(dur_pred_bias_init=1.0), seed=0)
    _zero_dropout(model)
    crit = criterion_builder({"Loss": FP_LOSSES})
    t_loss, metrics = sambert_losses(model, crit, _t(b), 0, False,
                                     fp_dict_lings=torch.from_numpy(fp_dict))
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
    assert float(metrics["fp_loss"]) > 0
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in model.named_parameters()}
    mapped = dict(_flat(convert_sambert(grads, model.config)))
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, j_grads)))
    assert mapped.keys() == want.keys()
    assert any(k.startswith("FP_predictor") for k in want)
    for key, g in want.items():
        scale = np.abs(g).max()
        diff = np.abs(mapped[key] - g).max()
        assert diff <= 1e-4 * scale, f"{key}: max|diff| {diff}, max|g| {scale}"

    optimizer, scheduler, clip = optimizer_builder(
        model.parameters(), {"type": "Adam", "params": {"lr": 1e-3}},
        {"type": "ConstantLR"}, 1.0)
    step = make_sambert_step(model, crit, optimizer, scheduler, clip, False,
                             fp_dict_lings=torch.from_numpy(fp_dict))
    out = step(_t(b), 0)
    assert np.isfinite(float(out["fp_loss"])) and "fp_loss" in out


def test_sambert_infer_fp_matches_jax(models, batch):
    """Classes and spliced lengths exactly; durations 1e-4; mels 2e-4."""
    b, fp_dict = batch
    port, jm, params = models()
    args = [b[k] for k in ("input_lings", "input_emotions", "input_speakers",
                           "valid_input_lengths")]
    budget = b["input_lings"].shape[1] * 12
    want = j_sambert_infer_fp(jm, {"params": params}, *(jnp.asarray(a) for a in args),
                              jnp.asarray(fp_dict), budget)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = sambert_infer_fp(port.eval(), *(torch.from_numpy(a).long() for a in args[:3]),
                           torch.from_numpy(args[3]), torch.from_numpy(fp_dict).long(),
                           budget)
    masks = np.arange(args[0].shape[1])[None] >= args[3][:, None]
    classes = tfp.fp_classes_from_predictions(got["fp_predictions"].numpy(), masks)
    np.testing.assert_array_equal(
        classes, jfp.fp_classes_from_predictions(want["fp_predictions"], masks))
    assert (classes > 0).any()
    np.testing.assert_array_equal(got["valid_inter_lengths"].numpy(),
                                  want["valid_inter_lengths"])
    np.testing.assert_allclose(got["duration_predictions"].numpy(),
                               want["duration_predictions"], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got["LR_length_rounded"].numpy(),
                                  want["LR_length_rounded"])
    for key in ("dec_outputs", "postnet_outputs"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=2e-4, rtol=0,
                                   err_msg=key)


def test_fp_dtype_census_matches_jax(models, batch):
    """With ``mixed_precision`` the FP forward's matmuls and convolutions by
    operand dtype, op for op as in the JAX jaxpr: the filler bank's encoder
    pass in bf16 like the text's, the FP predictor in float32."""
    b, fp_dict = batch
    port, jm, params = models(bf16=True)
    want = jax_census(jax.make_jaxpr(_j_forward(jm, fp_dict))(params, _j(b)))
    with TorchCensus(port) as got:
        _t_forward(port.eval(), b, fp_dict)
    assert dict(got.count) == want
    assert want["bfloat16"] > 0 and want["float32"] > 0
    assert all(p.dtype == torch.float32 for p in port.FP_predictor.parameters())

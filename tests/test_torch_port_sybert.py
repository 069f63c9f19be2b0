"""Textsy-BERT in the PyTorch port against the JAX package, on the CPU at
TINY widths: the forward, ``SeqCELoss`` and its error rate, a step with
the loss divided by the sy vocabulary size, the masks and the collate, and
the whole path through the CLIs: ``train_sybert``, then ``train_sambert
--resume_bert_path`` on an FP voice, whose warm start copies what the JAX
package's ``load_sambert_encoder_from_sybert`` copies.

The same weights (the port's, seeded, moved to JAX by the JAX package's
converter) and the same numpy inputs go through both packages, dropout off.
Tolerances: logits atol 1e-5; the loss rtol 1e-6 on given logits and rtol
1e-5 through the model; error rates exactly; the global gradient norm rtol
1e-4; masks, batches and warm-started tensors exactly.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization
from torch import nn

from kantts_tpu import losses as jl
from kantts_tpu.data import dataset as jdata
from kantts_tpu.models.sambert.sambert import KanTtsTextsyBERT as JTextsyBERT
from kantts_tpu.train.states import TrainState
from kantts_tpu.train.steps import make_sybert_step as j_make_sybert_step
from kantts_tpu.train.trainer import load_sambert_encoder_from_sybert as j_warm_start
from kantts_tpu.utils.torch_convert import convert_sambert, convert_sybert
from kantts_tpu_torch.bin import train_sambert, train_sybert
from kantts_tpu_torch.data import dataset as tdata
from kantts_tpu_torch.losses import criterion_builder
from kantts_tpu_torch.losses import losses as tl
from kantts_tpu_torch.models.builder import build_sambert, build_sybert, sybert_params
from kantts_tpu_torch.train.optim import global_grad_norm, optimizer_builder
from kantts_tpu_torch.train.steps import make_sybert_step, sybert_losses
from kantts_tpu_torch.train.trainer import load_sambert_encoder_from_sybert
from kantts_tpu_torch.utils.convert import sybert_state_dict_from_jax
from kantts_tpu_torch.utils.corpus import write_fp_corpus, write_text_corpus
from test_sambert import TINY
from test_torch_port_fp import fp_config

ENCODER_KEYS = ("max_len", "embedding_dim", "encoder_num_layers", "encoder_num_heads",
                "encoder_num_units", "encoder_ffn_inner_dim", "encoder_dropout",
                "encoder_attention_dropout", "encoder_relu_dropout",
                "encoder_projection_units")
SYBERT_TINY = {
    "model_type": "sybert",
    "Model": {"KanTtsTextsyBERT": {
        "params": dict({k: TINY[k] for k in ENCODER_KEYS}, mask_ratio=0.3),
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3, "betas": [0.9, 0.98],
                                                 "eps": 1e-9}},
        "scheduler": {"type": "NoamLR", "params": {"warmup_steps": 100}}}},
    "linguistic_unit": {
        "cleaners": "english_cleaners",
        "lfeat_type_list": ("sy,tone,syllable_flag,word_segment,emo_category,"
                            "speaker_category"),
        "speaker_list": "F7"},
    "Loss": {"SeqCELoss": {"enable": True, "params": {"loss_type": "ce"}}},
    "batch_size": 4, "grad_norm": 1.0, "allow_cache": True,
    "train_max_steps": 4, "save_interval_steps": 2, "eval_interval_steps": 2,
    "log_interval_steps": 2,
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("text_corpus"))
    write_text_corpus(root, 20, (5, 12), seed=1)
    return root


def _datasets(corpus, mod, seed=7):
    train, valid = mod.get_bert_text_datasets(
        [os.path.join(corpus, "raw_metafile.txt")], [corpus], dict(SYBERT_TINY))
    for ds in (train, valid):
        ds.masking_actor.rng = np.random.RandomState(seed)
    return train, valid


@pytest.fixture(scope="module")
def batch(corpus):
    train, _ = _datasets(corpus, tdata)
    return train.collate_fn([train[i] for i in range(8)])


@pytest.fixture(scope="module")
def models():
    """(port model, JAX model, JAX params): the port's seeded weights."""
    port = build_sybert(SYBERT_TINY, seed=0)
    params = sybert_params(SYBERT_TINY)
    return port, JTextsyBERT(params), convert_sybert(
        {k: v.numpy() for k, v in port.state_dict().items()}, params)


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_weight_bridge_round_trip(models):
    port, _, params = models
    sd = sybert_state_dict_from_jax(params, sybert_params(SYBERT_TINY))
    for k, v in port.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert not any("ling_proj" in k for k in sd)


def test_forward_logits_match_jax(models, batch):
    port, jm, params = models
    want = jm.apply({"params": params}, jnp.asarray(batch["input_lings"]),
                    jnp.asarray(batch["valid_input_lengths"]), deterministic=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(batch["input_lings"]),
                          torch.from_numpy(batch["valid_input_lengths"]))
    assert got["logits"].shape[-1] == sybert_params(SYBERT_TINY)["sy"]
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               atol=1e-5, rtol=0)


def test_seq_ce_loss_matches_jax():
    rng = np.random.RandomState(2)
    logits = rng.randn(3, 9, 13).astype(np.float32)
    targets = rng.randint(0, 13, (3, 9))
    masks = (rng.rand(3, 9) < 0.4).astype(np.float32)
    got = tl.SeqCELoss()(*(torch.from_numpy(a) for a in (logits, targets, masks)))
    want = jl.SeqCELoss()(*(jnp.asarray(a) for a in (logits, targets, masks)))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    assert float(got[1]) == float(want[1]) and 0 < float(got[1]) < 1


def _zero_dropout(model: nn.Module) -> nn.Module:
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    return model.train()


def test_step_scale_matches_jax(models, batch):
    """The loss divided by the sy vocabulary size, and the gradient norm it
    gives, against JAX's; the eval steps of both packages on the batch."""
    port, jm, params = models
    crit = jl.criterion_builder(SYBERT_TINY)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        res = jm.apply({"params": p}, jb["input_lings"], jb["valid_input_lengths"],
                       deterministic=True)
        loss, err = crit["SeqCELoss"](res["logits"], jb["targets"], jb["loss_masks"])
        return loss / res["logits"].shape[-1], err

    (j_loss, j_err), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    j_norm = np.sqrt(sum(float((np.asarray(g) ** 2).sum())
                         for g in jax.tree_util.tree_leaves(j_grads)))
    model = _zero_dropout(build_sybert(SYBERT_TINY, seed=0))
    t_crit = criterion_builder(SYBERT_TINY)
    loss, metrics = sybert_losses(model, t_crit, _t(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    assert float(metrics["error_rate"]) == float(j_err)
    np.testing.assert_allclose(global_grad_norm(model.parameters()).item(), j_norm,
                               rtol=1e-4)
    unscaled = tl.SeqCELoss()(model(_t(batch)["input_lings"],
                                    _t(batch)["valid_input_lengths"])["logits"],
                              _t(batch)["targets"], _t(batch)["loss_masks"])[0]
    np.testing.assert_allclose(loss.item() * sybert_params(SYBERT_TINY)["sy"],
                               unscaled.item(), rtol=1e-5)

    j_eval = j_make_sybert_step(jm, crit, None, train=False)(
        TrainState(params, None, jnp.asarray(0)), jb)
    optimizer, scheduler, clip = optimizer_builder(
        port.parameters(), SYBERT_TINY["Model"]["KanTtsTextsyBERT"]["optimizer"], None,
        1.0)
    t_eval = make_sybert_step(port, t_crit, optimizer, scheduler, clip, train=False)(
        _t(batch))
    np.testing.assert_allclose(float(t_eval["loss"]), float(j_eval["loss"]), rtol=1e-5)
    assert float(t_eval["error_rate"]) == float(j_eval["error_rate"])


def test_masks_and_collate_match_jax(corpus):
    """One seed, the same sampler order: every mask draw and every array."""
    (t_train, t_valid), (j_train, j_valid) = (_datasets(corpus, m) for m in
                                              (tdata, jdata))
    for t_ds, j_ds in ((t_train, j_train), (t_valid, j_valid)):
        assert len(t_ds) == len(j_ds)
        for _ in range(2):
            for idx in (list(range(len(t_ds))), [len(t_ds) - 1, 0]):
                got = t_ds.collate_fn([t_ds[i] for i in idx])
                want = j_ds.collate_fn([j_ds[i] for i in idx])
                assert got.keys() == want.keys()
                for key in want:
                    assert got[key].dtype == want[key].dtype, key
                    np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    mask = got["loss_masks"]
    lengths = got["valid_input_lengths"]
    assert (mask[np.arange(len(lengths)), lengths] == 0).all()  # EOS unmasked
    actor = tdata.MaskingActor(0.5, np.random.RandomState(3))
    j_actor = jdata.MaskingActor(0.5, np.random.RandomState(3))
    seq = np.arange(40)
    m = actor.get_random_mask(40)
    np.testing.assert_array_equal(m, j_actor.get_random_mask(40))
    np.testing.assert_array_equal(actor.input_bert_masking(seq, 50, 99, m),
                                  j_actor.input_bert_masking(seq, 50, 99, m))


def test_train_sybert_then_warm_start_fp_cli(corpus, tmp_path):
    """``train_sybert --device cpu`` for 4 steps (and a resume from 2 to 4),
    then ``train_sambert --resume_bert_path --device cpu`` on a TINY FP
    voice. The warm start copies every ``text_encoder`` tensor but
    ``ling_proj``, bit for bit, and the same set as the JAX package's
    warm start on the converted parameters."""
    stage = tmp_path / "sybert"
    stage.mkdir()
    cfg = stage / "model.yaml"
    cfg.write_text(yaml.safe_dump(SYBERT_TINY))
    train_sybert.main(["--model_config", str(cfg), "--root_dir", corpus,
                       "--stage_dir", str(stage), "--device", "cpu"])
    ckpt = stage / "ckpt" / "checkpoint_4.ckpt"
    payload = torch.load(ckpt, weights_only=True)
    assert payload["steps"] == 4 and payload["scheduler"]["last_epoch"] == 4
    resumed = train_sybert.train(str(cfg), corpus, str(tmp_path / "resumed"),
                                 resume_path=str(stage / "ckpt" / "checkpoint_2.ckpt"),
                                 device="cpu")
    assert resumed.steps_taken == 2 and resumed.scheduler.last_epoch == 4
    means = [m for kind, _, m in resumed.history if kind == "eval"]
    assert means and all(np.isfinite(v) for v in means[-1].values())

    data = str(tmp_path / "fp_data")
    write_fp_corpus(data, 10, (5, 9), (30, 50), seed=2)
    am_cfg = fp_config(dur_pred_bias_init=1.0)
    am_cfg.update(batch_size=3, train_max_steps=4, save_interval_steps=4,
                  eval_interval_steps=4, log_interval_steps=2,
                  input_bucket=8, frame_bucket=12)
    am_cfg["Model"]["KanTtsSAMBERT"]["optimizer"] = SYBERT_TINY["Model"][
        "KanTtsTextsyBERT"]["optimizer"]
    am_path = tmp_path / "am.yaml"
    am_path.write_text(yaml.safe_dump(am_cfg))
    trainer = train_sambert.train(str(am_path), data, str(tmp_path / "am"),
                                  resume_bert_path=str(ckpt), device="cpu")
    assert trainer.steps_taken == 4
    train_means = [m for kind, _, m in trainer.history if kind == "train"]
    assert "train/fp_loss" in train_means[-1]
    assert all(np.isfinite(v) for v in train_means[-1].values())

    # the warm start on the model the CLI built, before any step
    model = build_sambert(trainer.config, seed=trainer.config.get("seed", 0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    copied = load_sambert_encoder_from_sybert(model, str(ckpt))
    assert copied == trainer.warm_started
    after = model.state_dict()
    encoder = {k for k in after if k.startswith("text_encoder.")}
    assert set(copied) == encoder - {"text_encoder.ling_proj.weight"}
    for k in copied:
        assert torch.equal(after[k], payload["model"][k]), k
    assert torch.equal(after["text_encoder.ling_proj.weight"],
                       before["text_encoder.ling_proj.weight"])

    # the JAX package's warm start on the converted parameters
    bert_tree = convert_sybert({k: v.numpy() for k, v in payload["model"].items()},
                               sybert_params(payload["config"]))
    msgpack = tmp_path / "sybert.msgpack"
    msgpack.write_bytes(serialization.msgpack_serialize({"model": bert_tree}))
    params = model.config
    j_before = convert_sambert({k: v.numpy() for k, v in before.items()}, params)
    j_after = flax.traverse_util.flatten_dict(j_warm_start(j_before, str(msgpack)))
    j_before = flax.traverse_util.flatten_dict(j_before)
    j_copied = {k for k in j_before if not np.array_equal(j_before[k], j_after[k])}
    assert len(j_copied) == len(copied)
    ours = flax.traverse_util.flatten_dict(
        convert_sambert({k: v.numpy() for k, v in after.items()}, params))
    assert ours.keys() == j_after.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], np.asarray(j_after[k]), err_msg=str(k))

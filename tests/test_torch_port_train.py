"""The port's SAM-BERT training path against the JAX package, at TINY widths on
the CPU: the criteria, the schedules and optimizer updates, the gradients of
the training forward, the train step, and the ``train_sambert`` CLI.

Weights are made by the JAX package's init and reach the port through the
weight bridge; inputs are numpy arrays from a seed. Tolerances: criteria
rtol 1e-5 (CTC 1e-4: optax and torch run different CTC recursions);
parameters after each update atol 1e-6; the total loss of a forward rtol
1e-5 and each gradient leaf max|diff| <= 1e-4 * max|g|. Gradients are taken
with every dropout's p at 0 (the JAX side with ``deterministic=True``).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from torch import nn

from kantts_tpu import losses as jl
from kantts_tpu.models.sambert.sambert import KanTtsSAMBERT as JSAMBERT
from kantts_tpu.train import schedulers as js
from kantts_tpu.train.optim import optimizer_builder as j_optimizer_builder
from kantts_tpu.utils.torch_convert import convert_sambert
from kantts_tpu_torch.bin import train_sambert
from kantts_tpu_torch.bin.text_to_wav import text_to_wav
from kantts_tpu_torch.configs import get_config
from kantts_tpu_torch.losses import losses as tl
from kantts_tpu_torch.losses import criterion_builder
from kantts_tpu_torch.models.builder import (
    hifigan_model_builder,
    load_checkpoint,
    save_checkpoint,
)
from kantts_tpu_torch.models.sambert.sambert import KanTtsSAMBERT
from kantts_tpu_torch.train import schedulers as ts
from kantts_tpu_torch.train.optim import optimizer_builder
from kantts_tpu_torch.train.steps import make_sambert_step, sambert_losses
from kantts_tpu_torch.utils.convert import sambert_state_dict_from_jax
from kantts_tpu_torch.utils.corpus import write_mas_corpus
from test_e2e import SAMBERT_TINY
from test_sambert import TINY
from test_torch_port_hifigan import small_generator_cfg

MAS_LOSSES = {
    "MelReconLoss": {"enable": True, "params": {"loss_type": "mae"}},
    "ProsodyReconLoss": {"enable": True, "params": {"loss_type": "mae"}},
    "AttentionCTCLoss": {"enable": True},
    "AttentionBinarizationLoss": {"enable": True,
                                  "params": {"start_epoch": 0, "warmup_epoch": 100}},
}
EPOCH = 50  # the binarization loss at half weight


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# ------------------------------------------------------------------ losses


def _loss_inputs(seed=0):
    rng = np.random.RandomState(seed)
    B, T_in, T_mel, n_mel = 3, 7, 18, 10
    in_lens, out_lens = np.array([7, 5, 2]), np.array([18, 11, 6])
    soft = np.abs(_rand(rng, B, 1, T_mel, T_in)) + 0.05
    soft /= soft.sum(-1, keepdims=True)
    hard = np.zeros_like(soft)
    for b in range(B):
        cols = np.minimum(np.arange(out_lens[b]) * in_lens[b] // out_lens[b],
                          in_lens[b] - 1)
        hard[b, 0, np.arange(out_lens[b]), cols] = 1.0
    return dict(
        in_lens=in_lens, out_lens=out_lens, soft=soft, hard=hard,
        logprob=_rand(rng, B, 1, T_mel, T_in),
        mel_t=_rand(rng, B, T_mel, n_mel), dec=_rand(rng, B, T_mel, n_mel),
        post=_rand(rng, B, T_mel, n_mel),
        durs=rng.randint(0, 6, (B, T_in)).astype(np.float32),
        preds=[_rand(rng, B, T_in) for _ in range(5)])


@pytest.mark.parametrize("loss_type", ["mae", "mse"])
def test_recon_losses_match_jax(loss_type):
    x = _loss_inputs()
    j = jl.MelReconLoss(loss_type)(*(jnp.asarray(x[k]) for k in
                                     ("out_lens", "mel_t", "dec", "post")))
    t = tl.MelReconLoss(loss_type)(*(torch.from_numpy(x[k]) for k in
                                     ("out_lens", "mel_t", "dec", "post")))
    prosody = [x["in_lens"], x["durs"]] + x["preds"]
    j += jl.ProsodyReconLoss(loss_type)(*(jnp.asarray(a) for a in prosody))
    t += tl.ProsodyReconLoss(loss_type)(*(torch.from_numpy(a) for a in prosody))
    assert len(j) == len(t) == 5
    for a, b in zip(j, t):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


@pytest.mark.parametrize("epoch", [0, 50, 200])
def test_binarization_loss_warmup_matches_jax(epoch):
    x = _loss_inputs(1)
    j = jl.AttentionBinarizationLoss(0, 100)(
        jnp.asarray(epoch), jnp.asarray(x["hard"]), jnp.asarray(x["soft"]))
    t = tl.AttentionBinarizationLoss(0, 100)(
        epoch, torch.from_numpy(x["hard"]), torch.from_numpy(x["soft"]))
    np.testing.assert_allclose(float(t), float(j), rtol=1e-5)
    assert (float(t) == 0.0) == (epoch == 0)


@pytest.mark.parametrize("ragged", [False, True])
def test_ctc_loss_matches_jax(ragged):
    x = _loss_inputs(2)
    in_lens, out_lens = x["in_lens"], x["out_lens"]
    if not ragged:
        in_lens, out_lens = np.full(3, 7), np.full(3, 18)
    j = jl.AttentionCTCLoss()(jnp.asarray(x["logprob"]), jnp.asarray(in_lens),
                              jnp.asarray(out_lens))
    t = tl.AttentionCTCLoss()(torch.from_numpy(x["logprob"]),
                              torch.from_numpy(in_lens), torch.from_numpy(out_lens))
    np.testing.assert_allclose(float(t), float(j), rtol=1e-4)


def test_criterion_builder():
    cfg = {"Loss": dict(MAS_LOSSES, stft_loss={"enable": False})}
    cfg["Loss"]["MelReconLoss"] = dict(cfg["Loss"]["MelReconLoss"], weights=2.0)
    crit = criterion_builder(cfg)
    assert set(crit) == set(MAS_LOSSES)
    assert crit["MelReconLoss"].weights == 2.0
    assert crit["AttentionCTCLoss"].weights == 1.0
    fp_seq = criterion_builder({"Loss": {
        "FpCELoss": {"enable": True, "params": {"weight": [1, 4, 4, 8]}},
        "SeqCELoss": {"enable": True, "weights": 0.5}}})
    assert isinstance(fp_seq["FpCELoss"], tl.FpCELoss)
    assert fp_seq["SeqCELoss"].weights == 0.5
    with pytest.raises(NotImplementedError, match="NoSuchLoss"):
        criterion_builder({"Loss": {"NoSuchLoss": {"enable": False}}})


# -------------------------------------------------- schedules and optimizer

SCHEDULES = [
    ("NoamLR", {"warmup_steps": 100}),
    ("FindLR", {"max_steps": 50, "max_lr": 1.0}),
    ("MultiStepLR", {"milestones": [3, 40], "gamma": 0.5}),
    ("StepLR", {"step_size": 7, "gamma": 0.3}),
    ("ExponentialLR", {"gamma": 0.97}),
    ("ConstantLR", {}),
]


@pytest.mark.parametrize("name,params", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedules_match_jax(name, params):
    """The JAX schedules compute in float32, the port's in float64: rtol 1e-5
    covers float32's powers at these counts."""
    base = 2e-3
    j = js.scheduler_builder(name, base, params)
    t = ts.scheduler_builder(name, base, params)
    for k in (0, 1, 2, 3, 7, 40, 49, 99, 100, 101):
        np.testing.assert_allclose(base * t(k), float(j(jnp.asarray(k))),
                                   rtol=1e-5, err_msg=f"update {k}")


OPTIMIZERS = {
    "adam_noam_clip": ({"type": "Adam", "params": {"lr": 1e-2, "betas": [0.9, 0.98],
                                                   "eps": 1e-9}},
                       {"type": "NoamLR", "params": {"warmup_steps": 3}}, 1.0),
    "adamw_decay": ({"type": "AdamW", "params": {"lr": 5e-2, "weight_decay": 0.1}},
                    {"type": "MultiStepLR", "params": {"milestones": [3]}}, None),
    "sgd_momentum": ({"type": "SGD", "params": {"lr": 0.1, "momentum": 0.9,
                                                "nesterov": True,
                                                "weight_decay": 0.01}},
                     None, None),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_updates_match_optax(name):
    opt_cfg, sched_cfg, grad_norm = OPTIMIZERS[name]
    rng = np.random.RandomState(3)
    params = {"w": _rand(rng, 4, 3), "b": _rand(rng, 3), "e": _rand(rng, 5, 2)}
    # large and small gradients in turn, so the clip acts on some updates only
    grads = [{k: _rand(rng, *v.shape) * (3.0 if i % 2 else 0.05)
              for k, v in params.items()} for i in range(6)]

    tx, _ = j_optimizer_builder(opt_cfg, sched_cfg, grad_norm)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = tx.init(j_params)
    t_params = {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    optimizer, scheduler, clip = optimizer_builder(t_params.values(), opt_cfg,
                                                   sched_cfg, grad_norm)
    assert (clip is None) == (grad_norm is None)
    for i, g in enumerate(grads):
        updates, j_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                     j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, p in t_params.items():
            p.grad = torch.from_numpy(g[k].copy())
        if clip is not None:
            norm = float(clip())
            np.testing.assert_allclose(
                norm, np.sqrt(sum((v ** 2).sum() for v in g.values())), rtol=1e-5)
        optimizer.step()
        scheduler.step()
        for k, p in t_params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[k]),
                                       atol=1e-6, rtol=0, err_msg=f"{k}, update {i}")


# --------------------------------------------------------------- gradients


def _train_batch(cfg, mas: bool, seed=4):
    """A numpy batch with the dataset's keys: ragged lengths; MAS gets
    frame-level prosody and a prior, otherwise token durations that sum to
    the padded mel length (the padding on the EOS slot)."""
    rng = np.random.RandomState(seed)
    B, T_in, T_mel = 3, 12, 36
    in_lens, out_lens = np.array([12, 9, 7]), np.array([36, 30, 20])
    ling = np.stack([rng.randint(0, cfg[k], (B, T_in)) for k in
                     ("sy", "tone", "syllable_flag", "word_segment")], -1)
    batch = dict(
        input_lings=ling, input_emotions=rng.randint(0, cfg["emotion"], (B, T_in)),
        input_speakers=rng.randint(0, cfg["speaker"], (B, T_in)),
        valid_input_lengths=in_lens, valid_output_lengths=out_lens,
        mel_targets=_rand(rng, B, T_mel, cfg["num_mels"]))
    n_feat = T_mel if mas else T_in
    batch["pitch_contours"] = np.abs(_rand(rng, B, n_feat))
    batch["energy_contours"] = np.abs(_rand(rng, B, n_feat))
    if mas:
        prior = np.abs(_rand(rng, B, T_mel, T_in)) + 0.1
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


def _jax_total(model, criterion, mas, ss_prob):
    def total(params, batch):
        res = model.apply(
            {"params": params}, batch["input_lings"], batch["input_emotions"],
            batch["input_speakers"], batch["valid_input_lengths"],
            batch["valid_output_lengths"], batch["mel_targets"],
            duration_targets=batch.get("durations"),
            pitch_targets=batch["pitch_contours"],
            energy_targets=batch["energy_contours"],
            attn_priors=batch.get("attn_priors"), deterministic=True,
            ss_prob=None if ss_prob is None else jnp.asarray(ss_prob),
            rngs={"dropout": jax.random.PRNGKey(0)})
        out = sum(criterion["MelReconLoss"](
            batch["valid_output_lengths"], batch["mel_targets"],
            res["dec_outputs"], res["postnet_outputs"]))
        out += sum(criterion["ProsodyReconLoss"](
            res["valid_inter_lengths"], res["duration_targets"],
            res["pitch_targets"], res["energy_targets"],
            res["log_duration_predictions"], res["pitch_predictions"],
            res["energy_predictions"]))
        if mas:
            out += criterion["AttentionCTCLoss"](
                res["attn_logprob"], batch["valid_input_lengths"],
                batch["valid_output_lengths"])
            out += criterion["AttentionBinarizationLoss"](
                EPOCH, res["attn_hard"], res["attn_soft"])
        return out

    return jax.jit(jax.value_and_grad(total))


def _zero_dropout(model: nn.Module) -> nn.Module:
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    return model.train()


@pytest.fixture(scope="module")
def jax_init():
    """-> init(mas) -> (cfg, numpy batch, JAX model, its params), made once
    per flag by the JAX package's init."""
    made = {}

    def init(mas: bool):
        if mas not in made:
            cfg = dict(TINY, MAS=mas)
            batch = _train_batch(cfg, mas)
            model = JSAMBERT(cfg)
            variables = jax.jit(lambda b: model.init(
                {"params": jax.random.PRNGKey(0)}, b["input_lings"],
                b["input_emotions"], b["input_speakers"],
                b["valid_input_lengths"], b["valid_output_lengths"],
                b["mel_targets"], duration_targets=b.get("durations"),
                pitch_targets=b["pitch_contours"],
                energy_targets=b["energy_contours"],
                attn_priors=b.get("attn_priors"), deterministic=True))(
                {k: jnp.asarray(v) for k, v in batch.items()})
            made[mas] = (cfg, batch, model,
                         jax.tree_util.tree_map(np.asarray, variables["params"]))
        return made[mas]

    return init


@pytest.mark.parametrize("case", ["mas", "durations", "mas_ss_prob_1"])
def test_gradients_match_jax(jax_init, case):
    mas = case != "durations"
    ss_prob = 1.0 if case == "mas_ss_prob_1" else None
    cfg, batch, j_model, params = jax_init(mas)
    loss_cfg = {"Loss": {k: v for k, v in MAS_LOSSES.items()
                         if mas or not k.startswith("Attention")}}
    j_loss, j_grads = _jax_total(j_model, jl.criterion_builder(loss_cfg), mas,
                                 ss_prob)(params, {k: jnp.asarray(v)
                                                   for k, v in batch.items()})

    port = KanTtsSAMBERT(cfg)
    port.load_state_dict(sambert_state_dict_from_jax(params, cfg), strict=True)
    _zero_dropout(port)
    t_batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    t_loss, metrics = sambert_losses(port, criterion_builder(loss_cfg), t_batch,
                                     EPOCH, mas, ss_prob, torch.Generator())
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
    assert metrics["TotalLoss"].item() == t_loss.item()
    if mas:
        assert float(metrics["attn_kl_loss"]) > 0.0

    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in port.named_parameters()}
    mapped = dict(_flat(convert_sambert(grads, cfg)))
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, j_grads)))
    assert mapped.keys() == want.keys()
    for key, g in want.items():
        scale = np.abs(g).max()
        diff = np.abs(mapped[key] - g).max()
        assert diff <= 1e-4 * scale, f"{key}: max|diff| {diff}, max|g| {scale}"


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, np.asarray(v)


# ---------------------------------------------------------- step and CLI


def test_step_lowers_the_loss():
    torch.manual_seed(0)
    cfg = dict(TINY, MAS=True)
    model = KanTtsSAMBERT(cfg)
    optimizer, scheduler, clip = optimizer_builder(
        model.parameters(), {"type": "Adam", "params": {"lr": 1e-3}},
        {"type": "ConstantLR"}, 1.0)
    criterion = criterion_builder({"Loss": MAS_LOSSES})
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in _train_batch(cfg, True).items()}
    step = make_sambert_step(model, criterion, optimizer, scheduler, clip, True)
    losses = [float(step(batch, 0)["TotalLoss"]) for _ in range(10)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert scheduler.last_epoch == 10
    metrics = make_sambert_step(model, criterion, optimizer, scheduler, clip, True,
                                train=False)(batch, 0)
    assert not model.training
    assert {"mel_loss_", "mel_loss", "dur_loss", "pitch_loss", "energy_loss",
            "x_band_width", "h_band_width", "attn_ctc_loss", "attn_kl_loss",
            "TotalLoss"} == set(metrics)
    assert np.isfinite(float(metrics["TotalLoss"]))


def train_config(stage, **overrides) -> str:
    """The TINY MAS training config with its losses, written as YAML."""
    cfg = yaml.safe_load(yaml.safe_dump(SAMBERT_TINY))
    cfg["Model"]["KanTtsSAMBERT"]["params"]["MAS"] = True
    cfg["Loss"].update(yaml.safe_load(yaml.safe_dump(MAS_LOSSES)))
    cfg.update(dict(train_max_steps=4, save_interval_steps=2,
                    eval_interval_steps=2, log_interval_steps=2), **overrides)
    os.makedirs(stage, exist_ok=True)
    path = os.path.join(stage, "model.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _ckpts(stage):
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(stage, "ckpt", "*")))


def test_train_sambert_cli_resume_and_serve(tmp_path):
    data, stage = str(tmp_path / "data"), str(tmp_path / "stage")
    write_mas_corpus(data, 12, (6, 10), (24, 40), seed=0)
    cfg = train_config(stage)
    train_sambert.main(["--model_config", cfg, "--root_dir", data,
                        "--stage_dir", stage, "--device", "cpu"])
    assert _ckpts(stage) == ["checkpoint_2.ckpt", "checkpoint_4.ckpt"]
    assert glob.glob(os.path.join(stage, "intermediate_results_4", "*_mel.npy"))
    payload = torch.load(os.path.join(stage, "ckpt", "checkpoint_4.ckpt"),
                         weights_only=True)
    assert payload["steps"] == 4
    assert payload["scheduler"]["last_epoch"] == 4
    assert set(payload) == {"model", "config", "optimizer", "scheduler", "steps"}

    # resume from step 2: exactly steps 3 and 4 run; keep only the newest
    resumed = str(tmp_path / "resumed")
    cfg2 = train_config(resumed, keep_last_checkpoints=1)
    trainer = train_sambert.train(cfg2, data, resumed,
                                  resume_path=os.path.join(stage, "ckpt",
                                                           "checkpoint_2.ckpt"),
                                  device="cpu")
    assert trainer.steps_taken == 2 and trainer.steps == 5
    assert trainer.scheduler.last_epoch == 4
    assert _ckpts(resumed) == ["checkpoint_4.ckpt"]
    assert [h[:2] for h in trainer.history if h[0] == "train"] == [("train", 4)]

    # a resume already at train_max_steps runs nothing
    done = train_sambert.train(cfg2, data, str(tmp_path / "done"),
                               resume_path=os.path.join(resumed, "ckpt",
                                                        "checkpoint_4.ckpt"),
                               device="cpu")
    assert done.steps_taken == 0

    # the trained checkpoint serves through text_to_wav as it is
    am_ckpt = os.path.join(stage, "ckpt", "checkpoint_4.ckpt")
    model, _ = load_checkpoint(am_ckpt, torch.device("cpu"))
    assert not model.training
    voc_cfg = get_config("hifigan_v1_16k")
    voc_cfg["Model"]["Generator"]["params"] = small_generator_cfg()
    voc_ckpt = str(tmp_path / "voc.pt")
    save_checkpoint(voc_ckpt, hifigan_model_builder(voc_cfg, seed=1), voc_cfg)
    text = tmp_path / "text.txt"
    text.write_text("ni3 hao3 .\n")
    stats = text_to_wav(str(tmp_path / "wav"), am_ckpt, voc_ckpt, str(text),
                        device=torch.device("cpu"))
    assert stats["audio_seconds"] > 0
    assert glob.glob(str(tmp_path / "wav" / "res_wavs" / "*.wav"))


def test_train_refuses_what_it_cannot_do(tmp_path):
    data = str(tmp_path / "data")
    write_mas_corpus(data, 4, (3, 4), (12, 15), seed=1)
    cfg = train_config(str(tmp_path / "s"))
    with pytest.raises(FileNotFoundError, match="bert.ckpt"):  # it is read now
        train_sambert.train(cfg, data, str(tmp_path / "s"),
                            resume_bert_path=str(tmp_path / "bert.ckpt"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_sambert.train(cfg, data, str(tmp_path / "s"))

"""Data parallelism of the port (``kantts_tpu_torch/parallel/mesh.py`` and
the steps, trainers and CLIs that use it) on the CPU over gloo, at TINY
widths.

- Every criterion, run on two shards of a global batch with the shards'
  normalisers summed, gives by the sum of its shard results the JAX
  criterion's value on the whole batch, taken in float64 (rtol 1e-6); a
  mean of per-shard means does not.
- Two gloo processes, each stepping on its shard, equal the port's
  one-process step on the global batch: SAM-BERT with MAS (K1's plain
  version), a hifigan_v1-style GAN step with the STFT loss, and Textsy-BERT,
  with dropout off. Metrics within 1e-4 (relative above 1), parameters atol
  2e-5 / rtol 1e-4 (the tolerances of ``tests/test_multiprocess_dp.py``), the
  reduced and clipped gradients within 1e-5 of their global norm. The ranks
  end bit-equal, the sampler shards are disjoint and even, and in a 2-rank
  ``train_sambert`` CLI run rank 1 writes nothing.
- World size 1 over gloo equals the plain run bit for bit; a failed
  rendezvous raises; reference KAN-TTS checkpoints load.

The two processes run this file as a script (``worker``), so it imports
JAX only inside the tests that compare with the JAX package.
"""

import json
import logging
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from torch import nn

from kantts_tpu_torch.bin import train_sambert
from kantts_tpu_torch.data import dataset as tdata
from kantts_tpu_torch.data.dataset import DataLoader, DistributedSampler
from kantts_tpu_torch.losses import criterion_builder
from kantts_tpu_torch.losses import losses as tl
from kantts_tpu_torch.models.builder import (
    hifigan_gan_builder,
    load_checkpoint,
    sambert_model_builder,
    sambert_params,
    sybert_model_builder,
)
from kantts_tpu_torch.parallel import mesh
from kantts_tpu_torch.text.ling_unit import KanTtsLinguisticUnit
from kantts_tpu_torch.train.steps import make_gan_step, make_sambert_step, make_sybert_step
from kantts_tpu_torch.utils.config import load_yaml
from kantts_tpu_torch.utils.corpus import write_mas_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "kantts_tpu_torch", "resources", "configs")
SHARDS = ([0, 1, 2], [3, 4])  # uneven on purpose: 3 + 2 items
ENCODER = dict(max_len=64, embedding_dim=32, encoder_num_layers=1,
               encoder_num_heads=2, encoder_num_units=16, encoder_ffn_inner_dim=32,
               encoder_dropout=0.1, encoder_attention_dropout=0.1,
               encoder_relu_dropout=0.1, encoder_projection_units=8)
SAMBERT_TINY = dict(
    ENCODER, speaker_units=8, emotion_units=8, predictor_filter_size=5,
    predictor_fsmn_num_layers=1, predictor_num_memory_units=16,
    predictor_ffn_inner_dim=16, predictor_dropout=0.1, predictor_shift=0,
    predictor_lstm_units=8, dur_pred_prenet_units=[8, 8], dur_pred_lstm_units=8,
    decoder_prenet_units=[16, 16], decoder_num_layers=1, decoder_num_heads=2,
    decoder_num_units=16, decoder_ffn_inner_dim=32, decoder_dropout=0.1,
    decoder_attention_dropout=0.1, decoder_relu_dropout=0.1, outputs_per_step=3,
    num_mels=80, postnet_filter_size=5, postnet_fsmn_num_layers=1,
    postnet_num_memory_units=16, postnet_ffn_inner_dim=16, postnet_dropout=0.1,
    postnet_shift=1, postnet_lstm_units=8, MAS=True)


# ----------------------------------------------------------------- configs


def sambert_config(**keys):
    """sambert_16k_MAS.yaml at TINY widths; grad_norm 0.1 so that the clip
    acts on the first step's gradient."""
    cfg = load_yaml(os.path.join(CONFIGS, "sambert_16k_MAS.yaml"))
    cfg["Model"]["KanTtsSAMBERT"]["params"] = dict(SAMBERT_TINY)
    cfg.update(grad_norm=0.1, num_workers=0)
    cfg.update(keys)
    return cfg


def gan_config():
    """hifigan_v1_16k.yaml at narrow widths with the STFT loss on, and
    both gradient clips at 1.0."""
    cfg = load_yaml(os.path.join(CONFIGS, "hifigan_v1_16k.yaml"))
    model = cfg["Model"]
    model["Generator"]["params"].update(channels=32, resblock_kernel_sizes=[3],
                                        resblock_dilations=[[1, 3]])
    model["MultiScaleDiscriminator"]["params"]["discriminator_params"].update(
        channels=16, max_downsample_channels=32, max_groups=4,
        downsample_scales=[2, 2, 1])
    model["MultiPeriodDiscriminator"]["params"].update(periods=[2, 3])
    model["MultiPeriodDiscriminator"]["params"]["discriminator_params"].update(
        channels=4, max_downsample_channels=8, downsample_scales=[3, 3, 1])
    cfg["Loss"]["stft_loss"] = {
        "enable": True, "weights": 1.0,
        "params": {"fft_sizes": [256, 128, 64], "hop_sizes": [32, 16, 8],
                   "win_lengths": [128, 64, 32]}}
    cfg.update(generator_grad_norm=1.0, discriminator_grad_norm=1.0,
               batch_max_steps=1200)
    return cfg


def sybert_config():
    cfg = load_yaml(os.path.join(CONFIGS, "sybert.yaml"))
    cfg["Model"]["KanTtsTextsyBERT"]["params"] = dict(ENCODER, mask_ratio=0.3)
    cfg.update(grad_norm=0.1)
    return cfg


# ----------------------------------------------------------------- batches


def _pad(arrays, length, axis=0):
    out = []
    for a in arrays:
        width = [(0, 0)] * a.ndim
        width[axis] = (0, length - a.shape[axis])
        out.append(np.pad(a, width))
    return np.stack(out)


def sambert_lengths(items):
    """The lengths a MAS batch of ``items`` pads to: its longest input and
    output (a multiple of r = 3)."""
    return (max(len(it["emo"]) for it in items),
            -(-max(len(it["mel"]) for it in items) // 3) * 3)


def sambert_batch(items, lengths):
    """A MAS batch of ``items`` padded with zeros to ``lengths``."""
    T_in, T_mel = lengths
    return dict(
        input_lings=_pad([it["ling"] for it in items], T_in),
        input_emotions=_pad([it["emo"] for it in items], T_in),
        input_speakers=_pad([it["spk"] for it in items], T_in),
        valid_input_lengths=np.array([len(it["emo"]) for it in items]),
        valid_output_lengths=np.array([len(it["mel"]) for it in items]),
        mel_targets=_pad([it["mel"] for it in items], T_mel),
        pitch_contours=_pad([it["pitch"] for it in items], T_mel),
        energy_contours=_pad([it["energy"] for it in items], T_mel),
        attn_priors=np.stack([np.pad(it["prior"], ((0, T_mel - it["prior"].shape[0]),
                                                   (0, T_in - it["prior"].shape[1])))
                              for it in items]))


def sambert_items(cfg, seed=4):
    """5 MAS items of ragged lengths, the shorter ones last, so that the two
    shards differ in padded length."""
    rng = np.random.RandomState(seed)
    unit = sambert_params(cfg)  # the vocabulary sizes among them
    items = []
    for T_in, T_mel in ((12, 36), (9, 30), (10, 33), (7, 20), (5, 17)):
        ling = np.stack([rng.randint(1, unit[k], T_in) for k in
                         ("sy", "tone", "syllable_flag", "word_segment")], -1)
        prior = np.abs(rng.randn(T_mel, T_in)).astype(np.float32) + 0.1
        items.append(dict(
            ling=ling, emo=rng.randint(1, unit["emotion"], T_in),
            spk=rng.randint(1, unit["speaker"], T_in),
            mel=rng.randn(T_mel, 80).astype(np.float32),
            pitch=np.abs(rng.randn(T_mel)).astype(np.float32),
            energy=np.abs(rng.randn(T_mel)).astype(np.float32),
            prior=prior / prior.sum(-1, keepdims=True)))
    return items


def gan_batch(seed=5):
    rng = np.random.RandomState(seed)
    wav = (0.3 * rng.randn(5, 1200, 1)).astype(np.float32)
    mel = rng.randn(5, 6, 80).astype(np.float32)
    return wav, mel


def sybert_lengths(items):
    return (max(len(it["t"]) for it in items),)


def sybert_batch(items, lengths):
    T, = lengths
    return dict(input_lings=_pad([it["ling"] for it in items], T),
                valid_input_lengths=np.array([len(it["t"]) for it in items]),
                targets=_pad([it["t"] for it in items], T),
                loss_masks=_pad([it["m"] for it in items], T))


def sybert_items(cfg, seed=6):
    rng = np.random.RandomState(seed)
    unit = KanTtsLinguisticUnit(cfg).get_unit_size()
    items = []
    for T in (11, 8, 9, 5, 4):
        ling = np.stack([rng.randint(1, unit[k], T) for k in
                         ("sy", "tone", "syllable_flag", "word_segment")], -1)
        items.append(dict(ling=ling, t=rng.randint(1, unit["sy"], T),
                          m=(rng.rand(T) < 0.5).astype(np.float32)))
    return items


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# -------------------------------------------------------------- the steps


def _no_dropout(*modules):
    for module in modules:
        for m in module.modules():
            if isinstance(m, nn.Dropout):
                m.p = 0.0


def _grads(named):
    return {k: p.grad.detach().clone() for k, p in named if p.grad is not None}


def _state(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _agreed(lengths):
    """The padded lengths of a shard taken to the largest over the ranks, as
    the CLIs' loaders take them (``mesh.lengths_max``)."""
    agree = mesh.lengths_max()
    return lengths if agree is None else agree(lengths)


def run_sambert(which, data_parallel, n_steps=1, seed=0, replicate=False):
    """``n_steps`` MAS train steps on the items ``which``, padded as the
    global batch is -> (metrics of each step, parameters and buffers,
    clipped gradients, pre-clip norm)."""
    cfg = sambert_config()
    built = sambert_model_builder(cfg, seed, torch.device("cpu"))
    model = built["model"]
    _no_dropout(model)
    if replicate:
        mesh.replicate([model])
    norms = []
    clip = built["clip"]

    def recorded_clip():
        norms.append(float(clip()))

    step = make_sambert_step(model, criterion_builder(cfg), built["optimizer"],
                             built["scheduler"], recorded_clip, True,
                             data_parallel=data_parallel)
    items = [sambert_items(cfg)[i] for i in which]
    batch = _tensors(sambert_batch(items, _agreed(sambert_lengths(items))))
    metrics = [{k: v.clone() for k, v in step(batch, 50).items()}
               for _ in range(n_steps)]
    return dict(metrics=metrics, state=_state(model),
                grads=_grads(model.named_parameters()), norms=norms)


def run_gan(which, data_parallel, n_steps=1, seed=0, replicate=False):
    cfg = gan_config()
    built = hifigan_gan_builder(cfg, seed, torch.device("cpu"))
    gen, discs = built["generator"], built["discriminators"]
    if replicate:
        mesh.replicate([gen, *discs.values()])
    step = make_gan_step(gen, discs, criterion_builder(cfg), built["gen_optimizer"],
                         built["gen_scheduler"], built["disc_optimizers"],
                         built["disc_schedulers"], built["gen_clip"],
                         built["disc_clips"], data_parallel=data_parallel)
    wav, mel = gan_batch()
    wav, mel = torch.from_numpy(wav[which]), torch.from_numpy(mel[which])
    metrics = [{k: v.clone() for k, v in step(wav, mel).items()}
               for _ in range(n_steps)]
    state = {f"generator.{k}": v for k, v in _state(gen).items()}
    grads = {f"generator.{k}": v for k, v in _grads(gen.named_parameters()).items()}
    for name, d in discs.items():
        state.update({f"{name}.{k}": v for k, v in _state(d).items()})
        grads.update({f"{name}.{k}": v for k, v in _grads(d.named_parameters()).items()})
    return dict(metrics=metrics, state=state, grads=grads)


def run_sybert(which, data_parallel, n_steps=1, seed=0, replicate=False):
    cfg = sybert_config()
    built = sybert_model_builder(cfg, seed, torch.device("cpu"))
    model = built["model"]
    _no_dropout(model)
    if replicate:
        mesh.replicate([model])
    step = make_sybert_step(model, criterion_builder(cfg), built["optimizer"],
                            built["scheduler"], built["clip"],
                            data_parallel=data_parallel)
    items = [sybert_items(cfg)[i] for i in which]
    batch = _tensors(sybert_batch(items, _agreed(sybert_lengths(items))))
    metrics = [{k: v.clone() for k, v in step(batch).items()} for _ in range(n_steps)]
    return dict(metrics=metrics, state=_state(model),
                grads=_grads(model.named_parameters()))


RUNS = {"sambert": run_sambert, "gan": run_gan, "sybert": run_sybert}


# ------------------------------------------------------------ the workers


def cli_config(stage):
    cfg = sambert_config(batch_size=2, train_max_steps=2, save_interval_steps=2,
                         eval_interval_steps=2, log_interval_steps=1)
    os.makedirs(stage, exist_ok=True)
    path = os.path.join(stage, "model.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


class Lengths:
    """Items that are their own lengths; a batch pads to its largest."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        return 3 + 5 * i

    def padded_lengths(self, items):
        return (max(items),)

    def collate_fn(self, items, lengths=None):
        return [max(items), (lengths or self.padded_lengths(items))[0]]


def worker(rank: int, world: int, port: int, outdir: str, data: str) -> None:
    """One rank: join the group from a torchrun-style environment, step on
    this rank's shard of each model's global batch (rank 1 builds from
    another seed, which ``replicate`` must overwrite), record the samplers,
    then run the ``train_sambert`` CLI for 2 steps, recording every file it
    writes under its stage directory."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    mesh.distributed_init("cpu")
    for kind, run in RUNS.items():
        out = run(SHARDS[rank], None, seed=rank, replicate=True)
        torch.save(out, os.path.join(outdir, f"{kind}_rank{rank}.pt"))

    samplers = {}
    for name, n, drop_last in (("train", 10, True), ("valid", 7, False)):
        sampler = DistributedSampler(n, mesh.world_size(), mesh.rank(),
                                     shuffle=drop_last)
        loader = DataLoader(list(range(n)), 2, sampler, drop_last=drop_last,
                            collate_fn=list)
        samplers[name] = [batch for batch in loader]
    loader = DataLoader(Lengths(), 2, DistributedSampler(12, mesh.world_size(), mesh.rank()),
                        num_workers=2, lengths_max=mesh.lengths_max())
    samplers["padded"] = [batch for batch in loader]
    with open(os.path.join(outdir, f"samplers_rank{rank}.json"), "w") as f:
        json.dump(samplers, f)

    stage = os.path.join(outdir, "cli_stage")
    writes = []

    def audit(event, args):
        if event in ("open", "os.mkdir", "os.rename", "os.replace", "os.remove"):
            path = args[0]
            if event == "open" and (not isinstance(args[1], str)
                                    or not set(args[1]) & set("wax+")):
                return
            if isinstance(path, str) and os.path.abspath(path).startswith(stage + os.sep):
                writes.append(f"{event} {os.path.relpath(path, stage)}")

    os.environ["KANTTS_TRAIN_PROFILE"] = "1"
    logging.basicConfig(level=logging.INFO)  # as the CLI's __main__ sets it
    sys.addaudithook(audit)
    train_sambert.main(["--model_config", os.path.join(outdir, "model.yaml"),
                        "--root_dir", data, "--stage_dir", stage, "--device", "cpu"])
    with open(os.path.join(outdir, f"cli_writes_rank{rank}.json"), "w") as f:
        json.dump(writes, f)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two gloo processes of ``worker``, started once for every case."""
    outdir = tmp_path_factory.mktemp("ddp")
    data = str(outdir / "data")
    write_mas_corpus(data, 8, (6, 10), (24, 40), seed=0)
    cli_config(str(outdir))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(rank), "2",
         str(port), str(outdir), data],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    return outdir, data


def _load(outdir, name):
    return torch.load(os.path.join(outdir, name), weights_only=False)


def _close_metrics(got, want):
    assert got.keys() == want.keys()
    for k in want:
        a, b = float(got[k]), float(want[k])
        assert abs(a - b) <= 1e-4 * max(1.0, abs(b)), (k, a, b)


# ----------------------------------------------- two ranks against one


@pytest.mark.parametrize("kind", list(RUNS))
def test_two_ranks_equal_one_process(two_ranks, kind):
    """Rank 0's step on its shard, with the normalisers, the band width and
    the gradients reduced, equals the one-process step on the global batch."""
    outdir, _ = two_ranks
    got = _load(outdir, f"{kind}_rank0.pt")
    want = RUNS[kind](SHARDS[0] + SHARDS[1], False)
    _close_metrics(got["metrics"][0], want["metrics"][0])

    assert got["grads"].keys() == want["grads"].keys()
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in want["grads"].values()]))
    worst = max((got["grads"][k] - g).abs().max() for k, g in want["grads"].items())
    assert worst <= 1e-5 * norm, (float(worst), float(norm))

    assert got["state"].keys() == want["state"].keys()
    for k, v in want["state"].items():
        if v.is_floating_point():
            bad = ~torch.isclose(got["state"][k], v, rtol=1e-4, atol=2e-5)
            assert not bad.any(), (k, got["state"][k][bad][:8], v[bad][:8])
        else:
            assert torch.equal(got["state"][k], v), k
    if kind == "sambert":  # the clip acted, after the reduction
        assert got["norms"] == pytest.approx(want["norms"], rel=1e-5)
        assert want["norms"][0] > 0.1
    if kind == "gan":
        assert any(k.endswith("weight_u") for k in want["state"])


@pytest.mark.parametrize("kind", list(RUNS))
def test_ranks_end_bit_equal(two_ranks, kind):
    """Rank 1 built from another seed; after ``replicate`` and a step both
    ranks hold the same bits, spectral-norm vectors included, and report the
    same metrics."""
    outdir, _ = two_ranks
    r0, r1 = _load(outdir, f"{kind}_rank0.pt"), _load(outdir, f"{kind}_rank1.pt")
    assert r0["state"].keys() == r1["state"].keys()
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k
    for k, v in r0["metrics"][0].items():
        assert torch.equal(v, r1["metrics"][0][k]), k


def test_sampler_shards(two_ranks):
    """Disjoint shards that cover the data, equal numbers of batches on both
    ranks for train (drop_last) and eval (padded, not dropped), and batches
    padded to the global batch's lengths."""
    outdir, _ = two_ranks
    s0, s1 = (json.load(open(outdir / f"samplers_rank{r}.json")) for r in (0, 1))
    assert len(s0["train"]) == len(s1["train"]) == 2
    flat0, flat1 = sum(s0["train"], []), sum(s1["train"], [])
    assert not set(flat0) & set(flat1)
    assert len(s0["valid"]) == len(s1["valid"]) == 2
    assert set(sum(s0["valid"], []) + sum(s1["valid"], [])) == set(range(7))
    # the loader pads each batch to the global batch's longest (prefetched)
    assert len(s0["padded"]) == len(s1["padded"]) == 3
    for (local0, pad0), (local1, pad1) in zip(s0["padded"], s1["padded"]):
        assert pad0 == pad1 == max(local0, local1)
    assert any(a[0] != b[0] for a, b in zip(s0["padded"], s1["padded"]))


def test_cli_two_ranks_rank0_writes_and_resumes(two_ranks, tmp_path):
    """``train_sambert`` under a 2-rank torchrun-style environment: 2 steps,
    rank 0 alone writes (checkpoint, config.yaml, stdout.log with the phase
    seconds), and its checkpoint resumes on one process."""
    outdir, data = two_ranks
    w0, w1 = (json.load(open(outdir / f"cli_writes_rank{r}.json")) for r in (0, 1))
    assert w1 == []
    assert any(w.endswith("config.yaml") for w in w0)
    assert any(w.endswith("stdout.log") for w in w0)
    assert any("checkpoint_2.ckpt" in w for w in w0)
    stage = outdir / "cli_stage"
    log = (stage / "stdout.log").read_text()
    phases = [ln for ln in log.splitlines() if "phase_seconds" in ln]
    assert phases and "allreduce=" in phases[-1] and "loader_wait=" in phases[-1]
    assert sorted(os.listdir(stage / "ckpt")) == ["checkpoint_2.ckpt"]

    cfg = sambert_config(batch_size=2, train_max_steps=3, save_interval_steps=3,
                         eval_interval_steps=3, log_interval_steps=1)
    path = tmp_path / "model.yaml"
    path.write_text(yaml.safe_dump(cfg))
    trainer = train_sambert.train(str(path), data, str(tmp_path / "resumed"),
                                  resume_path=str(stage / "ckpt" / "checkpoint_2.ckpt"),
                                  device="cpu")
    assert trainer.steps_taken == 1 and trainer.steps == 4


# --------------------------------------------------- world size 1, gloo


@pytest.mark.parametrize("kind", list(RUNS))
def test_world_size_one_equals_plain(kind, tmp_path):
    """A process group of one (gloo on a FileStore): two steps with every
    collective running give the plain run's bits."""
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    torch.distributed.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        dp = RUNS[kind]([0, 1, 2, 3, 4], None, n_steps=2)
    finally:
        mesh.destroy()
    plain = RUNS[kind]([0, 1, 2, 3, 4], False, n_steps=2)
    for part in ("state", "grads"):
        assert dp[part].keys() == plain[part].keys()
        for k, v in plain[part].items():
            assert torch.equal(dp[part][k], v), (part, k)
    for m_dp, m_plain in zip(dp["metrics"], plain["metrics"]):
        for k, v in m_plain.items():
            assert torch.equal(m_dp[k], v), k


# -------------------------------------------------------------- refusals


@pytest.mark.parametrize("rank", [0, 1])
def test_failed_rendezvous_raises(rank, monkeypatch):
    """WORLD_SIZE=2 with no peer: the rendezvous fails within its timeout
    and raises; the process never goes on alone."""
    import datetime

    monkeypatch.setenv("RANK", str(rank))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", str(rank))
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    with pytest.raises((RuntimeError, TimeoutError)):
        mesh.distributed_init("cpu", timeout=datetime.timedelta(seconds=2))
    assert not mesh.is_distributed()


def test_distributed_init_without_torchrun(monkeypatch):
    """No environment: a no-op at world size 1 whose collectives launch
    nothing; a partial one raises."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    mesh.distributed_init("cpu")
    assert (mesh.rank(), mesh.world_size(), mesh.is_primary()) == (0, 1, True)
    a, b = torch.ones(()), torch.zeros(())
    out = mesh.global_sum(a, b)
    assert out[0] is a and out[1] is b and mesh.global_max(a) is a
    mesh.barrier()
    assert mesh.local_device("cuda") == torch.device("cuda")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh.distributed_init("cpu")


# ---------------------------------------- global-batch criteria vs JAX


def shard_sum(fn, n_shards):
    """``fn(shard, reduce)`` on every shard, one after the other, with the
    shards' normalisers summed: a first pass records each shard's calls to
    ``reduce``, a second gives every shard the sums. -> the sum of the
    shards' results, in float64."""
    calls = [[] for _ in range(n_shards)]
    for k in range(n_shards):
        def record(*xs, k=k):
            calls[k].append(xs)
            return xs
        fn(k, record)
    totals = [tuple(sum(c[i][j] for c in calls) for j in range(len(calls[0][i])))
              for i in range(len(calls[0]))]
    outs = []
    for k in range(n_shards):
        given = iter(totals)
        outs.append(fn(k, lambda *xs: next(given)))
    return [sum(float(o[j]) for o in outs) for j in range(len(outs[0]))]


def _crit_inputs(seed=11):
    rng = np.random.RandomState(seed)
    B, T_in, T_mel, n_mel, V = 5, 9, 27, 10, 13
    in_lens, out_lens = np.array([9, 8, 7, 3, 2]), np.array([27, 25, 21, 9, 7])
    soft = np.abs(rng.randn(B, 1, T_mel, T_in)).astype(np.float32) + 0.05
    soft /= soft.sum(-1, keepdims=True)
    hard = np.zeros_like(soft)
    for b in range(B):
        cols = np.minimum(np.arange(out_lens[b]) * in_lens[b] // out_lens[b],
                          in_lens[b] - 1)
        hard[b, 0, np.arange(out_lens[b]), cols] = 1.0
    probs = np.abs(rng.randn(B, T_in, 4)).astype(np.float32)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    wav_y = (0.3 * rng.randn(B, 800)).astype(np.float32)
    return dict(
        in_lens=in_lens, out_lens=out_lens, soft=soft, hard=hard,
        logprob=f32(B, 1, T_mel, T_in), mel_t=f32(B, T_mel, n_mel),
        dec=f32(B, T_mel, n_mel), post=f32(B, T_mel, n_mel),
        durs=rng.randint(0, 6, (B, T_in)).astype(np.float32),
        preds=[f32(B, T_in) for _ in range(5)],
        fp_pd=probs / probs.sum(-1, keepdims=True),
        fp_label=rng.randint(0, 4, (B, T_in)), logits=f32(B, T_in, V),
        targets=rng.randint(0, V, (B, T_in)),
        masks=(rng.rand(B, T_in) < 0.4).astype(np.float32),
        wav_x=wav_y + (0.05 * rng.randn(B, 800)).astype(np.float32) * (1 + np.arange(B))[:, None],
        wav_y=wav_y,
        sub_x=f32(B, 4, 400), sub_y=f32(B, 4, 400))


STFT = dict(fft_sizes=(128, 256, 64), hop_sizes=(16, 32, 8), win_lengths=(64, 128, 32))
# name: (JAX criterion args -> outputs, port criterion(args, reduce) -> outputs,
#        input keys; the batch axis of every input is 0)
CRITERIA = {
    "mel": (lambda m, a: m.MelReconLoss("mae")(*a),
            lambda a, r: tl.MelReconLoss("mae")(*a, reduce=r),
            ("out_lens", "mel_t", "dec", "post")),
    "prosody": (lambda m, a: m.ProsodyReconLoss("mse")(*a),
                lambda a, r: tl.ProsodyReconLoss("mse")(*a, reduce=r),
                ("in_lens", "durs", "p0", "p1", "p2", "p3", "p4")),
    "fp_ce": (lambda m, a: [m.FpCELoss()(*a)],
              lambda a, r: [tl.FpCELoss()(*a, reduce=r)],
              ("in_lens", "fp_pd", "fp_label")),
    "seq_ce": (lambda m, a: m.SeqCELoss()(*a),
               lambda a, r: tl.SeqCELoss()(*a, reduce=r),
               ("logits", "targets", "masks")),
    "binarization": (lambda m, a: [m.AttentionBinarizationLoss(0, 100)(50, *a)],
                     lambda a, r: [tl.AttentionBinarizationLoss(0, 100)(50, *a, reduce=r)],
                     ("hard", "soft")),
    "ctc": (lambda m, a: [m.AttentionCTCLoss()(*a)],
            lambda a, r: [tl.AttentionCTCLoss()(*a, reduce=r)],
            ("logprob", "in_lens", "out_lens")),
    "stft": (lambda m, a: m.MultiResolutionSTFTLoss(**STFT)(*a),
             lambda a, r: tl.MultiResolutionSTFTLoss(**STFT)(*a, reduce=r),
             ("wav_x", "wav_y")),
    "subband_stft": (lambda m, a: m.MultiResolutionSTFTLoss((64, 32), (8, 4), (32, 16))(*a),
                     lambda a, r: tl.MultiResolutionSTFTLoss((64, 32), (8, 4), (32, 16))(
                         *a, reduce=r),
                     ("sub_x", "sub_y")),
}


def _crit_case(name):
    x = _crit_inputs()
    x.update({f"p{i}": p for i, p in enumerate(x.pop("preds"))})
    jax_fn, port_fn, keys = CRITERIA[name]
    arrays = [x[k] for k in keys]
    import jax
    import jax.numpy as jnp

    from kantts_tpu import losses as jl

    with jax.enable_x64(True):  # the exact global loss, not float32's rounding of it
        want = [float(v) for v in jax_fn(jl, [jnp.asarray(
            a.astype(np.float64) if a.dtype == np.float32 else a) for a in arrays])]

    def shard(k, reduce):
        return port_fn([torch.from_numpy(np.asarray(a)[SHARDS[k]]) for a in arrays],
                       reduce)

    return want, shard


@pytest.mark.parametrize("name", list(CRITERIA))
def test_shard_shares_sum_to_the_jax_global_loss(name):
    """The shards' shares, with their normalisers summed, add up to the JAX
    criterion on the whole batch (the spectral convergence of the STFT
    losses from the global squared norms). The JAX side runs in float64:
    its float32 sum is itself ~1e-6 off the exact mel loss here."""
    want, shard = _crit_case(name)
    got = [float(v) for v in shard_sum(shard, len(SHARDS))]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", list(CRITERIA))
def test_mean_of_shard_means_is_not_the_global_loss(name):
    """The same batch and shards without the reducer, averaged over the
    shards: off by more than the tolerance, so the test above can tell."""
    want, shard = _crit_case(name)
    outs = [shard(k, None) for k in range(len(SHARDS))]
    naive = [float(sum(o[j] for o in outs)) / len(SHARDS) for j in range(len(want))]
    rel = max(abs(a - b) / abs(b) for a, b in zip(naive, want))
    assert rel > 1e-4, rel


# ------------------------------------------- checkpoints and the prior


def _reference_payload(state):
    """A DDP-saved reference checkpoint: names under ``module.``, no config."""
    return {f"module.{k}": v for k, v in state.items()}


def test_load_reference_sambert_checkpoint(tmp_path):
    cfg = sambert_config()
    model = sambert_model_builder(cfg, 3, torch.device("cpu"))["model"].eval()
    path = tmp_path / "model.pth"
    torch.save({"model": _reference_payload(model.state_dict()), "steps": 7}, path)
    loaded, config = load_checkpoint(str(path), torch.device("cpu"), config=cfg)
    assert config is cfg and not loaded.training
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    with pytest.raises(KeyError):
        load_checkpoint(str(path), torch.device("cpu"))  # no config in the file


def test_load_reference_hifigan_checkpoint(tmp_path):
    cfg = gan_config()
    built = hifigan_gan_builder(cfg, 3, torch.device("cpu"))
    gen = built["generator"].eval()
    yaml_path = tmp_path / "config.yaml"
    yaml_path.write_text(yaml.safe_dump(cfg))
    path = tmp_path / "model.pth"
    torch.save({"model": {"generator": gen.state_dict(),
                          "discriminator": {n: d.state_dict() for n, d in
                                            built["discriminators"].items()}}}, path)
    loaded, _ = load_checkpoint(str(path), torch.device("cpu"), config=str(yaml_path))
    mel = torch.from_numpy(gan_batch()[1][:2])
    with torch.no_grad():
        assert torch.equal(loaded(mel), gen(mel))


@pytest.mark.parametrize("shape", [(1, 1), (3, 200), (57, 300), (96, 576)])
def test_beta_binomial_prior_equals_the_jax_loop(shape):
    """The broadcast prior gives the JAX package's loop bit for bit."""
    from kantts_tpu import data as jdata

    P, M = shape
    np.testing.assert_array_equal(tdata.beta_binomial_prior_distribution(P, M),
                                  jdata.beta_binomial_prior_distribution(P, M))


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
           sys.argv[6])

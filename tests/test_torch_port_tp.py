"""Tensor, sequence and pipeline parallelism of the port
(``kantts_tpu_torch/parallel/tp.py``, ``pp.py``, the grid of ``mesh.py``)
on the CPU over gloo, at TINY widths, against the JAX package.

- The plan shards exactly the leaves that ``kantts_tpu.parallel.tp.
  tp_shardings`` shards, through the weight bridge, a layer that does not
  divide included; with 4 ranks and 2 heads the one departure shows (an
  attention whose heads do not divide stays whole here).
- Two gloo processes (``worker``, one fixture for every case) step on a 1 x 2
  (tensor-parallel) and a 2 x 1 (data-parallel) grid from the same seeded
  weights, dropout off, with MAS through ``b_mas_torch``. Each step against
  the JAX package's unsharded ``make_sambert_step`` on the bridged weights:
  TotalLoss rtol 1e-5, parameters after the step atol 3e-4 (the JAX
  package's own tensor-parallel bound, ``tests/test_tensor_parallel.py``);
  against the port's plain step: the reduced pre-clip gradients within 1e-5
  of their global norm.
- Sequence-parallel vocoding of a CFG_16K generator, causal and not, over
  the two ranks against the JAX generator's forward, atol 1e-5.
- The GPipe encoder (2 stages, 4 microbatches) against the JAX
  ``SelfAttentionEncoder.apply``, atol 1e-5, and its gradients against the
  port's sequential encoder, atol 1e-5; bad folds raise.
- A tensor-parallel checkpoint loads into a plain model bit for bit, and a
  plain one into a sharded model; ``train_sambert`` under two gloo ranks
  with ``tensor_parallel: 2`` trains as the plain CLI does (parameters atol
  3e-4), rank 1 writes nothing, and its checkpoint goes through the JAX
  bridge as a plain one does.
- The plan equals ``tp_shardings`` at every SAM-BERT config's published
  widths. One tensor-parallel step of each voice the JAX CLI shards (bf16,
  byte, FP, SE + NSF, the Textsy-BERT warm start) against the JAX step and
  the port's plain step: float32 as above, bf16 within 0.5 e_ref of JAX bf16
  (``tests/test_torch_port_bf16.py``'s bound).
- A crash under tensor parallelism (both ranks interrupted at step k)
  leaves the whole ``checkpoint-{k}.ckpt``, bit-equal to the gathered state,
  and a resume from it runs step k + 1; a missing slice leaves no whole
  file within the join's timeout.
- Sequence-parallel vocoding of a tiny NSF generator, causal and not, with
  its source given and broadcast from rank 0, against the JAX generator on
  the whole utterance, atol 1e-5.

The two processes run this file as a script (``worker``), which imports no
JAX; the test process runs the JAX side while they work.
"""

import copy
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

from kantts_tpu_torch.bin import train_sambert
from kantts_tpu_torch.data import dataset as tdata
from kantts_tpu_torch.losses import criterion_builder
from kantts_tpu_torch.models.builder import (
    load_checkpoint,
    sambert_model_builder,
    sambert_params,
    save_checkpoint,
    sybert_model_builder,
    write_checkpoint,
)
from kantts_tpu_torch.models.hifigan.generator import Generator
from kantts_tpu_torch.models.sambert.sambert import SelfAttentionEncoder
from kantts_tpu_torch.parallel import mesh, pp, tp
from kantts_tpu_torch.train.steps import make_sambert_step
from kantts_tpu_torch.train.trainer import SambertTrainer, load_sambert_encoder_from_sybert
from kantts_tpu_torch.utils.config import load_merged_config, load_yaml
from kantts_tpu_torch.utils.corpus import write_fp_corpus, write_mas_corpus
from test_torch_port_ddp import (
    CONFIGS,
    SAMBERT_TINY,
    SHARDS,
    _free_port,
    _no_dropout,
    _pad,
    _tensors,
    sambert_batch,
    sambert_config,
    sambert_items,
    sambert_lengths,
    sybert_config,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH = 50
GRIDS = {"tp_1x2": (1, 2), "dp_2x1": (2, 1)}
SP_FRAMES = 100  # chunks of 50 frames, each with the 21-frame receptive field
ENC = dict(n_layer=4, d_model=16, n_head=2, d_head=8, d_inner=24,
           dropout=0.0, dropout_att=0.0, dropout_relu=0.0, max_len=64)
ENC_LENGTHS = [20, 17, 12, 20, 5, 20, 9, 14]


def config(**keys):
    """``sambert_config`` with every dropout at 0."""
    cfg = sambert_config(**keys)
    params = cfg["Model"]["KanTtsSAMBERT"]["params"]
    params.update({k: 0.0 for k in params if "dropout" in k})
    return cfg


def seeded_sambert(cfg):
    built = sambert_model_builder(cfg, 0, torch.device("cpu"))
    _no_dropout(built["model"])
    return built


def global_batch(cfg):
    items = sambert_items(cfg)
    return items, sambert_lengths(items)


def port_encoder():
    torch.manual_seed(3)
    return SelfAttentionEncoder(ENC["d_model"], ENC["n_layer"], ENC["d_model"],
                                ENC["n_head"], ENC["d_head"], ENC["d_inner"], 0.0,
                                0.0, 0.0, ENC["max_len"]).eval()


def encoder_inputs():
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(8, 20, ENC["d_model"]).astype(np.float32))
    mask = torch.arange(20)[None, :] >= torch.tensor(ENC_LENGTHS)[:, None]
    return x, mask


# tests/test_hifigan.py::CFG_16K (held equal in test_sequence_parallel_matches_jax;
# that module imports JAX, which the workers do not)
CFG_16K = dict(in_channels=80, out_channels=1, channels=64, kernel_size=7,
               upsample_scales=(10, 5, 2, 2), upsample_kernal_sizes=(20, 10, 4, 4),
               resblock_kernel_sizes=(3, 7), resblock_dilations=((1, 3), (1, 3)))


def sp_generator_cfg(causal):
    return dict(CFG_16K, causal=causal)


def sp_mel():
    return torch.from_numpy(np.random.RandomState(7).randn(1, SP_FRAMES, 80)
                            .astype(np.float32))


# --------------------------------------------------------------- the voices

SE_UNITS = 8  # SAMBERT_TINY's speaker_units
VOICES = {  # name: (config, SAMBERT_TINY overrides, top-level keys)
    "bf16": ("sambert_16k_MAS", {}, {"mixed_precision": True}),
    "byte": ("sambert_16k_MAS_byte", {"using_byte": True}, {}),
    "fp": ("sambert_fp_8k", {"FP": True, "MAS": False, "fp_dropout": 0.0}, {}),
    "se_nsf": ("sambert_se_nsf_global_16k",
               {"MAS": False, "NSF": True, "SE": True, "num_mels": 82,
                "nsf_norm_type": "global"}, {}),
    "warm": ("sambert_16k_MAS", {}, {}),  # the encoder from a Textsy-BERT checkpoint
}


def voice_config(voice):
    """The voice's published config at SAMBERT_TINY widths, every dropout at
    0, grad_norm 0.1 (the clip acts on the first step), with its own Loss
    section and linguistic unit."""
    name, overrides, top = VOICES[voice]
    cfg = load_yaml(os.path.join(CONFIGS, f"{name}.yaml"))
    params = dict(SAMBERT_TINY, **overrides)
    params.update({k: 0.0 for k in params if "dropout" in k})
    cfg["Model"]["KanTtsSAMBERT"]["params"] = params
    cfg.update(grad_norm=0.1, num_workers=0, **top)
    return cfg


def voice_batch(voice, fp_corpus):
    """-> (a numpy batch of the voice, its fp_dict_lings or None). MAS
    voices: ``sambert_items``' lengths, bytes (B, T, 1) for the byte voice.
    SE + NSF: token durations and prosody, 82 mel channels and a speaker
    embedding per token up to its length, as the SE loader gives them. FP:
    the port's collate of ``fp_corpus``'s training set."""
    cfg = voice_config(voice)
    params = sambert_params(cfg)
    if params.get("FP"):
        config = load_merged_config(fp_corpus, os.path.join(CONFIGS, "sambert_fp_8k.yaml"))
        config["Model"]["KanTtsSAMBERT"]["params"] = params
        train, _ = tdata.get_am_datasets([os.path.join(fp_corpus, "raw_metafile.txt")],
                                         [fp_corpus], config, input_bucket=8,
                                         frame_bucket=12)
        return train.collate_fn([train[i] for i in range(len(train))]), train.fp_dict_lings
    if params["MAS"]:
        items = sambert_items(voice_config("warm"))
        if params.get("using_byte"):  # bytes, and the byte unit's emotions and speakers
            rng = np.random.RandomState(9)
            for it in items:
                n = len(it["emo"])
                it.update(ling=rng.randint(1, params["byte_index"], (n, 1)),
                          emo=rng.randint(1, params["emotion"], n),
                          spk=rng.randint(1, params["speaker"], n))
        return sambert_batch(items, sambert_lengths(items)), None
    rng = np.random.RandomState(4)
    in_lens, out_lens = np.array([12, 9, 10, 7, 5]), np.array([36, 30, 33, 20, 17])
    B, T_in, T_mel = len(in_lens), int(in_lens.max()), int(out_lens.max())
    durs = np.zeros((B, T_in), np.float32)
    for b, (n, m) in enumerate(zip(in_lens, out_lens)):
        durs[b, :n] = 1 + rng.multinomial(m - n, np.full(n, 1.0 / n))
        if n < T_in:
            durs[b, n] = T_mel - m
    se = rng.randn(SE_UNITS).astype(np.float32)
    return dict(
        input_lings=np.stack([rng.randint(1, params[k], (B, T_in)) for k in
                              ("sy", "tone", "syllable_flag", "word_segment")], -1),
        input_emotions=rng.randint(1, params["emotion"], (B, T_in)),
        input_speakers=np.where((np.arange(T_in)[None] <= in_lens[:, None])[..., None],
                                se, 0.0).astype(np.float32),
        valid_input_lengths=in_lens, valid_output_lengths=out_lens,
        mel_targets=_pad([rng.randn(m, params["num_mels"]).astype(np.float32)
                          for m in out_lens], T_mel),
        pitch_contours=np.abs(rng.randn(B, T_in)).astype(np.float32),
        energy_contours=np.abs(rng.randn(B, T_in)).astype(np.float32),
        durations=durs), None


def voice_tensors(batch):
    return {k: (tuple(torch.from_numpy(a) for a in v) if isinstance(v, tuple)
                else torch.from_numpy(np.asarray(v)))
            for k, v in batch.items() if v is not None}


def voice_model(voice, outdir):
    """The seeded model of the voice, dropout off; the warm start copies
    the Textsy-BERT encoder in first, as ``train_sambert`` does before it
    shards. -> (built, the names copied)."""
    built = seeded_sambert(voice_config(voice))
    copied = []
    if voice == "warm":
        copied = load_sambert_encoder_from_sybert(built["model"],
                                                  os.path.join(outdir, "bert.ckpt"))
    return built, copied


# NSF generators for sequence parallelism: tests/test_torch_port_nsf.py::
# nsf_generator_cfg (held equal in test_nsf_sequence_parallel_matches_jax)
NSF_GEN = dict(in_channels=80, out_channels=1, channels=32, kernel_size=7,
               upsample_scales=(4, 4), upsample_kernal_sizes=(8, 8),
               resblock_kernel_sizes=(3, 7), resblock_dilations=((1, 3), (1, 3, 5)),
               nonlinear_activation="LeakyReLU",
               nonlinear_activation_params={"negative_slope": 0.1},
               nsf_params={"nb_harmonics": 7, "sampling_rate": 16000})
NSF_FRAMES = 60  # chunks of 30 frames, each under a wider window
NSF_DRAW = 11  # the seed of the source's draws


def nsf_sp_cfg(causal):
    return dict(NSF_GEN, causal=causal)


def nsf_sp_mel():
    """(1, NSF_FRAMES, 82): a random mel, f0 of 80-300 Hz, uv 0/1."""
    rng = np.random.RandomState(12)
    mel = rng.randn(1, NSF_FRAMES, 82).astype(np.float32)
    mel[..., -2] = rng.uniform(80.0, 300.0, (1, NSF_FRAMES))
    mel[..., -1] = (rng.rand(1, NSF_FRAMES) > 0.3).astype(np.float32)
    return torch.from_numpy(mel)


def nsf_excitation(gen, mel):
    return gen(mel, excitation_only=True, generator=torch.Generator().manual_seed(NSF_DRAW))


def cli_config(path, **keys):
    cfg = config(**dict(dict(batch_size=4, train_max_steps=2, save_interval_steps=2,
                             eval_interval_steps=2, log_interval_steps=1), **keys))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


# ------------------------------------------------------------ the workers


def grid_step(name, outdir):
    """One train step on ``GRIDS[name]`` from the seeded weights: the data
    rank's shard of the global batch (all of it on a 1 x 2 grid), padded to
    the lengths the data group agrees on. -> what rank 0 saves."""
    n_data, n_model = GRIDS[name]
    grid = mesh.make_mesh_2d(n_data, n_model)
    cfg = config()
    built = seeded_sambert(cfg)
    model = built["model"]
    tp.shard_module(model, grid, built["optimizer"])
    clip, seen = tp.make_clip(model, cfg["grad_norm"]), {}

    def recorded_clip():
        seen["grads"] = tp.gather_grads(model)
        seen["norm"] = float(clip())

    step = make_sambert_step(model, criterion_builder(cfg), built["optimizer"],
                             built["scheduler"], recorded_clip, True,
                             group=grid.data_group)
    items, _ = global_batch(cfg)
    mine = items if n_data == 1 else [items[i] for i in SHARDS[grid.data_index]]
    lengths = mesh.lengths_max(grid.data_gloo)(sambert_lengths(mine))
    metrics = step(_tensors(sambert_batch(mine, lengths)), EPOCH)
    out = dict(metrics={k: float(v) for k, v in metrics.items()},
               state=copy.deepcopy(tp.gather_state_dict(model)), grads=seen["grads"],
               norm=seen["norm"], grid=(grid.data_index, grid.model_index),
               lengths=lengths)
    if name == "tp_1x2":
        payload = copy.deepcopy(dict(
            model=tp.gather_state_dict(model),
            optimizer=tp.gather_optimizer_state(built["optimizer"], model)))
        # a plain checkpoint into the sharded model, gathered back
        plain = seeded_sambert(cfg)
        model.load_state_dict(tp.shard_state_dict(plain["model"].state_dict(), model))
        built["optimizer"].load_state_dict(tp.shard_optimizer_state(
            payload["optimizer"], built["optimizer"], model))
        out.update(checkpoint=payload, reloaded=copy.deepcopy(tp.gather_state_dict(model)),
                   reloaded_optimizer=copy.deepcopy(
                       tp.gather_optimizer_state(built["optimizer"], model)),
                   local_heads=model.text_encoder.ling_enc.fft[0].slf_attn.n_head)
    return out


def voice_step(voice, grid, outdir):
    """One train step of the voice on the 1 x 2 grid from the seeded (or
    warm-started) weights, sharded after the warm start as ``train_sambert``
    shards. -> the metrics, the gathered state after the step, the whole
    pre-clip gradients and norm, and for the warm start whether each copied
    tensor arrived as this rank's slice of the Textsy-BERT tensor."""
    cfg = voice_config(voice)
    built, copied = voice_model(voice, outdir)
    model = built["model"]
    tp.shard_module(model, grid, built["optimizer"])
    out = {}
    if copied:
        bert = torch.load(os.path.join(outdir, "bert.ckpt"), weights_only=True)["model"]
        plan, own = model.tensor_parallel.plan, model.state_dict()
        out["warm"] = dict(copied=len(copied), sliced=sum(k in plan for k in copied),
                           equal=all(torch.equal(own[k], tp.split(bert[k], plan[k], 2,
                                                                  grid.model_index)
                                                 if k in plan else bert[k])
                                     for k in copied))
    clip, seen = tp.make_clip(model, cfg["grad_norm"]), {}

    def recorded_clip():
        seen["grads"] = tp.gather_grads(model)
        seen["norm"] = float(clip())

    batch, fp_dict = torch.load(os.path.join(outdir, "voices.pt"), weights_only=False)[voice]
    step = make_sambert_step(model, criterion_builder(cfg), built["optimizer"],
                             built["scheduler"], recorded_clip, sambert_params(cfg)["MAS"],
                             fp_dict_lings=None if fp_dict is None else torch.from_numpy(fp_dict),
                             group=grid.data_group)
    metrics = step(voice_tensors(batch), EPOCH)
    out.update(metrics={k: float(v) for k, v in metrics.items()}, grads=seen["grads"],
               norm=seen["norm"], state=copy.deepcopy(tp.gather_state_dict(model)))
    return out


CRASH_STEP = 3  # the step both ranks are interrupted at


def crash_runs(rank, outdir, data):
    """F6: ``train_sambert.train`` with ``tensor_parallel: 2``, warm-started
    from the Textsy-BERT checkpoint, interrupted on both ranks at
    ``CRASH_STEP`` (a ``KeyboardInterrupt`` from the step), with the state
    gathered there; a resume from the crash checkpoint; then the interrupt
    again with rank 1 writing no slice and rank 0 waiting 2 s. -> what
    each run saw."""
    seen = {"steps": []}
    step_fn, save_crash = SambertTrainer.train_step, SambertTrainer.save_crash_checkpoint

    def interrupted(self, batch):
        seen["steps"].append(self.steps)
        if seen.get("interrupt") and self.steps == CRASH_STEP:
            seen["gathered"] = copy.deepcopy(dict(
                model=tp.gather_state_dict(self.model),
                optimizer=tp.gather_optimizer_state(self.optimizer, self.model)))
            seen["t0"] = time.perf_counter()
            raise KeyboardInterrupt
        return step_fn(self, batch)

    def interrupted_run(stage, **kw):
        seen.update(interrupt=True, steps=[])
        try:
            train_sambert.train(os.path.join(outdir, "crash", "model.yaml"), data, stage,
                                device="cpu", **kw)
        except KeyboardInterrupt:
            return time.perf_counter() - seen["t0"]
        raise AssertionError("the run was not interrupted")

    out = {}
    SambertTrainer.train_step = interrupted
    try:
        stage = os.path.join(outdir, "crash_stage")
        out["handler_s"] = interrupted_run(
            stage, resume_bert_path=os.path.join(outdir, "bert.ckpt"))
        out["gathered"] = seen["gathered"]
        seen.update(interrupt=False, steps=[])
        resumed = train_sambert.train(
            os.path.join(outdir, "crash", "model.yaml"), data,
            os.path.join(outdir, "crash_resume_stage"),
            resume_path=os.path.join(stage, "ckpt", f"checkpoint-{CRASH_STEP}.ckpt"),
            device="cpu")
        out["resumed_steps"] = list(seen["steps"])
        out["resumed_taken"] = resumed.steps_taken
        SambertTrainer.crash_join_seconds = 2.0
        if rank == 1:  # a rank that dies before its handler runs
            SambertTrainer.save_crash_checkpoint = lambda self: None
        out["missing_handler_s"] = interrupted_run(os.path.join(outdir, "crash_missing"))
    finally:
        SambertTrainer.train_step, SambertTrainer.save_crash_checkpoint = step_fn, save_crash
        SambertTrainer.crash_join_seconds = 10.0
    return out


def interrupted_cli(outdir: str, data: str) -> None:
    """Run under torchrun: the tensor-parallel CLI interrupted on both ranks
    at ``CRASH_STEP``, the ``KeyboardInterrupt`` left to end the process as
    it ends the CLI's, so torchrun stops the other worker once the first
    exits. Rank 0's join is held back 2 s, as a full-width join takes
    seconds: a rank 1 that exited as soon as its slice was written would
    have rank 0 stopped before the whole file lands."""
    torch.set_num_threads(1)
    step_fn, join_files = SambertTrainer.train_step, tp.join_slice_files

    def interrupted(self, batch):
        if self.steps == CRASH_STEP:
            raise KeyboardInterrupt
        return step_fn(self, batch)

    def held_back(*args, **kw):
        time.sleep(2.0)
        return join_files(*args, **kw)

    SambertTrainer.train_step, tp.join_slice_files = interrupted, held_back
    logging.basicConfig(level=logging.INFO, force=True)
    train_sambert.main(["--model_config", os.path.join(outdir, "crash", "model.yaml"),
                        "--root_dir", data, "--stage_dir",
                        os.path.join(outdir, "torchrun_crash_stage"), "--device", "cpu"])
    raise AssertionError(f"train_sambert ran past step {CRASH_STEP}")


def worker(rank: int, port: int, outdir: str, data: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    mesh.distributed_init("cpu")
    results = {name: grid_step(name, outdir) for name in GRIDS}
    grid = mesh.make_mesh_2d(1, 2)
    results["voices"] = {voice: voice_step(voice, grid, outdir) for voice in VOICES}

    ready = os.path.join(outdir, "generators_ready")
    while not os.path.exists(ready):  # the test process writes them meanwhile
        time.sleep(0.1)
    for causal in (True, False):
        gen = Generator(**sp_generator_cfg(causal)).eval()
        gen.load_state_dict(torch.load(os.path.join(outdir, f"gen_{causal}.pt")))
        results[f"sp_{causal}"] = tp.sequence_parallel_apply(gen, sp_mel())
        nsf = Generator(**nsf_sp_cfg(causal)).eval()
        nsf.load_state_dict(torch.load(os.path.join(outdir, f"nsf_gen_{causal}.pt")))
        mel = nsf_sp_mel()
        results[f"nsf_sp_{causal}"] = dict(
            given=tp.sequence_parallel_apply(nsf, mel, excitation=nsf_excitation(nsf, mel)),
            broadcast=tp.sequence_parallel_apply(
                nsf, mel, rng=torch.Generator().manual_seed(NSF_DRAW)))

    enc = port_encoder()
    x, mask = encoder_inputs()
    x.requires_grad_()
    pipe = pp.make_pipe_mesh(2)
    out = pp.sambert_encoder_pipeline(enc, x, mask, pipe, 4)
    out.square().sum().backward()
    grads = {}
    for k, p in enc.named_parameters():
        g = p.grad.clone()
        if k.startswith("fft."):  # each stage holds its own layers' share
            torch.distributed.all_reduce(g)
        grads[k] = g
    results["pp"] = dict(out=out.detach(), grads=grads, stage=pipe.stage,
                         x_grad=None if x.grad is None else x.grad.clone())

    logging.basicConfig(level=logging.INFO, force=True)  # as the CLI's __main__ sets it
    results["crash"] = crash_runs(rank, outdir, data)
    if rank == 0:
        torch.save(results, os.path.join(outdir, "results.pt"))
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

    sys.addaudithook(audit)
    train_sambert.main(["--model_config", os.path.join(outdir, "tp", "model.yaml"),
                        "--root_dir", data, "--stage_dir", stage, "--device", "cpu"])
    with open(os.path.join(outdir, f"cli_writes_rank{rank}.json"), "w") as f:
        json.dump(writes, f)


class Workers:
    """The two worker processes and the plain ``train_sambert`` run, started
    at once; ``wait`` joins them."""

    def __init__(self, outdir, data):
        self.outdir, self.data = outdir, data
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
            [ROOT, os.path.join(ROOT, "tests"), os.environ.get("PYTHONPATH", "")]))
        port = _free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "worker", str(rank), str(port),
             str(outdir), data], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for rank in range(2)]
        self.procs.append(subprocess.Popen(
            [sys.executable, "-m", "kantts_tpu_torch.bin.train_sambert", "--model_config",
             os.path.join(outdir, "plain", "model.yaml"), "--root_dir", data,
             "--stage_dir", os.path.join(outdir, "plain_stage"), "--device", "cpu"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        self.torchrun = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", "--monitor-interval", "0.1", os.path.abspath(__file__),
             "interrupted-cli", str(outdir), data],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.done = self.torchrun_log = None

    def wait(self):
        if self.done is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=400)[0])
            finally:
                self.stop()
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, f"{p.args} failed:\n{log[-4000:]}"
            self.done = torch.load(os.path.join(self.outdir, "results.pt"),
                                   weights_only=False)
        return self.done

    def wait_torchrun(self):
        """-> torchrun's exit code and output."""
        if self.torchrun_log is None:
            self.torchrun_log = self.torchrun.communicate(timeout=400)[0]
        return self.torchrun.returncode, self.torchrun_log

    def stop(self):
        if self.torchrun.poll() is None:  # its agent stops its workers
            self.torchrun.terminate()
            self.torchrun.wait()
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """The workers, running while the tests compute the JAX side, and the
    seeded generators they read, with their JAX params."""
    from kantts_tpu.utils.torch_convert import convert_hifigan_generator
    from kantts_tpu_torch.models.builder import init_parameters

    outdir = tmp_path_factory.mktemp("tp")
    data = str(outdir / "data")
    write_mas_corpus(data, 8, (6, 10), (24, 40), seed=0)
    cli_config(str(outdir / "tp" / "model.yaml"), tensor_parallel=2)
    cli_config(str(outdir / "plain" / "model.yaml"))
    cli_config(str(outdir / "crash" / "model.yaml"), train_max_steps=CRASH_STEP + 1,
               tensor_parallel=2, save_interval_steps=100, eval_interval_steps=100)
    fp_corpus = str(outdir / "fp_corpus")
    write_fp_corpus(fp_corpus, 12, (5, 9), (30, 50), seed=3)
    save_checkpoint(str(outdir / "bert.ckpt"), sybert_model_builder(sybert_config(), 1)["model"],
                    sybert_config())
    voices = {voice: voice_batch(voice, fp_corpus) for voice in VOICES}
    torch.save(voices, str(outdir / "voices.pt"))
    running = Workers(str(outdir), data)
    running.voices = voices
    jax_gens = {}
    for causal in (True, False):
        cfg = sp_generator_cfg(causal)
        gen = Generator(**cfg)
        init_parameters(gen, 5)
        sd = gen.state_dict()
        torch.save(sd, str(outdir / f"gen_{causal}.pt"))
        jax_gens[causal] = (cfg, convert_hifigan_generator(
            {k: v.numpy() for k, v in sd.items()}, cfg))
        cfg = nsf_sp_cfg(causal)
        gen = Generator(**cfg)
        init_parameters(gen, 6)
        sd = gen.state_dict()
        torch.save(sd, str(outdir / f"nsf_gen_{causal}.pt"))
        jax_gens[f"nsf_{causal}"] = (cfg, convert_hifigan_generator(
            {k: v.numpy() for k, v in sd.items()}, cfg), gen.eval())
    (outdir / "generators_ready").write_text("")
    yield running, jax_gens
    running.stop()


# ------------------------------------------------------------------ the plan


def _jax_sharded_keys(model, cfg, n_model):
    """The port state-dict keys whose JAX leaves ``tp_shardings`` shards over
    ``n_model``: each port tensor filled with its own index goes through
    the weight bridge, so each JAX leaf names its port key."""
    import jax
    from jax.sharding import PartitionSpec as P

    from kantts_tpu.parallel.tp import make_mesh_2d, tp_shardings
    from kantts_tpu.utils.torch_convert import convert_sambert

    keys = list(model.state_dict())
    probe = {k: np.broadcast_to(np.float32(i), tuple(v.shape))
             for i, (k, v) in enumerate(model.state_dict().items())}
    tree = convert_sambert(probe, cfg)
    specs = tp_shardings(tree, make_mesh_2d(1, n_model))
    sharded = set()
    for leaf, spec in zip(jax.tree_util.tree_leaves(tree),
                          jax.tree_util.tree_leaves(specs, is_leaf=lambda s: hasattr(s, "spec"))):
        if spec.spec != P():
            sharded.add(keys[int(np.asarray(leaf).reshape(-1)[0])])
    return sharded


def test_plan_matches_jax(workers):
    """Every leaf ``tp_shardings`` shards over 2 ranks, and no other, with
    the predictors' FSMN inner width (15) left whole on both sides."""
    cfg = config()
    cfg["Model"]["KanTtsSAMBERT"]["params"]["predictor_ffn_inner_dim"] = 15
    model = seeded_sambert(cfg)["model"]
    plan = tp.tp_plan(model, 2)
    assert set(plan) == _jax_sharded_keys(model, sambert_params(cfg), 2)
    assert not [k for k in plan if "predictor.fsmn" in k]
    assert any("mel_postnet.fsmn" in k for k in plan)
    assert plan["text_encoder.ling_enc.fft.0.slf_attn.w_qkv.weight"] == tp.Shard("col", 0, 3)
    assert "mel_decoder.mel_dec.pnca.0.pnca_attn.fc_x.bias" not in plan


def test_plan_departs_only_where_heads_do_not_divide(workers):
    """Over 4 ranks the 2-head attentions stay whole here while GSPMD splits
    their 48 columns; the FFNs shard on both sides."""
    cfg = config()
    model = seeded_sambert(cfg)["model"]
    plan = tp.tp_plan(model, 4)
    jax_keys = _jax_sharded_keys(model, sambert_params(cfg), 4)
    attention = {k for k in jax_keys if ".slf_attn." in k or ".pnca_attn." in k}
    assert attention and not attention & set(plan)
    assert set(plan) == jax_keys - attention


SAMBERT_CONFIGS = sorted(os.path.basename(f)[:-len(".yaml")]
                         for f in os.listdir(CONFIGS)
                         if f.startswith("sambert_") and f.endswith(".yaml"))


@pytest.mark.parametrize("name", SAMBERT_CONFIGS)
def test_plan_matches_jax_on_every_config(name):
    """At each SAM-BERT config's published widths (built on the meta device:
    shapes only), over 2 ranks: the plan is exactly what ``tp_shardings``
    shards, through the weight bridge; an FP voice's ``FP_predictor``
    (``w_1``, ``w_2``, ``fc`` outside the scopes) stays whole."""
    from kantts_tpu_torch.models.sambert.sambert import KanTtsSAMBERT

    params = sambert_params(load_yaml(os.path.join(CONFIGS, f"{name}.yaml")))
    with torch.device("meta"):
        model = KanTtsSAMBERT(params)
    plan = tp.tp_plan(model, 2)
    assert plan and set(plan) == _jax_sharded_keys(model, params, 2)
    assert not [k for k in plan if k.startswith("FP_predictor")]
    assert params.get("FP", False) == any(k.startswith("FP_predictor")
                                          for k in model.state_dict())


# ----------------------------------------------------------- the steps


def _identity_dropout(rate, deterministic=None, **_):
    return lambda x, *args, **kw: x


_JAX_STEPS = {}  # one compiled JAX step per config, whatever its weights


def _jax_voice_step(cfg, state_dict, batch, fp_dict=None):
    """The JAX package's unsharded train step on the bridged weights and a
    numpy batch -> (metrics, params after the step). The port's steps run
    with every dropout at 0; the JAX ``Prenet`` hard-codes its 0.5, so flax's
    ``Dropout`` is the identity while the step is traced. Compiled with every
    bf16 op rounded (``xla_allow_excess_precision`` off, as
    ``tests/test_torch_port_bf16.py`` compiles its JAX side)."""
    import flax.linen
    import jax
    import jax.numpy as jnp

    from kantts_tpu.losses import criterion_builder as j_criterion_builder
    from kantts_tpu.models.sambert.sambert import KanTtsSAMBERT as JSAMBERT
    from kantts_tpu.train.optim import optimizer_builder as j_optimizer_builder
    from kantts_tpu.train.states import TrainState
    from kantts_tpu.train.steps import make_sambert_step as j_make_sambert_step
    from kantts_tpu.utils.torch_convert import convert_sambert

    params_cfg = sambert_params(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, convert_sambert(
        {k: v.numpy() for k, v in state_dict.items()}, params_cfg))
    part = cfg["Model"]["KanTtsSAMBERT"]
    tx, _ = j_optimizer_builder(part["optimizer"], part.get("scheduler"), cfg["grad_norm"])
    state = TrainState(params, tx.init(params), jnp.asarray(0, dtype=jnp.int32))
    args = (state, {k: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple)
                        else jnp.asarray(v)) for k, v in batch.items() if v is not None},
            jax.random.PRNGKey(0), jnp.asarray(EPOCH))
    key = json.dumps([params_cfg, part, cfg["Loss"], cfg["grad_norm"],
                      fp_dict is not None], sort_keys=True, default=str)
    if key not in _JAX_STEPS:
        step = j_make_sambert_step(JSAMBERT(params_cfg), j_criterion_builder(cfg), tx,
                                   params_cfg["MAS"], params_cfg.get("FP", False),
                                   fp_dict_lings=fp_dict)
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(flax.linen, "Dropout", _identity_dropout)
            _JAX_STEPS[key] = step.lower(*args).compile(
                {"xla_allow_excess_precision": False})
    new, metrics = _JAX_STEPS[key](*args)
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree_util.tree_map(np.asarray, new.params))


def _jax_step(cfg, state_dict, items, lengths):
    """``_jax_voice_step`` on the MAS batch of ``items`` -> (TotalLoss,
    params after the step)."""
    metrics, params = _jax_voice_step(cfg, state_dict, sambert_batch(items, lengths))
    return metrics["TotalLoss"], params


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, np.asarray(v)


def _plain_step(cfg, items, lengths):
    """The port's one-process step on the global batch -> (metrics, pre-clip
    gradients, pre-clip norm)."""
    built = seeded_sambert(cfg)
    seen = {}

    def recorded_clip():
        seen["grads"] = {k: p.grad.clone() for k, p in built["model"].named_parameters()
                         if p.grad is not None}
        seen["norm"] = float(built["clip"]())

    step = make_sambert_step(built["model"], criterion_builder(cfg), built["optimizer"],
                             built["scheduler"], recorded_clip, True, data_parallel=False)
    metrics = step(_tensors(sambert_batch(items, lengths)), EPOCH)
    return {k: float(v) for k, v in metrics.items()}, seen["grads"], seen["norm"]


def _bridge(cfg):
    """Port state dict -> the JAX params it bridges to, flattened."""
    from kantts_tpu.utils.torch_convert import convert_sambert

    return lambda sd: dict(_flat(convert_sambert({k: v.numpy() for k, v in sd.items()},
                                                 sambert_params(cfg))))


def _voice_reference(voice, batch, fp_dict, outdir):
    """The JAX step (and for bf16 the JAX f32 step) and the port's plain
    step on the voice's weights and batch."""
    plain, init = _plain_voice_step(voice, batch, fp_dict, outdir)
    cfg = voice_config(voice)
    metrics, params = _jax_voice_step(cfg, init, batch, fp_dict)
    out = dict(plain=plain, jax=(metrics, dict(_flat(params))), bridge=_bridge(cfg))
    if cfg.get("mixed_precision"):
        out["jax_f32"] = _jax_voice_step(dict(cfg, mixed_precision=False), init, batch,
                                         fp_dict)
    return out


@pytest.fixture(scope="module")
def references(workers):
    """The JAX step and the port's plain step on the global batch, and on
    each voice's (``_voice_reference``), computed while the workers run."""
    running, _ = workers
    cfg = config()
    items, lengths = global_batch(cfg)
    init = seeded_sambert(cfg)["model"].state_dict()
    loss, params = _jax_step(cfg, init, items, lengths)
    voices = {voice: _voice_reference(voice, *running.voices[voice], running.outdir)
              for voice in VOICES}
    return dict(cfg=cfg, jax_loss=loss, jax_params=dict(_flat(params)),
                plain=_plain_step(cfg, items, lengths), lengths=lengths,
                bridge=_bridge(cfg), voices=voices)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_step_matches_jax_and_plain(workers, references, grid):
    """Rank 0's step on each grid against the JAX package's unsharded step
    (loss rtol 1e-5, parameters atol 3e-4) and the port's plain step
    (pre-clip gradients within 1e-5 of their norm, the norm rtol 1e-5)."""
    got = workers[0].wait()[grid]
    n_data, n_model = GRIDS[grid]
    assert got["grid"] == (0, 0)
    assert tuple(got["lengths"]) == tuple(references["lengths"])
    np.testing.assert_allclose(got["metrics"]["TotalLoss"], references["jax_loss"],
                               rtol=1e-5)
    mapped = references["bridge"](got["state"])
    assert mapped.keys() == references["jax_params"].keys()
    for k, want in references["jax_params"].items():
        np.testing.assert_allclose(mapped[k], want, atol=3e-4, rtol=0, err_msg=k)
    metrics, grads, norm = references["plain"]
    assert got["metrics"]["TotalLoss"] == pytest.approx(metrics["TotalLoss"], rel=1e-5)
    assert got["norm"] == pytest.approx(norm, rel=1e-5) and norm > 0.1
    assert got["grads"].keys() == grads.keys()
    worst = max(float((got["grads"][k] - g).abs().max()) for k, g in grads.items())
    assert worst <= 1e-5 * norm, (worst, norm)


def test_tp_checkpoint_loads_plain_bit_for_bit(workers):
    """The gathered state of the 1 x 2 grid loads into a plain model and
    optimizer as it is; a plain state loaded into the sharded model gathers
    back bit for bit, optimizer moments included; each rank ran 1 of 2
    heads."""
    got = workers[0].wait()["tp_1x2"]
    cfg = config()
    plain = seeded_sambert(cfg)
    plain["model"].load_state_dict(got["checkpoint"]["model"], strict=True)
    plain["optimizer"].load_state_dict(got["checkpoint"]["optimizer"])
    for k, v in plain["model"].state_dict().items():
        assert torch.equal(v, got["state"][k]), k
    for k, v in seeded_sambert(cfg)["model"].state_dict().items():
        assert torch.equal(got["reloaded"][k], v), k
    want, have = got["checkpoint"]["optimizer"]["state"], got["reloaded_optimizer"]["state"]
    assert want.keys() == have.keys()
    for i, entry in want.items():
        for k, v in entry.items():
            assert torch.equal(have[i][k], v), (i, k)
    assert got["local_heads"] == SAMBERT_TINY["encoder_num_heads"] // 2


# ----------------------------------------------------------- the voices


def _plain_voice_step(voice, batch, fp_dict, outdir):
    """The port's one-process step of the voice -> (metrics, pre-clip
    gradients, pre-clip norm), and its initial weights."""
    cfg = voice_config(voice)
    built, _ = voice_model(voice, outdir)
    init = copy.deepcopy(built["model"].state_dict())
    seen = {}

    def recorded_clip():
        seen["grads"] = {k: p.grad.clone() for k, p in built["model"].named_parameters()
                         if p.grad is not None}
        seen["norm"] = float(built["clip"]())

    step = make_sambert_step(built["model"], criterion_builder(cfg), built["optimizer"],
                             built["scheduler"], recorded_clip, sambert_params(cfg)["MAS"],
                             fp_dict_lings=None if fp_dict is None else torch.from_numpy(fp_dict),
                             data_parallel=False)
    metrics = step(voice_tensors(batch), EPOCH)
    return ({k: float(v) for k, v in metrics.items()}, seen["grads"], seen["norm"]), init


BF16_LOSSES = ("mel_loss_", "mel_loss", "dur_loss", "pitch_loss", "energy_loss",
               "attn_ctc_loss", "attn_kl_loss", "TotalLoss")


@pytest.mark.parametrize("voice", list(VOICES))
def test_voice_tp_step_matches_jax_and_plain(workers, references, voice):
    """Rank 0's tensor-parallel step of each voice on the 1 x 2 grid against
    the JAX package's unsharded step on the same bridged weights and batch,
    and the port's plain step. float32: loss rtol 1e-5, parameters atol
    3e-4, pre-clip gradients within 1e-5 of their norm. bf16: every loss
    within 0.5 e_ref of JAX bf16 (e_ref = |JAX bf16 - JAX f32|; the
    attention losses, float32 in both, rtol 1e-5), parameters atol 3e-4,
    gradients within 1e-3 of their norm (bf16 roundings of float32 sums
    taken in another order). The warm start's encoder arrives as each
    rank's slice of the Textsy-BERT tensors."""
    got = workers[0].wait()["voices"][voice]
    ref = references["voices"][voice]
    want, want_params = ref["jax"]
    if voice == "bf16":
        f32, _ = ref["jax_f32"]
        assert want["TotalLoss"] != f32["TotalLoss"]  # else the test cannot see bf16
        for k in BF16_LOSSES:  # the attention losses stay float32: e_ref 0
            e_ref = abs(want[k] - f32[k])
            gap = abs(got["metrics"][k] - want[k])
            bound = 0.5 * e_ref if e_ref > 0 else 1e-5 * abs(want[k])
            assert gap <= bound, f"{k}: gap {gap}, e_ref {e_ref}"
    else:
        np.testing.assert_allclose(got["metrics"]["TotalLoss"], want["TotalLoss"], rtol=1e-5)
    if voice == "fp":
        assert got["metrics"]["fp_loss"] > 0
    mapped = ref["bridge"](got["state"])
    assert mapped.keys() == want_params.keys()
    for k, w in want_params.items():
        np.testing.assert_allclose(mapped[k], w, atol=3e-4, rtol=0, err_msg=k)
    metrics, grads, norm = ref["plain"]
    grad_tol = 1e-3 if voice == "bf16" else 1e-5
    assert got["metrics"]["TotalLoss"] == pytest.approx(metrics["TotalLoss"],
                                                        rel=grad_tol)
    assert got["norm"] == pytest.approx(norm, rel=grad_tol) and norm > 0.1
    assert got["grads"].keys() == grads.keys()
    worst = max(float((got["grads"][k] - g).abs().max()) for k, g in grads.items())
    assert worst <= grad_tol * norm, (worst, norm)
    if voice == "warm":
        assert got["warm"]["copied"] > 0 and got["warm"]["sliced"] > 0
        assert got["warm"]["equal"]


# ------------------------------------------------------------- F6: the crash


def test_crash_checkpoint_under_tensor_parallelism(workers):
    """Both ranks interrupted at step k: the whole ``checkpoint-{k}.ckpt``
    holds the state ``gather_state_dict`` and ``gather_optimizer_state``
    return at step k, bit for bit, and no slice is left; it loads into a
    plain model and through the JAX bridge as an interval save does, and a
    resume from it under ``tensor_parallel: 2`` runs from step k + 1. The
    run was warm-started from Textsy-BERT."""
    from kantts_tpu.utils.torch_convert import convert_sambert

    running, _ = workers
    got = running.wait()["crash"]
    ckpt = os.path.join(running.outdir, "crash_stage", "ckpt")
    path = os.path.join(ckpt, f"checkpoint-{CRASH_STEP}.ckpt")
    assert sorted(os.listdir(ckpt)) == [os.path.basename(path)]
    payload = torch.load(path, weights_only=True)
    assert list(payload) == ["model", "config", "optimizer", "scheduler", "steps"]
    assert payload["steps"] == CRASH_STEP and got["handler_s"] < 10
    want = got["gathered"]
    assert payload["model"].keys() == want["model"].keys()
    for k, v in want["model"].items():
        assert torch.equal(payload["model"][k], v), k
    assert payload["optimizer"]["param_groups"] == want["optimizer"]["param_groups"]
    assert payload["optimizer"]["state"].keys() == want["optimizer"]["state"].keys()
    for i, entry in want["optimizer"]["state"].items():
        for k, v in entry.items():
            assert torch.equal(payload["optimizer"]["state"][i][k], v), (i, k)
    model, _ = load_checkpoint(path, torch.device("cpu"))
    assert model.text_encoder.ling_enc.fft[0].slf_attn.n_head == SAMBERT_TINY["encoder_num_heads"]
    cfg = payload["config"]["Model"]["KanTtsSAMBERT"]["params"]
    shapes = {k: v.shape for k, v in _flat(convert_sambert(
        {k: v.numpy() for k, v in payload["model"].items()}, cfg))}
    plain = seeded_sambert(config())["model"].state_dict()
    assert shapes == {k: v.shape for k, v in _flat(convert_sambert(
        {k: v.numpy() for k, v in plain.items()}, cfg))}
    assert got["resumed_steps"] == [CRASH_STEP + 1] and got["resumed_taken"] == 1
    assert os.path.exists(os.path.join(running.outdir, "crash_resume_stage", "ckpt",
                                       f"checkpoint_{CRASH_STEP + 1}.ckpt"))
    with open(os.path.join(running.outdir, "crash_stage", "stdout.log")) as f:
        log = f.read()
    assert "Warm-started the text encoder" in log
    assert f"Saved crash checkpoint at step {CRASH_STEP}, joined from 2 slices" in log


def test_crash_with_a_missing_slice_writes_no_whole_file(workers):
    """Rank 1 interrupted without writing its slice: rank 0 gives up after
    its 2 s, names rank 1 in the log, writes no whole file and leaves its
    own slice."""
    running, _ = workers
    got = running.wait()["crash"]
    stage = os.path.join(running.outdir, "crash_missing")
    assert sorted(os.listdir(os.path.join(stage, "ckpt"))) == [
        f"checkpoint-{CRASH_STEP}.rank0-of-2.ckpt"]
    assert 2.0 <= got["missing_handler_s"] < 6.0
    with open(os.path.join(stage, "stdout.log")) as f:
        log = f.read()
    assert f"cannot join checkpoint-{CRASH_STEP}.ckpt: rank 1 (no slice)" in log


def test_crash_checkpoint_from_the_cli_under_torchrun(workers):
    """The tensor-parallel CLI under torchrun, interrupted on both ranks at
    step k, with rank 0's join held back 2 s: torchrun fails, as it does for
    an interrupted CLI, and the whole ``checkpoint-{k}.ckpt`` has landed
    all the same, with no slice left, and loads into a plain model: rank 1
    stayed until the join was done, so torchrun did not stop rank 0 in it."""
    running, _ = workers
    rc, out = running.wait_torchrun()
    assert rc != 0, out[-4000:]
    stage = os.path.join(running.outdir, "torchrun_crash_stage")
    ckpt = os.path.join(stage, "ckpt")
    assert sorted(os.listdir(ckpt)) == [f"checkpoint-{CRASH_STEP}.ckpt"], out[-4000:]
    path = os.path.join(ckpt, f"checkpoint-{CRASH_STEP}.ckpt")
    assert torch.load(path, weights_only=True)["steps"] == CRASH_STEP
    model, _ = load_checkpoint(path, torch.device("cpu"))
    assert model.text_encoder.ling_enc.fft[0].slf_attn.n_head == SAMBERT_TINY["encoder_num_heads"]
    with open(os.path.join(stage, "stdout.log")) as f:
        log = f.read()
    assert f"Saved crash checkpoint at step {CRASH_STEP}, joined from 2 slices" in log


def _split_state():
    """A tiny model's state after one Adam step, and each rank's slice of
    it as ``local_slice`` holds it, split by ``split``."""
    cfg = config()
    built = seeded_sambert(cfg)
    model, optimizer = built["model"], built["optimizer"]
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    optimizer.step()
    plan = tp.tp_plan(model, 2)
    names = [k for k, _ in model.named_parameters()]
    sd, opt = model.state_dict(), optimizer.state_dict()
    slices = [dict(
        model={k: (tp.split(v, plan[k], 2, r) if k in plan else v) for k, v in sd.items()},
        optimizer={**opt, "state": {i: {k: (tp.split(v, plan[names[i]], 2, r)
                                            if names[i] in plan and v.ndim else v)
                                        for k, v in e.items()}
                                    for i, e in opt["state"].items()}},
        plan={k: (s.kind, s.dim, s.chunks) for k, s in plan.items()},
        optimizer_plan={i: names[i] for i in opt["state"] if names[i] in plan},
        index=r) for r in range(2)]
    return sd, opt, slices


def test_join_slices_inverts_split():
    """``join_slices`` of the ``split`` of every planned entry (model and
    Adam moments) gives the whole state back, whatever the slices' order."""
    sd, opt, slices = _split_state()
    joined, joined_opt = tp.join_slices(slices[::-1])
    assert joined.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(joined[k], v), k
    for i, entry in opt["state"].items():
        for k, v in entry.items():
            assert torch.equal(joined_opt["state"][i][k], v), (i, k)
    assert tp.slice_path("/s/ckpt/checkpoint-7.ckpt", 1, 2) == "/s/ckpt/checkpoint-7.rank1-of-2.ckpt"


@pytest.mark.parametrize("replaced", [True, False])
def test_join_slice_files_never_joins_another_runs_slice(tmp_path, caplog, replaced):
    """Rank 1's slice of an earlier run at the same step and config lies
    where this run's goes: ``join_slice_files`` does not join it. Replaced
    0.3 s later by this run's, the join waits for it and is whole; left
    alone, the join gives up at its timeout, writes nothing and names it."""
    import threading

    sd, _, slices = _split_state()
    extra = dict(config={"k": 1}, scheduler={}, steps=CRASH_STEP)
    path = str(tmp_path / f"checkpoint-{CRASH_STEP}.ckpt")
    write_checkpoint(dict(slices[0], run=7, **extra), tp.slice_path(path, 0, 2))
    stale = dict(slices[1], run=6, **extra)
    stale["model"] = {k: torch.zeros_like(v) for k, v in stale["model"].items()}
    write_checkpoint(stale, tp.slice_path(path, 1, 2))
    fresh = threading.Timer(0.3, write_checkpoint, (dict(slices[1], run=7, **extra),
                                                    tp.slice_path(path, 1, 2)))
    if replaced:
        fresh.start()
    t0 = time.perf_counter()
    payload = tp.join_slice_files(path, 2, 1.5, CRASH_STEP, {"k": 1}, run=7)
    waited = time.perf_counter() - t0
    if replaced:
        fresh.join()
        assert 0.3 <= waited < 1.5
        for k, v in sd.items():
            assert torch.equal(payload["model"][k], v), k
    else:
        assert payload is None and waited >= 1.5
        assert "rank 1 (a slice of another run or step)" in caplog.text


# ------------------------------------------------------ sequence parallelism


@pytest.mark.parametrize("causal", [True, False])
def test_sequence_parallel_matches_jax(workers, causal):
    """The time-sharded generator forward over 2 ranks against the JAX
    generator on the whole utterance, atol 1e-5."""
    import jax.numpy as jnp

    from kantts_tpu.models.hifigan.generator import Generator as JGenerator
    from test_hifigan import CFG_16K as JAX_CFG_16K

    assert CFG_16K == JAX_CFG_16K
    running, jax_gens = workers
    cfg, params = jax_gens[causal]
    mel = sp_mel().numpy()
    want = np.asarray(JGenerator(**cfg).apply({"params": params}, jnp.asarray(mel)))
    got = running.wait()[f"sp_{causal}"].numpy()
    assert got.shape == want.shape == (1, SP_FRAMES * 200, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_nsf_sequence_parallel_matches_jax(workers, causal):
    """A tiny NSF generator, causal and not, time-sharded over 2 ranks with
    its source given (``excitation=``) and drawn on rank 0 and broadcast
    (the same seed): both against the JAX generator on the whole utterance
    with that excitation, atol 1e-5; the windows' context (the receptive
    field plus the 4-frame source margin) leaves no seam."""
    import jax.numpy as jnp

    from kantts_tpu.models.hifigan.generator import Generator as JGenerator
    from test_torch_port_nsf import nsf_generator_cfg

    assert nsf_sp_cfg(causal) == nsf_generator_cfg(causal)
    running, jax_gens = workers
    cfg, params, port = jax_gens[f"nsf_{causal}"]
    mel = nsf_sp_mel()
    with torch.no_grad():
        exc = nsf_excitation(port, mel)
        assert torch.equal(exc, nsf_excitation(port, mel))
        plain = port(mel, excitation=exc).numpy()
    want = np.asarray(JGenerator(**cfg).apply({"params": params}, jnp.asarray(mel.numpy()),
                                              excitation=jnp.asarray(exc.numpy())))
    np.testing.assert_allclose(plain, want, atol=1e-5, rtol=0)
    got = running.wait()[f"nsf_sp_{causal}"]
    hop = int(np.prod(cfg["upsample_scales"]))
    for route in ("given", "broadcast"):
        assert got[route].shape == want.shape == (1, NSF_FRAMES * hop, 1)
        np.testing.assert_allclose(got[route].numpy(), want, atol=1e-5, rtol=0,
                                   err_msg=route)


def test_time_sharded_windows():
    """Each rank's window holds real frames only, with the halo on the left
    (and the right without causality) where the utterance has them."""
    mel = torch.arange(10.0).reshape(1, 10, 1)
    assert [(w[0, :, 0].tolist(), lead, n) for w, lead, n in
            (tp.time_sharded(mel, 3, i, 2, True) for i in range(3))] == [
        ([0, 1, 2, 3], 0, 4), ([2, 3, 4, 5, 6, 7], 2, 4), ([6, 7, 8, 9], 2, 2)]
    w, lead, n = tp.time_sharded(mel, 3, 1, 2, False)
    assert (w[0, :, 0].tolist(), lead, n) == ([2, 3, 4, 5, 6, 7, 8, 9], 2, 4)
    assert tp.time_sharded(mel, 4, 3, 2, True)[2] == 1


# ----------------------------------------------------------- the pipeline


def _jax_encoder_tree(sd):
    from kantts_tpu.utils.torch_convert import _fft_block, _layernorm

    sd = {k: v.detach().numpy() for k, v in sd.items()}
    tree = {}
    for i in range(ENC["n_layer"]):
        _fft_block(tree, f"fft_{i}", sd, f"fft.{i}")
    _layernorm(tree, "ln", sd, "ln")
    return tree


def test_pipeline_matches_jax_and_sequential(workers):
    """The 2-stage, 4-microbatch encoder on every stage against the JAX
    ``SelfAttentionEncoder.apply`` (atol 1e-5); its gradients, each stage's
    layers summed over the stages, against the port's sequential encoder
    (atol 1e-5), the input's on stage 0."""
    import jax.numpy as jnp

    from kantts_tpu.models.sambert.sambert import SelfAttentionEncoder as JEncoder

    enc = port_encoder()
    x, mask = encoder_inputs()
    want, _ = JEncoder(**ENC).apply({"params": _jax_encoder_tree(enc.state_dict())},
                                   jnp.asarray(x.numpy()), jnp.asarray(mask.numpy()))
    got = workers[0].wait()["pp"]
    assert got["stage"] == 0
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)

    x.requires_grad_()
    out, _ = enc(x, mask)
    out.square().sum().backward()
    for k, p in enc.named_parameters():
        np.testing.assert_allclose(got["grads"][k].numpy(), p.grad.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["x_grad"].numpy(), x.grad.numpy(), atol=1e-5, rtol=1e-5)


def test_pipeline_rejects_bad_folds():
    pipe = pp.PipeGroup(None, [0, 1, 2, 3], 0)
    with pytest.raises(ValueError, match="6 layers do not fold onto 4"):
        pp.pipeline_apply(lambda p, h, e: h, {"w": torch.zeros(6, 3, 3)},
                          torch.zeros(8, 3), 4, pipe)
    with pytest.raises(ValueError, match="batch 6 not divisible by 4"):
        pp.pipeline_apply(lambda p, h, e: h, {"w": torch.zeros(8, 3, 3)},
                          torch.zeros(6, 3), 4, pipe)


def test_stack_layer_params_layout():
    enc = port_encoder()
    stacked = pp.stack_layer_params(dict(enc.named_parameters()), "fft.", ENC["n_layer"])
    w = stacked["slf_attn.w_qkv.weight"]
    assert w.shape[0] == ENC["n_layer"]
    for i in range(ENC["n_layer"]):
        assert torch.equal(w[i], enc.fft[i].slf_attn.w_qkv.weight)


# ----------------------------------------------------------------- the CLI


def test_train_sambert_cli_tensor_parallel(workers):
    """``tensor_parallel: 2`` under two gloo ranks against the plain CLI on
    the same corpus (parameters atol 3e-4); rank 1 writes nothing; the
    checkpoint, unsharded, loads into a plain model and through the JAX
    bridge as the plain run's does."""
    from kantts_tpu.utils.torch_convert import convert_sambert

    running, _ = workers
    running.wait()
    outdir = running.outdir
    stage = os.path.join(outdir, "plain_stage")
    got_path = os.path.join(outdir, "cli_stage", "ckpt", "checkpoint_2.ckpt")
    got = torch.load(got_path, weights_only=True)
    want = torch.load(os.path.join(stage, "ckpt", "checkpoint_2.ckpt"), weights_only=True)
    assert got["model"].keys() == want["model"].keys()
    for k, v in want["model"].items():
        np.testing.assert_allclose(got["model"][k].numpy(), v.numpy(), atol=3e-4, rtol=0,
                                   err_msg=k)
    model, _ = load_checkpoint(got_path, torch.device("cpu"))
    assert model.text_encoder.ling_enc.fft[0].slf_attn.n_head == SAMBERT_TINY["encoder_num_heads"]
    cfg = got["config"]["Model"]["KanTtsSAMBERT"]["params"]
    shapes = {k: v.shape for k, v in _flat(convert_sambert(
        {k: v.numpy() for k, v in got["model"].items()}, cfg))}
    assert shapes == {k: v.shape for k, v in _flat(convert_sambert(
        {k: v.numpy() for k, v in want["model"].items()}, cfg))}
    with open(os.path.join(outdir, "cli_stage", "stdout.log")) as f:
        log = f.read()
    assert "tensor parallel: 2-way over the model group, 1 data ranks" in log
    writes = [json.load(open(os.path.join(outdir, f"cli_writes_rank{r}.json")))
              for r in range(2)]
    assert writes[1] == []
    assert any("checkpoint_2.ckpt" in w for w in writes[0])


if __name__ == "__main__" and sys.argv[1] == "worker":
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
if __name__ == "__main__" and sys.argv[1] == "interrupted-cli":
    interrupted_cli(sys.argv[2], sys.argv[3])

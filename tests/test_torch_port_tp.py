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
from kantts_tpu_torch.losses import criterion_builder
from kantts_tpu_torch.models.builder import load_checkpoint, sambert_model_builder
from kantts_tpu_torch.models.hifigan.generator import Generator
from kantts_tpu_torch.models.sambert.sambert import SelfAttentionEncoder
from kantts_tpu_torch.parallel import mesh, pp, tp
from kantts_tpu_torch.train.steps import make_sambert_step
from kantts_tpu_torch.utils.corpus import write_mas_corpus
from test_torch_port_ddp import (
    SAMBERT_TINY,
    SHARDS,
    _free_port,
    _no_dropout,
    _tensors,
    sambert_batch,
    sambert_config,
    sambert_items,
    sambert_lengths,
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


def cli_config(path, **keys):
    cfg = config(batch_size=4, train_max_steps=2, save_interval_steps=2,
                 eval_interval_steps=2, log_interval_steps=1, **keys)
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


def worker(rank: int, port: int, outdir: str, data: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    mesh.distributed_init("cpu")
    results = {name: grid_step(name, outdir) for name in GRIDS}

    ready = os.path.join(outdir, "generators_ready")
    while not os.path.exists(ready):  # the test process writes them meanwhile
        time.sleep(0.1)
    for causal in (True, False):
        gen = Generator(**sp_generator_cfg(causal)).eval()
        gen.load_state_dict(torch.load(os.path.join(outdir, f"gen_{causal}.pt")))
        results[f"sp_{causal}"] = tp.sequence_parallel_apply(gen, sp_mel())

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

    logging.basicConfig(level=logging.INFO, force=True)  # as the CLI's __main__ sets it
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
        self.done = None

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

    def stop(self):
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
    running = Workers(str(outdir), data)
    jax_gens = {}
    for causal in (True, False):
        cfg = sp_generator_cfg(causal)
        gen = Generator(**cfg)
        init_parameters(gen, 5)
        sd = gen.state_dict()
        torch.save(sd, str(outdir / f"gen_{causal}.pt"))
        jax_gens[causal] = (cfg, convert_hifigan_generator(
            {k: v.numpy() for k, v in sd.items()}, cfg))
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
    probe = {k: np.full(tuple(v.shape), float(i), np.float32)
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
    from kantts_tpu_torch.models.builder import sambert_params

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
    from kantts_tpu_torch.models.builder import sambert_params

    cfg = config()
    model = seeded_sambert(cfg)["model"]
    plan = tp.tp_plan(model, 4)
    jax_keys = _jax_sharded_keys(model, sambert_params(cfg), 4)
    attention = {k for k in jax_keys if ".slf_attn." in k or ".pnca_attn." in k}
    assert attention and not attention & set(plan)
    assert set(plan) == jax_keys - attention


# ----------------------------------------------------------- the steps


def _identity_dropout(rate, deterministic=None, **_):
    return lambda x, *args, **kw: x


def _jax_step(cfg, state_dict, items, lengths):
    """The JAX package's unsharded train step on the bridged weights and the
    global batch -> (TotalLoss, params after the step). The port's steps run
    with every dropout at 0; the JAX ``Prenet`` hard-codes its 0.5, so flax's
    ``Dropout`` is the identity while the step is traced."""
    import flax.linen
    import jax
    import jax.numpy as jnp

    from kantts_tpu.losses import criterion_builder as j_criterion_builder
    from kantts_tpu.models.sambert.sambert import KanTtsSAMBERT as JSAMBERT
    from kantts_tpu.train.optim import optimizer_builder as j_optimizer_builder
    from kantts_tpu.train.states import TrainState
    from kantts_tpu.train.steps import make_sambert_step as j_make_sambert_step
    from kantts_tpu.utils.torch_convert import convert_sambert
    from kantts_tpu_torch.models.builder import sambert_params

    params_cfg = sambert_params(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, convert_sambert(
        {k: v.numpy() for k, v in state_dict.items()}, params_cfg))
    part = cfg["Model"]["KanTtsSAMBERT"]
    tx, _ = j_optimizer_builder(part["optimizer"], part.get("scheduler"), cfg["grad_norm"])
    state = TrainState(params, tx.init(params), jnp.asarray(0, dtype=jnp.int32))
    step = j_make_sambert_step(JSAMBERT(params_cfg), j_criterion_builder(cfg), tx,
                               True, False)
    batch = {k: jnp.asarray(v) for k, v in sambert_batch(items, lengths).items()}
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(flax.linen, "Dropout", _identity_dropout)
        new, metrics = step(state, batch, jax.random.PRNGKey(0), jnp.asarray(EPOCH))
    return float(metrics["TotalLoss"]), jax.tree_util.tree_map(np.asarray, new.params)


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


@pytest.fixture(scope="module")
def references():
    """The JAX step and the port's plain step on the global batch."""
    from kantts_tpu.utils.torch_convert import convert_sambert
    from kantts_tpu_torch.models.builder import sambert_params

    cfg = config()
    items, lengths = global_batch(cfg)
    init = seeded_sambert(cfg)["model"].state_dict()
    loss, params = _jax_step(cfg, init, items, lengths)
    return dict(cfg=cfg, jax_loss=loss, jax_params=dict(_flat(params)),
                plain=_plain_step(cfg, items, lengths), lengths=lengths,
                bridge=lambda sd: dict(_flat(convert_sambert(
                    {k: v.numpy() for k, v in sd.items()}, sambert_params(cfg)))))


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

"""The port's training and utils tooling on the CPU: ``utils/profiling.py``
(``trace``, ``span``, the trainers' phase spans), ``utils/plot.py``
against the JAX package's figures, the checkpoint write path
(``models/builder.py::write_checkpoint``, the trainer's ``HostSnapshot``
and ``AsyncCheckpointWriter``), and the trainer's TensorBoard scalars, on
a toy trainer whose steps are exact, so that its asynchronous and
synchronous runs must write equal files.

Also the helpers the ``train_sambert`` and ``train_hifigan`` CLI tests use
to compare checkpoints tensor by tensor and to read TensorBoard events
back.
"""

import json
import logging
import os
import re
import threading

import numpy as np
import pytest
import torch

from kantts_tpu.utils import plot as j_plot
from kantts_tpu_torch.models import builder
from kantts_tpu_torch.models.builder import checkpoint_payload, write_checkpoint
from kantts_tpu_torch.train import trainer as trainer_mod
from kantts_tpu_torch.train.trainer import (
    AsyncCheckpointWriter,
    HostSnapshot,
    Trainer,
    prune_checkpoints,
    run,
)
from kantts_tpu_torch.utils import plot as t_plot
from kantts_tpu_torch.utils import profiling


# ----------------------------------------------------------------- helpers


@pytest.fixture
def torch_one_thread():
    """torch on one thread for the test, for training runs whose checks do
    not depend on it: with the suite in six worker processes on an 8-core
    CPU, each worker's torch taking a thread a core, such a run slowed by
    up to 100x (the GAN CLI test: 5 s alone, 501-629 s in the suite, 39 s
    on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, key=()):
    if isinstance(tree, torch.Tensor):
        yield key, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, key + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, key + (i,))
    else:
        yield key, tree


def assert_same_checkpoint(a: str, b: str, skip=("config",)) -> None:
    """Every tensor of the two files equal bit for bit (dtype, shape and
    bytes), every other leaf equal, the top-level entries in ``skip``
    aside."""
    pa, pb = (torch.load(p, map_location="cpu", weights_only=True) for p in (a, b))
    assert set(pa) == set(pb)
    la = dict(_leaves({k: v for k, v in pa.items() if k not in skip}))
    lb = dict(_leaves({k: v for k, v in pb.items() if k not in skip}))
    assert la.keys() == lb.keys()
    for key, va in la.items():
        vb = lb[key]
        if isinstance(va, torch.Tensor):
            assert va.dtype == vb.dtype and va.shape == vb.shape, key
            assert torch.equal(va.reshape(-1).view(torch.uint8),
                               vb.reshape(-1).view(torch.uint8)), key
        else:
            assert va == vb, key


LOGGED = re.compile(r"^\(Steps: (\d+)\) (\S+) = (\S+)\.$")


def logged_means(records) -> dict:
    """{(tag, step): value} from the trainer's INFO lines of the log
    interval's and the eval's means (``steps_per_sec`` is the tag
    ``train/steps_per_sec``)."""
    out = {}
    for record in records:
        m = LOGGED.match(record.getMessage())
        if m:
            tag = "train/steps_per_sec" if m[2] == "steps_per_sec" else m[2]
            out[(tag, int(m[1]))] = float(m[3])
    return out


def event_scalars(log_dir: str):
    """{(tag, step): value} of the TensorBoard events in ``log_dir``, read
    with tensorboard's own reader; None when tensorboard is not installed."""
    try:
        from tensorboard.backend.event_processing.event_accumulator import (
            EventAccumulator,
        )
    except ImportError:
        return None
    acc = EventAccumulator(log_dir)
    acc.Reload()
    return {(tag, e.step): e.value for tag in acc.Tags()["scalars"]
            for e in acc.Scalars(tag)}


def assert_scalars_match_log(log_dir: str, records) -> None:
    """The events hold exactly the tags and steps the trainer logged, each
    value equal to the logged one to its printed digits (4 decimals, 3 for
    steps per second). Without tensorboard's reader there is nothing to
    read the events with, and nothing is checked."""
    events = event_scalars(log_dir)
    if events is None:
        return
    logged = logged_means(records)
    assert logged and events.keys() == logged.keys()
    for key, value in logged.items():
        digits = 5e-4 if key[0] == "train/steps_per_sec" else 5e-5
        assert abs(events[key] - value) <= digits + 1e-6 * abs(value), key


# --------------------------------------------------------------- profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.mm(a, a)
    assert os.path.dirname(prof.path) == str(tmp_path / "trace")
    with open(prof.path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def recorded_spans(prof, prefix="kantts."):
    """[(name, start, end)] of the spans named ``prefix...`` that a
    ``torch.profiler.profile`` recorded, in order of their start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith(prefix)),
                  key=lambda s: s[1])


def cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_span_costs_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler recording, ``span`` is the shared no-op and never
    enters ``record_function``; under one, it records the region."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        with profiling.span(profiling.GAN_STEP) as a, profiling.span("kantts.x.y") as b:
            torch.ones(2).sum()
        assert a is None and b is None
        assert profiling.span("kantts.x.y") is profiling.span(profiling.NSF_SOURCE)
    with cpu_profile() as prof:
        with profiling.span(profiling.NSF_SOURCE):
            torch.ones(2).sum()
    assert [s[0] for s in recorded_spans(prof)] == [profiling.NSF_SOURCE]


def test_trainer_phases_are_spans(tmp_path):
    """Each phase of the loop runs inside ``kantts.train.<phase>`` with the
    seconds log off: 6 steps of 3-batch epochs make one ``step`` span a
    step and one ``loader_wait`` a batch, plus one for the first epoch's
    end."""
    trainer = ToyTrainer(tmp_path, {})
    with cpu_profile() as prof:
        run(trainer)
    names = [s[0] for s in recorded_spans(prof, "kantts.train.")]
    assert not trainer.profile
    assert set(names) == {profiling.train_phase(p) for p in profiling.TRAIN_PHASES}
    assert names.count(profiling.train_phase("step")) == 6
    assert names.count(profiling.train_phase("loader_wait")) == 7


# -------------------------------------------------------------------- plot


def test_plots_are_the_jax_figures(tmp_path):
    """The three figures, drawn by both packages from the same arrays,
    are the same PNG bytes."""
    pytest.importorskip("matplotlib")
    rng = np.random.RandomState(0)
    cases = [("plot_spectrogram", (rng.rand(40, 80),), {}),
             ("plot_alignment", (rng.rand(40, 12),), {"info": "step 1"}),
             ("plot_waveform", (rng.randn(1600).astype(np.float32),),
              {"sample_rate": 16000})]
    assert t_plot.available()
    for name, args, kw in cases:
        paths = [str(tmp_path / f"{side}_{name}.png") for side in ("jax", "port")]
        getattr(j_plot, name)(*args, paths[0], **kw)
        getattr(t_plot, name)(*args, paths[1], **kw)
        with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
            want, got = f.read(), g.read()
        assert got[:8] == b"\x89PNG\r\n\x1a\n" and got == want, name


# ------------------------------------------------------------- checkpoints


def _payload(v: float, steps: int):
    return {"model": {"w": torch.full((3, 4), v)}, "config": {"a": 1}, "steps": steps}


def test_write_checkpoint_fsyncs_and_leaves_no_tmp(tmp_path, monkeypatch):
    synced = []
    real_fsync = os.fsync
    monkeypatch.setattr(builder.os, "fsync", lambda fd: synced.append(fd) or real_fsync(fd))
    path = str(tmp_path / "ckpt" / "checkpoint_1.ckpt")
    write_checkpoint(_payload(1.0, 1), path)
    assert len(synced) == 1
    assert os.listdir(tmp_path / "ckpt") == ["checkpoint_1.ckpt"]
    assert torch.load(path, weights_only=True)["steps"] == 1


@pytest.mark.parametrize("stage", ["save", "rename"])
def test_crash_mid_write_keeps_the_previous_checkpoint(tmp_path, monkeypatch, stage):
    path = str(tmp_path / "checkpoint_1.ckpt")
    write_checkpoint(_payload(1.0, 1), path)

    def boom(*args, **kwargs):
        raise OSError("boom")

    monkeypatch.setattr(builder.torch if stage == "save" else builder.os,
                        "save" if stage == "save" else "replace", boom)
    with pytest.raises(OSError, match="boom"):
        write_checkpoint(_payload(2.0, 2), path)
    monkeypatch.undo()
    loaded = torch.load(path, weights_only=True)
    assert loaded["steps"] == 1 and torch.equal(loaded["model"]["w"], torch.ones(3, 4))


def test_async_writer_writes_in_order(tmp_path):
    writer = AsyncCheckpointWriter()
    path = str(tmp_path / "checkpoint_10.ckpt")
    for v in (1.0, 2.0, 3.0):  # one queue, one thread: the last submit wins
        writer.submit(_payload(v, int(v)), path)
    writer.submit(_payload(7.0, 7), str(tmp_path / "checkpoint_20.ckpt"))
    writer.wait()
    assert torch.load(path, weights_only=True)["steps"] == 3
    assert torch.load(str(tmp_path / "checkpoint_20.ckpt"), weights_only=True)["steps"] == 7


def test_async_writer_raises_a_failed_write_again(tmp_path):
    writer = AsyncCheckpointWriter()
    blocker = tmp_path / "blocker"  # a file where the directory should be
    blocker.write_text("x")
    writer.submit(_payload(1.0, 1), str(blocker / "checkpoint_1.ckpt"))
    with pytest.raises(OSError):
        writer.wait()
    writer.submit(_payload(1.0, 1), str(blocker / "checkpoint_1.ckpt"))
    writer._queue.join()
    with pytest.raises(OSError):  # on the next submit too
        writer.submit(_payload(2.0, 2), str(tmp_path / "checkpoint_2.ckpt"))
    ok = str(tmp_path / "checkpoint_3.ckpt")  # and the writer goes on
    writer.submit(_payload(3.0, 3), ok)
    writer.wait()
    assert torch.load(ok, weights_only=True)["steps"] == 3


def test_async_writer_prunes_after_the_write_lands(tmp_path):
    """``after`` runs on the writer thread once the file is in place, so
    keep-last-1 keeps the new file."""
    writer = AsyncCheckpointWriter()
    seen = []
    for steps in (2, 4, 6):
        path = str(tmp_path / f"checkpoint_{steps}.ckpt")

        def after(path=path):
            seen.append((threading.current_thread().name, os.path.exists(path)))
            prune_checkpoints(str(tmp_path), 1)

        writer.submit(_payload(1.0, steps), path, after=after)
    writer.wait()
    assert seen == [("kantts-ckpt-writer", True)] * 3
    assert os.listdir(tmp_path) == ["checkpoint_6.ckpt"]


def test_host_snapshot_copies_and_reuses_its_buffers():
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    snap = HostSnapshot()
    payload = checkpoint_payload(model, {"c": [1, 2]}, optimizer=opt.state_dict(), steps=1)
    tree, ready = snap.take(payload)
    assert ready is None  # nothing on a device
    want = {k: v.clone() for k, v in _leaves(tree) if isinstance(v, torch.Tensor)}
    opt.step()  # updates the weights, moments and step counts in place
    for key, value in _leaves(tree):
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, want[key]), key
    assert tree["config"] == {"c": [1, 2]} and tree["config"] is not payload["config"]
    again, _ = snap.take(checkpoint_payload(model, {}, optimizer=opt.state_dict(), steps=2))
    assert again["model"]["weight"] is tree["model"]["weight"]
    assert torch.equal(again["model"]["weight"], model.weight.detach())


class _Loader(list):
    class sampler:  # noqa: N801 - the loaders' interface
        @staticmethod
        def set_epoch(epoch):
            pass


class ToyTrainer(Trainer):
    """Exact steps on a 4x3 weight with SGD and momentum; fails at
    ``fail_at``, if set."""

    def __init__(self, save_dir, config, fail_at=None, max_steps=6):
        batches = _Loader(torch.full((2, 3), float(i + 1)) for i in range(3))
        super().__init__(config, batches, _Loader(batches[:1]), str(save_dir),
                         torch.device("cpu"), max_steps=max_steps, save_interval=2,
                         valid_interval=3, log_interval=2)
        torch.manual_seed(0)
        self.model = torch.nn.Linear(3, 4)
        self.optimizer = torch.optim.SGD(self.model.parameters(), lr=0.25, momentum=0.5)
        self.fail_at = fail_at

    def to_device(self, batch):
        return batch

    def train_step(self, batch):
        if self.steps == self.fail_at:
            raise RuntimeError("step failed")
        self.optimizer.zero_grad()
        loss = self.model(batch).square().mean()
        loss.backward()
        self.optimizer.step()
        self.accumulate(self.total_train_loss, {"loss": loss.detach()}, "train")

    def eval_step(self, batch):
        with torch.no_grad():
            self.accumulate(self.total_eval_loss,
                            {"loss": self.model(batch).square().mean()}, "eval")

    def checkpoint_payload(self):
        return checkpoint_payload(self.model, self.config,
                                  optimizer=self.optimizer.state_dict(), steps=self.steps)


def _ckpts(stage):
    return sorted(os.listdir(os.path.join(stage, "ckpt")))


def test_async_run_writes_the_sync_checkpoints(tmp_path, caplog, monkeypatch):
    """Interval saves on the writer thread: the same files, bit for bit,
    the pruning after each write, the TensorBoard scalars of the log and
    eval intervals."""
    with caplog.at_level(logging.INFO):
        sync = run(ToyTrainer(tmp_path / "sync", {"keep_last_checkpoints": 2}))
    assert sync._ckpt_writer is None
    assert_scalars_match_log(str(tmp_path / "sync" / "log"), caplog.records)
    events = event_scalars(str(tmp_path / "sync" / "log"))
    if events is not None:
        assert set(events) == {("train/loss", 2), ("train/loss", 4), ("train/loss", 6),
                               ("train/steps_per_sec", 4), ("train/steps_per_sec", 6),
                               ("eval/loss", 3), ("eval/loss", 6)}
        evals = {step: means for kind, step, means in sync.history if kind == "eval"}
        assert events[("eval/loss", 6)] == np.float32(evals[6]["eval/loss"])
    written = []
    real_write = trainer_mod.write_checkpoint
    monkeypatch.setattr(trainer_mod, "write_checkpoint", lambda payload, path: (
        written.append((threading.current_thread().name, os.path.basename(path))),
        real_write(payload, path)))
    asyn = run(ToyTrainer(tmp_path / "async", {"keep_last_checkpoints": 2,
                                               "async_checkpoint": True}))
    assert written == [("kantts-ckpt-writer", f"checkpoint_{s}.ckpt") for s in (2, 4, 6)]
    assert _ckpts(tmp_path / "sync") == _ckpts(tmp_path / "async") == [
        "checkpoint_4.ckpt", "checkpoint_6.ckpt"]
    for name in _ckpts(tmp_path / "sync"):
        assert_same_checkpoint(str(tmp_path / "sync" / "ckpt" / name),
                               str(tmp_path / "async" / "ckpt" / name))
    assert [h[:2] for h in asyn.history] == [h[:2] for h in sync.history]


def test_crash_drains_the_writer_then_saves(tmp_path, monkeypatch):
    """A step fails after an asynchronous save: the pending write lands,
    then the crash checkpoint is written synchronously on the train
    thread; a failed pending write does not stop it."""
    trainer = ToyTrainer(tmp_path / "s", {"async_checkpoint": True}, fail_at=3)
    with pytest.raises(RuntimeError, match="step failed"):
        run(trainer)
    assert _ckpts(tmp_path / "s") == ["checkpoint-3.ckpt", "checkpoint_2.ckpt"]
    crash = torch.load(str(tmp_path / "s" / "ckpt" / "checkpoint-3.ckpt"), weights_only=True)
    assert crash["steps"] == 3
    assert_same_checkpoint(str(tmp_path / "s" / "ckpt" / "checkpoint_2.ckpt"),
                           str(tmp_path / "s" / "ckpt" / "checkpoint-3.ckpt"),
                           skip=("config", "steps"))

    trainer = ToyTrainer(tmp_path / "t", {"async_checkpoint": True}, fail_at=3)
    real_write = trainer_mod.write_checkpoint

    def fail_on_writer(payload, path):
        if threading.current_thread().name == "kantts-ckpt-writer":
            raise OSError("disk full")
        real_write(payload, path)

    monkeypatch.setattr(trainer_mod, "write_checkpoint", fail_on_writer)
    with pytest.raises(RuntimeError, match="step failed"):
        run(trainer)
    assert _ckpts(tmp_path / "t") == ["checkpoint-3.ckpt"]


def test_trainer_without_tensorboard_or_matplotlib(tmp_path, monkeypatch, caplog):
    """Neither package: the run finishes, with one log line for each."""
    import builtins

    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name in ("tensorboardX", "torch.utils.tensorboard"):
            raise ImportError(f"no module named {name}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    monkeypatch.setattr(t_plot, "available", lambda: False)
    with caplog.at_level(logging.INFO):
        trainer = run(ToyTrainer(tmp_path, {}, max_steps=2))
    assert trainer.writer is None and not trainer.plots
    assert caplog.text.count("tensorboard is not installed") == 1
    assert caplog.text.count("matplotlib is not installed") == 1
    assert not os.path.exists(tmp_path / "log")
    assert _ckpts(tmp_path) == ["checkpoint_2.ckpt"]

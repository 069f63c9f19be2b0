"""Training loop, checkpoints and eval artifacts (counterpart of ``Trainer``,
``SambertTrainer``, ``GanTrainer`` and ``TextsyBertTrainer`` in
``kantts_tpu/train/trainer.py``), and the Textsy-BERT warm start of a
SAM-BERT text encoder (``load_sambert_encoder_from_sybert``).

The loop is step-driven with eval, save and log intervals. ``steps`` is the
next step to run, counting from 1, so ``train_max_steps: N`` runs exactly N
steps; the last step always saves, whatever the save interval, so that a run
that ends leaves its checkpoint (the KAN-TTS loop stops one step short and
does not save there). Metrics stay device scalars until a log or eval
interval reads them, the only host syncs the loop adds.

Checkpoints are ``stage/ckpt/checkpoint_{steps}.ckpt`` in the format of
``models/builder.py``, written atomically and fsynced;
``keep_last_checkpoints`` keeps the newest k (0 keeps all), pruned once the
newest has landed. With ``async_checkpoint: true`` the interval saves are
written on a background thread (``AsyncCheckpointWriter``) from host copies
taken on the train thread (``HostSnapshot``); ``train`` ends when the last
write has landed. A crash drains the writer, then writes
``checkpoint-{steps}.ckpt`` synchronously.

Rank 0 writes the log interval's train means (and ``train/steps_per_sec``
from the second interval on) and each eval's means as TensorBoard scalars
in ``stage/log``, through tensorboardX or ``torch.utils.tensorboard``
(whichever is installed; neither: no scalars, one log line), and draws the
eval plots of ``utils/plot.py`` beside the intermediate results' ``.npy``
and wav files when matplotlib is installed.

Under data parallelism (``parallel/mesh.py``) every rank runs the loop, the
steps and the evaluation, whose metrics are the global batch's and so equal
on every rank; rank 0 alone writes checkpoints and intermediate results and
logs. Under tensor parallelism (``parallel/tp.py``) a SAM-BERT checkpoint is
the gathered, unsharded state, so every rank takes part in a save and rank 0
writes it; the evaluation runs on the sharded model, and its intermediate
results on rank 0 from a plain copy loaded with the gathered state. A crash
cannot gather (a rank that failed alone cannot join a collective), so each
rank of the first model group writes its slice and rank 0 joins the slices
into the same whole ``checkpoint-{steps}.ckpt``; when a slice does not come
within ``crash_join_seconds`` the slices stay, with a log line. The other
ranks raise only once rank 0 is done, since under torchrun the first
worker to exit has the rest stopped
(``SambertTrainer.save_crash_checkpoint``).

With ``KANTTS_TRAIN_PROFILE=1`` rank 0 also logs, at each log
interval, the wall seconds of the loop's phases: loader wait, device put,
step (the host's dispatch, and its waits on the device), eval, save and log
(the one host sync of the interval), and the collectives' seconds inside
the steps (``allreduce``, device time from CUDA events on the card).
Whether or not it is set, each of those loop phases runs inside the span
``kantts.train.<phase>`` (``utils/profiling.py``), so a ``torch.profiler``
trace of the loop names the same phases on the kernels' clock; the
variable switches the seconds log alone.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import os
import queue
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from kantts_tpu_torch.models.builder import (
    checkpoint_payload,
    host_copy,
    write_checkpoint,
)
from kantts_tpu_torch.parallel import tp
from kantts_tpu_torch.parallel.mesh import CollectiveTimer, barrier, is_primary
from kantts_tpu_torch.train.steps import sambert_forward
from kantts_tpu_torch.utils import plot
from kantts_tpu_torch.utils.audio import save_wav
from kantts_tpu_torch.utils.config import load_yaml, stamp_and_dump
from kantts_tpu_torch.utils.log import log_to_file
from kantts_tpu_torch.utils.profiling import span, train_phase

History = List[Tuple[str, int, Dict[str, float]]]
PROFILE_ENV = "KANTTS_TRAIN_PROFILE"


def collective_timer() -> Optional[CollectiveTimer]:
    """A timer for the steps' collectives when ``KANTTS_TRAIN_PROFILE=1``."""
    return CollectiveTimer() if os.environ.get(PROFILE_ENV) == "1" else None


def primary_log(stage_dir: str) -> contextlib.AbstractContextManager:
    """``stage_dir/stdout.log`` on rank 0, nothing on the other ranks."""
    if is_primary():
        return log_to_file(os.path.join(stage_dir, "stdout.log"))
    return contextlib.nullcontext()


def stamped_config(config: Dict[str, Any], stage_dir: str) -> Dict[str, Any]:
    """Rank 0 stamps ``config`` and writes ``stage_dir/config.yaml``; after a
    barrier every rank reads the run's config from that file."""
    if is_primary():
        stamp_and_dump(config, stage_dir)
    barrier()
    return load_yaml(os.path.join(stage_dir, "config.yaml"))


def run(trainer: "Trainer") -> "Trainer":
    """``trainer.train()``; on a failure the crash checkpoint
    ``checkpoint-{steps}.ckpt`` goes out (``save_crash_checkpoint``) before
    the error goes on."""
    try:
        trainer.train()
    except (Exception, KeyboardInterrupt):
        logging.exception("training failed at step %d", trainer.steps)
        trainer.save_crash_checkpoint()
        raise
    return trainer


class HostSnapshot:
    """Host copies of a checkpoint payload, taken on the train thread for a
    write on another.

    A state dict's tensors are the live parameters and optimizer moments,
    which the next ``optimizer.step()`` updates in place, so the writer gets
    copies. A tensor on the card is copied into a pinned host buffer with
    ``non_blocking=True`` on the current stream, and one CUDA event is
    recorded after the last copy (``take`` returns it). The next step's
    kernels, its in-place updates included, are queued on the same stream
    after those copies, so stream order makes each copy read the values of
    the step that was saved; the writer synchronises on the event before it
    reads a buffer. A host tensor (a CPU run, Adam's ``step`` counts) is
    copied at once. The buffers are allocated at the first snapshot and
    reused: the caller takes a snapshot only once the previous one's write
    has landed (``Trainer.save_checkpoint``), so no copy overwrites a
    buffer that a write is reading."""

    def __init__(self):
        self._buffers: Dict[Tuple, torch.Tensor] = {}

    def take(self, payload: Any) -> Tuple[Any, Optional[torch.cuda.Event]]:
        """-> (the payload with host copies of its tensors, the event after
        the device copies or None when there were none)."""
        devices = set()

        def snap(value: Any, key: Tuple) -> Any:
            if isinstance(value, torch.Tensor):
                buf = self._buffers.get(key)
                if buf is None or buf.shape != value.shape or buf.dtype != value.dtype:
                    buf = torch.empty(value.shape, dtype=value.dtype,
                                      pin_memory=value.is_cuda)
                    self._buffers[key] = buf
                buf.copy_(value.detach(), non_blocking=value.is_cuda)
                if value.is_cuda:
                    devices.add(value.device)
                return buf
            if isinstance(value, dict):
                return {k: snap(v, key + (k,)) for k, v in value.items()}
            if isinstance(value, (list, tuple)):
                return type(value)(snap(v, key + (i,)) for i, v in enumerate(value))
            return copy.deepcopy(value)

        tree = snap(payload, ())
        if not devices:
            return tree, None
        with torch.cuda.device(devices.pop()):  # a trainer's one device
            event = torch.cuda.Event()
            event.record()
        return tree, event


class AsyncCheckpointWriter:
    """One daemon thread and one queue, so writes land in the order they
    were submitted, off the train loop (the JAX package's writer). A
    payload handed over is a host copy that nothing changes until its write
    lands (``HostSnapshot``). A failed write is logged and raised again on
    the next ``submit`` or ``wait``; the writer stays usable after it."""

    def __init__(self):
        self._queue: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._error: Optional[Exception] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="kantts-ckpt-writer")
        self._thread.start()

    def _run(self) -> None:
        while True:
            payload, path, after, ready = self._queue.get()
            try:
                if ready is not None:
                    ready.synchronize()
                write_checkpoint(payload, path)
                if after is not None:
                    after()
            except Exception as e:  # raised again on the next submit or wait
                logging.exception("async checkpoint write failed: %s", path)
                with self._lock:
                    self._error = e
            finally:
                self._queue.task_done()

    def _raise_pending(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def submit(self, payload: Any, path: str, after: Optional[Callable] = None,
               ready: Optional[torch.cuda.Event] = None) -> None:
        """Write ``payload`` to ``path`` (``write_checkpoint``) once
        ``ready`` (the snapshot's event) has completed; ``after`` runs on
        the writer thread once the file has landed (the keep-last-k prune,
        which must see the new file)."""
        self._raise_pending()
        self._queue.put((payload, path, after, ready))

    def wait(self) -> None:
        """Block until every submitted write has landed or failed."""
        self._queue.join()
        self._raise_pending()


def summary_writer(log_dir: str):
    """A TensorBoard writer into ``log_dir``: tensorboardX's (the JAX
    trainer's), else ``torch.utils.tensorboard``'s; None, with one log line,
    when neither is installed. tensorboardX comes first because
    ``torch.utils.tensorboard`` imports TensorFlow wherever that is
    installed, seconds of start-up for the same event files."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            logging.info("tensorboard is not installed (neither tensorboardX "
                         "nor torch.utils.tensorboard imports): no TensorBoard "
                         "scalars")
            return None
    return SummaryWriter(log_dir)


def prune_checkpoints(ckpt_dir: str, keep_last: int) -> None:
    """Keep the newest ``keep_last`` ``checkpoint_{steps}.ckpt`` files."""
    if keep_last <= 0 or not os.path.isdir(ckpt_dir):
        return
    ckpts = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("checkpoint_") and name.endswith(".ckpt"):
            try:
                ckpts.append((int(name[len("checkpoint_"):-len(".ckpt")]), name))
            except ValueError:
                continue
    for _, name in sorted(ckpts)[:-keep_last]:
        os.remove(os.path.join(ckpt_dir, name))


def array_to_device(value: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array -> a tensor on ``device`` (integers as int64). To a CUDA
    device the copy goes from pinned memory without blocking the host."""
    t = torch.from_numpy(np.ascontiguousarray(value))
    if not t.is_floating_point():
        t = t.long()
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def batch_to_device(batch: Dict[str, Any], device: torch.device
                    ) -> Dict[str, Any]:
    """A collated numpy batch -> tensors on ``device`` (a tuple of arrays,
    such as an FP batch's ``fp_plan``, -> a tuple of tensors); entries that
    are None are dropped."""
    return {key: (tuple(array_to_device(v, device) for v in value)
                  if isinstance(value, tuple) else array_to_device(value, device))
            for key, value in batch.items() if value is not None}


class Trainer:
    """Step-driven loop with interval-gated eval, save and log."""

    # rank 0's wait for the other ranks' crash slices; they wait twice it for the join
    crash_join_seconds = 10.0

    def __init__(self, config: Dict[str, Any], train_loader, valid_loader,
                 save_dir: str, device: torch.device, max_steps=None,
                 save_interval: int = 1, valid_interval: int = 1,
                 log_interval: int = 10,
                 timer: Optional[CollectiveTimer] = None):
        self.config = config
        self.train_loader = train_loader
        self.valid_loader = valid_loader
        self.save_dir = save_dir
        self.device = device
        self.max_steps = max_steps if max_steps is not None else 10 ** 12
        self.save_interval = save_interval
        self.valid_interval = valid_interval
        self.log_interval = log_interval

        self.steps = 1
        self.epoch = 0
        self.steps_taken = 0  # train steps this object has run
        self.finish_training = False
        self.total_train_loss: Dict[str, Any] = defaultdict(float)
        self.total_eval_loss: Dict[str, Any] = defaultdict(float)
        self.history: History = []  # ("train" | "eval", steps, means)
        self._last_log_time = None
        # KANTTS_TRAIN_PROFILE=1: the loop's phase seconds; ``timer`` is the
        # one the steps' collectives report to
        self.profile = os.environ.get(PROFILE_ENV) == "1"
        self.timer = timer
        self.phase_seconds: Dict[str, float] = defaultdict(float)

        self.ckpt_dir = os.path.join(save_dir, "ckpt")
        self.log_dir = os.path.join(save_dir, "log")
        primary = is_primary()
        if primary:
            os.makedirs(self.ckpt_dir, exist_ok=True)
        self.eval_rng = np.random.RandomState(config.get("seed", 0))
        # rank 0: TensorBoard scalars and eval plots, where installed
        self.writer = summary_writer(self.log_dir) if primary else None
        self.plots = primary and plot.available()
        if primary and not self.plots:
            logging.info("matplotlib is not installed: the eval plots are not drawn")
        # async_checkpoint: true -> interval saves on a background thread
        self._ckpt_writer: Optional[AsyncCheckpointWriter] = None
        self._snapshot = HostSnapshot()

    # ------------------------------------------------------------------ loop

    def train(self):
        # a resume from a checkpoint already at train_max_steps runs nothing
        self.check_stop_training()
        while not self.finish_training:
            self.train_epoch()
            self.epoch += 1
            self.check_stop_training()
        self.wait_for_checkpoints()
        if self.writer is not None:
            self.writer.close()  # drains the writer's queue (flush does not)

    def wait_for_checkpoints(self) -> None:
        """Let every asynchronous checkpoint write land (none: no-op); a
        failed one raises here."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()

    def to_device(self, batch):
        """A collated batch from the loader -> what the steps take."""
        return batch_to_device(batch, self.device)

    def _timed(self, phase: str, fn: Callable, *args):
        """``fn(*args)`` inside the span ``kantts.train.<phase>``, its wall
        seconds added to ``phase`` when profiling."""
        with span(train_phase(phase)):
            if not self.profile:
                return fn(*args)
            t0 = time.perf_counter()
            out = fn(*args)
            self.phase_seconds[phase] += time.perf_counter() - t0
            return out

    def train_epoch(self):
        batches = iter(self.train_loader)
        while True:
            batch = self._timed("loader_wait", next, batches, None)
            if batch is None:
                break
            batch = self._timed("device_put", self.to_device, batch)
            self._timed("step", self.train_step, batch)
            self.steps_taken += 1
            self._timed("eval", self.check_eval_interval)
            self._timed("save", self.check_save_interval)
            self._timed("log", self.check_log_interval)
            self.steps += 1
            self.check_stop_training()
            if self.finish_training:
                break
        logging.info("Epoch %d finished", self.epoch)
        self.train_loader.sampler.set_epoch(self.epoch + 1)

    def check_stop_training(self):
        if self.steps > self.max_steps:
            self.finish_training = True

    # ------------------------------------------------------------- intervals

    def collective_payload(self) -> bool:
        """Whether ``checkpoint_payload`` is a collective (a tensor-parallel
        model's gather), which every rank must call."""
        return False

    def crash_path(self) -> str:
        return os.path.join(self.ckpt_dir, f"checkpoint-{self.steps}.ckpt")

    def drain_checkpoint_writes(self) -> None:
        """Let the pending asynchronous writes land before a crash save; a
        failed one is logged, and the crash save still goes out."""
        try:
            self.wait_for_checkpoints()
        except Exception:
            logging.exception("a pending checkpoint write failed")

    def save_crash_checkpoint(self) -> None:
        """Rank 0 drains the asynchronous writes, then saves
        ``crash_path()`` synchronously. No collective runs here: a rank that
        failed alone cannot join one."""
        if is_primary():
            self.drain_checkpoint_writes()
            self.save_checkpoint(self.crash_path())
            logging.info("Saved crash checkpoint at step %d", self.steps)

    def check_save_interval(self):
        if not (self.steps % self.save_interval == 0 or self.steps == self.max_steps):
            return
        payload = None
        if self.collective_payload():
            payload = self.checkpoint_payload()
        if not is_primary():
            return
        self.save_checkpoint(
            os.path.join(self.ckpt_dir, f"checkpoint_{self.steps}.ckpt"),
            allow_async=True, payload=payload)
        logging.info("Checkpoint saved at step %d", self.steps)

    def save_checkpoint(self, path: str, allow_async: bool = False,
                        payload: Optional[Dict[str, Any]] = None) -> None:
        """Write ``payload`` (by default ``checkpoint_payload()``) to ``path``,
        then prune to the newest ``keep_last_checkpoints``. With
        ``allow_async`` and ``async_checkpoint: true`` the train thread only
        takes the host snapshot (after the previous asynchronous write has
        landed, whose buffers it reuses) and the writer thread writes and
        prunes."""
        def prune():
            prune_checkpoints(self.ckpt_dir,
                              self.config.get("keep_last_checkpoints", 0))

        if payload is None:
            payload = self.checkpoint_payload()
        if allow_async and self.config.get("async_checkpoint", False):
            if self._ckpt_writer is None:
                self._ckpt_writer = AsyncCheckpointWriter()
            self._ckpt_writer.wait()
            tree, ready = self._snapshot.take(payload)
            self._ckpt_writer.submit(tree, path, after=prune, ready=ready)
        else:
            write_checkpoint(host_copy(payload), path)
            prune()

    def write_scalars(self, means: Dict[str, float]) -> None:
        """TensorBoard scalars at the current step (rank 0, where installed)."""
        if self.writer is not None:
            for key, value in means.items():
                self.writer.add_scalar(key, float(value), self.steps)

    def check_log_interval(self):
        if self.steps % self.log_interval:
            return
        means = {key: float(value) / self.log_interval
                 for key, value in self.total_train_loss.items()}
        primary = is_primary()
        if primary:
            for key, value in means.items():
                logging.info("(Steps: %d) %s = %.4f.", self.steps, key, value)
        now = time.perf_counter()
        if self._last_log_time is not None:
            means["train/steps_per_sec"] = self.log_interval / (now - self._last_log_time)
            if primary:
                logging.info("(Steps: %d) steps_per_sec = %.3f.", self.steps,
                             means["train/steps_per_sec"])
        if self.profile:
            self.log_phases(now)
        self._last_log_time = now
        self.history.append(("train", self.steps, means))
        self.write_scalars(means)
        self.total_train_loss = defaultdict(float)

    def log_phases(self, now: float) -> None:
        """Rank 0 logs the phase seconds since the last log interval (none at
        the first, which has no window); every interval starts afresh."""
        phases = dict(self.phase_seconds)
        if self.timer is not None:
            phases["allreduce"] = self.timer.take_seconds()
        self.phase_seconds = defaultdict(float)
        if self._last_log_time is None or not is_primary():
            return
        window = now - self._last_log_time
        tracked = sum(v for k, v in phases.items() if k != "allreduce")
        logging.info("(Steps: %d) phase_seconds %s other=%.4f window=%.4f",
                     self.steps, " ".join(f"{k}={v:.4f}" for k, v in sorted(phases.items())),
                     max(window - tracked, 0.0), window)

    def check_eval_interval(self):
        if self.valid_interval > 0 and self.steps % self.valid_interval == 0:
            self.eval_epoch()

    @staticmethod
    def accumulate(store: Dict[str, Any], metrics: Dict[str, torch.Tensor],
                   prefix: str) -> None:
        """Sum device scalars without reading them back."""
        for key, value in metrics.items():
            store[f"{prefix}/{key}"] = store[f"{prefix}/{key}"] + value

    # ------------------------------------------------------------------ eval

    def eval_epoch(self):
        """Every rank evaluates (the steps' collectives need them all); rank 0
        saves the intermediate results of one batch, drawn on every rank, and
        logs."""
        primary = is_primary()
        if primary:
            logging.info("(Epoch: %d) Start evaluation.", self.epoch)
        self.total_eval_loss = defaultdict(float)
        num_batches = max(1, len(self.valid_loader))
        rand_idx = self.eval_rng.randint(0, num_batches)
        for idx, batch in enumerate(self.valid_loader):
            batch = self.to_device(batch)
            out = self.eval_step(batch)
            if idx == rand_idx:
                self.intermediate_result(batch, out)
        means = {key: float(value) / num_batches
                 for key, value in self.total_eval_loss.items()}
        if primary:
            for key, value in means.items():
                logging.info("(Steps: %d) %s = %.4f.", self.steps, key, value)
            logging.info("Epoch %d evaluation finished", self.epoch)
        self.history.append(("eval", self.steps, means))
        self.write_scalars(means)

    # --------------------------------------------------- subclass interface

    def train_step(self, batch):
        raise NotImplementedError

    def eval_step(self, batch):
        """Accumulate the eval metrics of ``batch``; -> what the intermediate
        results of that batch need from the step, if anything."""
        raise NotImplementedError

    def intermediate_result(self, batch, out=None):
        """Every rank calls it for the drawn batch; rank 0 writes its
        intermediate results."""
        if is_primary():
            self.generate_and_save_intermediate_result(batch, out)

    def generate_and_save_intermediate_result(self, batch, out=None):
        """Write artifacts of ``batch`` (``out``: what ``eval_step`` returned
        for it). Rank 0 alone calls it, so it runs no collective."""

    def checkpoint_payload(self) -> Dict[str, Any]:
        """What a checkpoint of the current state holds
        (``models/builder.py::checkpoint_payload``), its tensors the live ones."""
        raise NotImplementedError

    def load_checkpoint(self, path, restore_training_state=False):
        raise NotImplementedError


class SambertTrainer(Trainer):
    """One-optimizer acoustic-model trainer. An FP model's intermediate
    results splice in ``fp_dict_lings``, as its steps do."""

    def __init__(self, config, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, scheduler,
                 train_step_fn: Callable, eval_step_fn: Callable, train_loader,
                 valid_loader, save_dir: str, device: torch.device,
                 fp_dict_lings: Optional[torch.Tensor] = None, **kwargs):
        super().__init__(config, train_loader, valid_loader, save_dir, device,
                         **kwargs)
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.train_step_fn = train_step_fn
        self.eval_step_fn = eval_step_fn
        self.fp_dict_lings = fp_dict_lings
        self.warm_started: List[str] = []  # tensors a warm start copied
        self._plain: Optional[torch.nn.Module] = None  # rank 0's gathered copy

    def train_step(self, batch):
        self.accumulate(self.total_train_loss,
                        self.train_step_fn(batch, self.epoch), "train")

    def eval_step(self, batch):
        self.accumulate(self.total_eval_loss,
                        self.eval_step_fn(batch, self.epoch), "eval")

    def collective_payload(self) -> bool:
        return tp.is_sharded(self.model)

    def save_crash_checkpoint(self) -> None:
        """Sharded, with no collective: each rank of the first model group
        writes its slice (``tp.local_slice`` with the schedule, the step and
        the config) beside ``crash_path()``; rank 0, its asynchronous writes
        drained first, waits up to ``crash_join_seconds`` for the others'
        slices of this step and run, joins them into ``crash_path()`` (the
        gathered state an interval save holds) and removes them. When one
        is missing or disagrees it logs which and leaves the slices, and no
        whole file is written. Every other rank stays until rank 0 is done
        (``await_crash_join``)."""
        if not tp.is_sharded(self.model):
            return super().save_crash_checkpoint()
        since_ns = time.time_ns() - 1_000_000_000  # a margin for coarse file times
        grid = self.model.tensor_parallel.grid
        primary = is_primary()
        if primary:
            self.drain_checkpoint_writes()
        path = self.crash_path()
        slices = [tp.slice_path(path, r, grid.n_model) for r in range(grid.n_model)]
        if grid.data_index == 0:  # the other data ranks hold the same state
            mine = slices[grid.model_index]
            write_checkpoint(host_copy(dict(
                tp.local_slice(self.model, self.optimizer), config=self.config,
                scheduler=self.scheduler.state_dict(), steps=self.steps)), mine)
            logging.info("Saved crash slice %s at step %d", os.path.basename(mine), self.steps)
        if not primary:
            return self.await_crash_join(path, slices, since_ns)
        payload = tp.join_slice_files(path, grid.n_model, self.crash_join_seconds,
                                      self.steps, self.config, self.model.tensor_parallel.run)
        if payload is None:
            return
        write_checkpoint(payload, path)
        for p in slices:
            os.remove(p)
        logging.info("Saved crash checkpoint at step %d, joined from %d slices",
                     self.steps, grid.n_model)

    def await_crash_join(self, path: str, slices: List[str], since_ns: int) -> None:
        """A rank other than 0 stays until rank 0 has joined the crash
        checkpoint (``path`` written since ``since_ns`` and no slice left),
        for at most twice ``crash_join_seconds``. Under torchrun the first
        worker to exit has the others stopped (SIGTERM), so one that went
        on to raise at once could stop rank 0 in the middle of its join."""
        deadline = time.monotonic() + 2 * self.crash_join_seconds
        while time.monotonic() < deadline:
            try:
                landed = os.stat(path).st_mtime_ns >= since_ns
            except FileNotFoundError:
                landed = False
            if landed and not any(os.path.exists(p) for p in slices):
                return
            time.sleep(0.05)
        logging.error("rank 0 did not join %s within %g s", os.path.basename(path),
                      2 * self.crash_join_seconds)

    def intermediate_result(self, batch, out=None):
        """Sharded, the model group gathers the state and rank 0 draws from a
        plain copy that holds it, with every head of every attention."""
        model = self.model
        if tp.is_sharded(model):
            state = tp.gather_state_dict(model)
            if not is_primary():
                return
            if self._plain is None:
                self._plain = type(model)(model.config).to(self.device)
            self._plain.load_state_dict(state)
            model = self._plain
        if is_primary():
            self.generate_and_save_intermediate_result(batch, out, model)

    @torch.no_grad()
    def generate_and_save_intermediate_result(self, batch, out=None, model=None):
        """Save the postnet mels of the first few items and the coarse,
        output and target mels of the first item as .npy; with matplotlib,
        also the JAX trainer's plots: each of the first few items' postnet
        and target mels (and its MAS soft alignment), and the first item's
        attention maps, one a layer and head (encoder self-attention, PNCA x
        and h attention). ``model`` defaults to the trained one."""
        out_dir = os.path.join(self.save_dir, f"intermediate_results_{self.steps}")
        os.makedirs(out_dir, exist_ok=True)
        model = self.model if model is None else model
        model.eval()
        res = sambert_forward(model, batch, fp_dict_lings=self.fp_dict_lings)
        lengths = batch["valid_output_lengths"].tolist()
        post = res["postnet_outputs"].cpu().numpy()
        n = min(self.config.get("num_save_intermediate_results", 4), len(lengths))
        for i in range(n):
            np.save(os.path.join(out_dir, f"{i}_mel.npy"), post[i, :lengths[i]])
        if self.plots:
            self.plot_intermediate(res, batch, post, n, out_dir)
        L0 = lengths[0]
        np.save(os.path.join(out_dir, "coarse_mel.npy"),
                res["dec_outputs"][0, :L0].cpu().numpy())
        np.save(os.path.join(out_dir, "output_mel.npy"), post[0, :L0])
        np.save(os.path.join(out_dir, "target_mel.npy"),
                batch["mel_targets"][0, :L0].cpu().numpy())

    @staticmethod
    def plot_intermediate(res: Dict[str, Any], batch: Dict[str, Any],
                          post: np.ndarray, n: int, out_dir: str) -> None:
        """The JAX trainer's eval PNGs, under its names."""
        def host(t):
            return t.float().cpu().numpy()

        lengths = batch["valid_output_lengths"].tolist()
        target = host(batch["mel_targets"])
        attn_soft = host(res["attn_soft"]) if res.get("attn_soft") is not None else None
        for i in range(n):
            plot.plot_spectrogram(post[i, :lengths[i]],
                                  os.path.join(out_dir, f"{i}_postnet.png"))
            plot.plot_spectrogram(target[i, :lengths[i]],
                                  os.path.join(out_dir, f"{i}_target.png"))
            if attn_soft is not None:
                plot.plot_alignment(attn_soft[i, 0],
                                    os.path.join(out_dir, f"{i}_mas_attn.png"))
        L0 = int(batch["valid_input_lengths"][0])
        for li, slf_attn in enumerate(res.get("enc_slf_attn_lst") or []):
            heads = host(slf_attn[0])  # (n_head, T_in, T_in)
            for hi in range(heads.shape[0]):
                plot.plot_alignment(
                    heads[hi, :L0, :L0],
                    os.path.join(out_dir, f"enc_slf_attn_dev_layer{li}_head{hi}.png"),
                    info=f"valid_len_{L0}")
        x_bw, h_bw = res.get("x_band_width"), res.get("h_band_width")
        pnca_pairs = zip(res.get("pnca_x_attn_lst") or [],
                         res.get("pnca_h_attn_lst") or [])
        for li, (x_attn, h_attn) in enumerate(pnca_pairs):
            x_attn, h_attn = host(x_attn[0]), host(h_attn[0])
            for hi in range(x_attn.shape[0]):
                plot.plot_alignment(
                    x_attn[hi],
                    os.path.join(out_dir, f"pnca_x_attn_dev_layer{li}_head{hi}.png"),
                    info=f"x_band_width_{int(x_bw)}" if x_bw is not None else None)
                plot.plot_alignment(
                    h_attn[hi],
                    os.path.join(out_dir, f"pnca_h_attn_dev_layer{li}_head{hi}.png"),
                    info=f"h_band_width_{int(h_bw)}" if h_bw is not None else None)

    def checkpoint_payload(self):
        """The unsharded state: a sharded model's is gathered (a collective
        of the model group)."""
        model, optimizer = tp.gather_training_state(self.model, self.optimizer)
        return checkpoint_payload(model, self.config, optimizer=optimizer,
                                  scheduler=self.scheduler.state_dict(), steps=self.steps)

    def load_checkpoint(self, path, restore_training_state=False):
        """Load the model; with ``restore_training_state`` also the optimizer
        and the schedule, and resume at the step after the saved one. A
        sharded model takes its slices of the unsharded file."""
        payload = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(tp.shard_state_dict(payload["model"], self.model),
                                   strict=True)
        if restore_training_state:
            self.optimizer.load_state_dict(tp.shard_optimizer_state(
                payload["optimizer"], self.optimizer, self.model))
            self.scheduler.load_state_dict(payload["scheduler"])
            self.steps = int(payload["steps"]) + 1


class GanTrainer(Trainer):
    """Two-player trainer: the generator and one optimizer per discriminator
    family, with the warm-up gates ``generator_train_start_steps`` (the
    generator trains from that step on) and
    ``discriminator_train_start_steps`` (the adversarial losses and the
    discriminators' updates start after it). ``make_step_fn(train_generator,
    include_adversarial)`` makes the step for a pair of gates; each pair is
    made once. Batches are (wav (B, T, 1), mel (B, frames, C)) tuples."""

    def __init__(self, config, generator: torch.nn.Module,
                 discriminators: Dict[str, torch.nn.Module],
                 gen_optimizer: torch.optim.Optimizer, gen_scheduler,
                 disc_optimizers: Dict[str, torch.optim.Optimizer],
                 disc_schedulers: Dict[str, Any], make_step_fn: Callable,
                 eval_step_fn: Callable, train_loader, valid_loader,
                 save_dir: str, device: torch.device, sampling_rate: int = 16000,
                 **kwargs):
        super().__init__(config, train_loader, valid_loader, save_dir, device,
                         **kwargs)
        self.generator = generator
        self.discriminators = discriminators
        self.gen_optimizer = gen_optimizer
        self.gen_scheduler = gen_scheduler
        self.disc_optimizers = disc_optimizers
        self.disc_schedulers = disc_schedulers
        self.make_step_fn = make_step_fn
        self.eval_step_fn = eval_step_fn
        self.sampling_rate = sampling_rate
        self.gen_start = config.get("generator_train_start_steps", 0)
        self.disc_start = config.get("discriminator_train_start_steps", 0)
        self._step_cache: Dict[Tuple[bool, bool], Callable] = {}

    def step_fn(self) -> Callable:
        key = (self.steps >= self.gen_start, self.steps > self.disc_start)
        if key not in self._step_cache:
            self._step_cache[key] = self.make_step_fn(*key)
        return self._step_cache[key]

    def to_device(self, batch):
        return tuple(array_to_device(a, self.device) for a in batch)

    def train_step(self, batch):
        self.accumulate(self.total_train_loss, self.step_fn()(*batch), "train")

    def eval_step(self, batch):
        metrics, y_gen = self.eval_step_fn(*batch)
        self.accumulate(self.total_eval_loss, metrics, "eval")
        return y_gen

    def generate_and_save_intermediate_result(self, batch, out=None):
        """``{i}_ref.wav`` and ``{i}_gen.wav`` of the first few items, with
        matplotlib also their waveform plots ``{i}_ref.png`` and
        ``{i}_gen.png``; the generated waveform is the eval step's, ``out``."""
        wav, _ = batch
        y_gen = out
        out_dir = os.path.join(self.save_dir, f"intermediate_results_{self.steps}")
        os.makedirs(out_dir, exist_ok=True)
        n = min(self.config.get("num_save_intermediate_results", 4), wav.shape[0])
        ref, gen = wav[:n, :, 0].cpu().numpy(), y_gen[:n, :, 0].float().cpu().numpy()
        for i in range(n):
            save_wav(ref[i], os.path.join(out_dir, f"{i}_ref.wav"), self.sampling_rate)
            save_wav(gen[i], os.path.join(out_dir, f"{i}_gen.wav"), self.sampling_rate)
            if self.plots:
                plot.plot_waveform(ref[i], os.path.join(out_dir, f"{i}_ref.png"),
                                   self.sampling_rate)
                plot.plot_waveform(gen[i], os.path.join(out_dir, f"{i}_gen.png"),
                                   self.sampling_rate)

    def checkpoint_payload(self):
        """The model is {"generator": state dict, "discriminator": {class
        name: state dict}} (the spectral vectors are buffers of the
        discriminators); optimizer and scheduler are nested the same way."""
        def nested(gen, discs):
            return {"generator": gen.state_dict(),
                    "discriminator": {n: d.state_dict() for n, d in discs.items()}}

        return checkpoint_payload(
            nested(self.generator, self.discriminators), self.config,
            optimizer=nested(self.gen_optimizer, self.disc_optimizers),
            scheduler=nested(self.gen_scheduler, self.disc_schedulers),
            steps=self.steps)

    def load_checkpoint(self, path, restore_training_state=False):
        """Load the generator and the discriminators (spectral vectors
        included); with ``restore_training_state`` also every optimizer and
        schedule, and resume at the step after the saved one. Without it the
        load is a fine-tune start: fresh optimizers, step 1."""
        payload = torch.load(path, map_location="cpu", weights_only=True)
        self.generator.load_state_dict(payload["model"]["generator"], strict=True)
        for name, disc in self.discriminators.items():
            disc.load_state_dict(payload["model"]["discriminator"][name], strict=True)
        if restore_training_state:
            opt, sched = payload["optimizer"], payload["scheduler"]
            self.gen_optimizer.load_state_dict(opt["generator"])
            self.gen_scheduler.load_state_dict(sched["generator"])
            for name in self.discriminators:
                self.disc_optimizers[name].load_state_dict(opt["discriminator"][name])
                self.disc_schedulers[name].load_state_dict(sched["discriminator"][name])
            self.steps = int(payload["steps"]) + 1


class TextsyBertTrainer(SambertTrainer):
    """Textsy-BERT's masked-LM trainer: one optimizer, steps that take the
    batch alone (``make_sybert_step``), and no intermediate results."""

    def train_step(self, batch):
        self.accumulate(self.total_train_loss, self.train_step_fn(batch), "train")

    def eval_step(self, batch):
        self.accumulate(self.total_eval_loss, self.eval_step_fn(batch), "eval")

    def generate_and_save_intermediate_result(self, batch, out=None, model=None):
        pass


def load_sambert_encoder_from_sybert(model: torch.nn.Module, sybert_ckpt: str
                                     ) -> List[str]:
    """Warm-start a SAM-BERT text encoder from a Textsy-BERT checkpoint: copy
    every ``text_encoder.*`` tensor of the checkpoint whose name and shape
    match one of ``model``'s (strict=False semantics; ``ling_proj``, which
    Textsy-BERT lacks, stays as it is). -> the names copied."""
    bert = torch.load(sybert_ckpt, map_location="cpu", weights_only=True)["model"]
    own = model.state_dict()
    copied = []
    with torch.no_grad():
        for name, value in bert.items():
            if (name.startswith("text_encoder.") and name in own
                    and own[name].shape == value.shape):
                own[name].copy_(value)
                copied.append(name)
    return copied

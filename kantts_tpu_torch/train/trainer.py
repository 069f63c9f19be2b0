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
``models/builder.py``, written atomically; ``keep_last_checkpoints`` keeps
the newest k (0 keeps all). A crash writes ``checkpoint-{steps}.ckpt``.

Under data parallelism (``parallel/mesh.py``) every rank runs the loop, the
steps and the evaluation, whose metrics are the global batch's and so equal
on every rank; rank 0 alone writes checkpoints and intermediate results and
logs. With ``KANTTS_TRAIN_PROFILE=1`` rank 0 also logs, at each log
interval, the wall seconds of the loop's phases: loader wait, device put,
step (the host's dispatch, and its waits on the device), eval, save and log
(the one host sync of the interval), and the collectives' seconds inside
the steps (``allreduce``, device time from CUDA events on the card).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from kantts_tpu_torch.models.builder import save_checkpoint
from kantts_tpu_torch.parallel.mesh import CollectiveTimer, barrier, is_primary
from kantts_tpu_torch.train.steps import sambert_forward
from kantts_tpu_torch.utils.audio import save_wav
from kantts_tpu_torch.utils.config import load_yaml, stamp_and_dump
from kantts_tpu_torch.utils.log import log_to_file

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
    """``trainer.train()``; on a failure rank 0 saves
    ``checkpoint-{steps}.ckpt`` before the error goes on."""
    try:
        trainer.train()
    except (Exception, KeyboardInterrupt):
        logging.exception("training failed at step %d", trainer.steps)
        if is_primary():
            trainer.save_checkpoint(
                os.path.join(trainer.ckpt_dir, f"checkpoint-{trainer.steps}.ckpt"))
            logging.info("Saved crash checkpoint at step %d", trainer.steps)
        raise
    return trainer


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
        if is_primary():
            os.makedirs(self.ckpt_dir, exist_ok=True)
        self.eval_rng = np.random.RandomState(config.get("seed", 0))

    # ------------------------------------------------------------------ loop

    def train(self):
        # a resume from a checkpoint already at train_max_steps runs nothing
        self.check_stop_training()
        while not self.finish_training:
            self.train_epoch()
            self.epoch += 1
            self.check_stop_training()

    def to_device(self, batch):
        """A collated batch from the loader -> what the steps take."""
        return batch_to_device(batch, self.device)

    def _timed(self, phase: str, fn: Callable, *args):
        """``fn(*args)``, its wall seconds added to ``phase`` when profiling."""
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

    def check_save_interval(self):
        if not is_primary():
            return
        if self.steps % self.save_interval == 0 or self.steps == self.max_steps:
            self.save_checkpoint(
                os.path.join(self.ckpt_dir, f"checkpoint_{self.steps}.ckpt"))
            prune_checkpoints(self.ckpt_dir,
                              self.config.get("keep_last_checkpoints", 0))
            logging.info("Checkpoint saved at step %d", self.steps)

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
            if idx == rand_idx and primary:
                self.generate_and_save_intermediate_result(batch, out)
        means = {key: float(value) / num_batches
                 for key, value in self.total_eval_loss.items()}
        if primary:
            for key, value in means.items():
                logging.info("(Steps: %d) %s = %.4f.", self.steps, key, value)
            logging.info("Epoch %d evaluation finished", self.epoch)
        self.history.append(("eval", self.steps, means))

    # --------------------------------------------------- subclass interface

    def train_step(self, batch):
        raise NotImplementedError

    def eval_step(self, batch):
        """Accumulate the eval metrics of ``batch``; -> what the intermediate
        results of that batch need from the step, if anything."""
        raise NotImplementedError

    def generate_and_save_intermediate_result(self, batch, out=None):
        """Write artifacts of ``batch`` (``out``: what ``eval_step`` returned
        for it). Rank 0 alone calls it, so it runs no collective."""

    def save_checkpoint(self, path):
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

    def train_step(self, batch):
        self.accumulate(self.total_train_loss,
                        self.train_step_fn(batch, self.epoch), "train")

    def eval_step(self, batch):
        self.accumulate(self.total_eval_loss,
                        self.eval_step_fn(batch, self.epoch), "eval")

    @torch.no_grad()
    def generate_and_save_intermediate_result(self, batch, out=None):
        """Save the postnet mels of the first few items and the coarse,
        output and target mels of the first item as .npy."""
        out_dir = os.path.join(self.save_dir, f"intermediate_results_{self.steps}")
        os.makedirs(out_dir, exist_ok=True)
        self.model.eval()
        res = sambert_forward(self.model, batch, fp_dict_lings=self.fp_dict_lings)
        lengths = batch["valid_output_lengths"].tolist()
        post = res["postnet_outputs"].cpu().numpy()
        n = min(self.config.get("num_save_intermediate_results", 4), len(lengths))
        for i in range(n):
            np.save(os.path.join(out_dir, f"{i}_mel.npy"), post[i, :lengths[i]])
        L0 = lengths[0]
        np.save(os.path.join(out_dir, "coarse_mel.npy"),
                res["dec_outputs"][0, :L0].cpu().numpy())
        np.save(os.path.join(out_dir, "output_mel.npy"), post[0, :L0])
        np.save(os.path.join(out_dir, "target_mel.npy"),
                batch["mel_targets"][0, :L0].cpu().numpy())

    def save_checkpoint(self, path):
        save_checkpoint(path, self.model, self.config,
                        optimizer=self.optimizer.state_dict(),
                        scheduler=self.scheduler.state_dict(), steps=self.steps)

    def load_checkpoint(self, path, restore_training_state=False):
        """Load the model; with ``restore_training_state`` also the optimizer
        and the schedule, and resume at the step after the saved one."""
        payload = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(payload["model"], strict=True)
        if restore_training_state:
            self.optimizer.load_state_dict(payload["optimizer"])
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
        """``{i}_ref.wav`` and ``{i}_gen.wav`` of the first few items; the
        generated waveform is the eval step's, ``out``."""
        wav, _ = batch
        y_gen = out
        out_dir = os.path.join(self.save_dir, f"intermediate_results_{self.steps}")
        os.makedirs(out_dir, exist_ok=True)
        n = min(self.config.get("num_save_intermediate_results", 4), wav.shape[0])
        ref, gen = wav[:n, :, 0].cpu().numpy(), y_gen[:n, :, 0].float().cpu().numpy()
        for i in range(n):
            save_wav(ref[i], os.path.join(out_dir, f"{i}_ref.wav"), self.sampling_rate)
            save_wav(gen[i], os.path.join(out_dir, f"{i}_gen.wav"), self.sampling_rate)

    def save_checkpoint(self, path):
        """The model is {"generator": state dict, "discriminator": {class
        name: state dict}} (the spectral vectors are buffers of the
        discriminators); optimizer and scheduler are nested the same way."""
        def nested(gen, discs):
            return {"generator": gen.state_dict(),
                    "discriminator": {n: d.state_dict() for n, d in discs.items()}}

        save_checkpoint(
            path, nested(self.generator, self.discriminators), self.config,
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

    def generate_and_save_intermediate_result(self, batch, out=None):
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

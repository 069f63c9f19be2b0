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
"""

from __future__ import annotations

import logging
import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from kantts_tpu_torch.models.builder import save_checkpoint
from kantts_tpu_torch.train.steps import sambert_forward
from kantts_tpu_torch.utils.audio import save_wav

History = List[Tuple[str, int, Dict[str, float]]]


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
                 log_interval: int = 10):
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

        self.ckpt_dir = os.path.join(save_dir, "ckpt")
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

    def train_epoch(self):
        for batch in self.train_loader:
            self.train_step(self.to_device(batch))
            self.steps_taken += 1
            self.check_eval_interval()
            self.check_save_interval()
            self.check_log_interval()
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
        for key, value in means.items():
            logging.info("(Steps: %d) %s = %.4f.", self.steps, key, value)
        now = time.perf_counter()
        if self._last_log_time is not None:
            means["train/steps_per_sec"] = self.log_interval / (now - self._last_log_time)
            logging.info("(Steps: %d) steps_per_sec = %.3f.", self.steps,
                         means["train/steps_per_sec"])
        self._last_log_time = now
        self.history.append(("train", self.steps, means))
        self.total_train_loss = defaultdict(float)

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
        logging.info("(Epoch: %d) Start evaluation.", self.epoch)
        self.total_eval_loss = defaultdict(float)
        num_batches = max(1, len(self.valid_loader))
        rand_idx = self.eval_rng.randint(0, num_batches)
        for idx, batch in enumerate(self.valid_loader):
            batch = self.to_device(batch)
            self.eval_step(batch)
            if idx == rand_idx:
                self.generate_and_save_intermediate_result(batch)
        means = {key: float(value) / num_batches
                 for key, value in self.total_eval_loss.items()}
        for key, value in means.items():
            logging.info("(Steps: %d) %s = %.4f.", self.steps, key, value)
        self.history.append(("eval", self.steps, means))
        logging.info("Epoch %d evaluation finished", self.epoch)

    # --------------------------------------------------- subclass interface

    def train_step(self, batch):
        raise NotImplementedError

    def eval_step(self, batch):
        raise NotImplementedError

    def generate_and_save_intermediate_result(self, batch):
        pass

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
    def generate_and_save_intermediate_result(self, batch):
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
        metrics, _ = self.eval_step_fn(*batch)
        self.accumulate(self.total_eval_loss, metrics, "eval")

    def generate_and_save_intermediate_result(self, batch):
        """``{i}_ref.wav`` and ``{i}_gen.wav`` of the first few items."""
        wav, mel = batch
        _, y_gen = self.eval_step_fn(wav, mel)
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

    def generate_and_save_intermediate_result(self, batch):
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

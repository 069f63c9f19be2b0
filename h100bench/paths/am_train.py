"""SAM-BERT with MAS alignment, trained: the port's ``make_sambert_step``
(``with_mas``: the forward with kernel K1's hard path in every step, the
reconstruction, CTC and binarization losses, the backward, the clip and
Adam with NoamLR) fed back to back by its ``AMDataset`` and ``DataLoader``
(the mix's buckets and workers, ``drop_last``), each batch put on the card
as the trainer puts it (``batch_to_device``, one ``array_to_device`` an
array). Everything is built as ``bin/train_sambert.py`` builds it:
``models/builder.py``, ``criterion_builder``, ``optimizer_builder``.

Set-up writes a seeded synthetic MAS corpus under ``TMPDIR`` (removed at
the end), builds the model with weights from the seed and its optimizer,
puts the schedule at the mix's ``first_update`` (a run resumed there:
NoamLR far past its warm-up, fresh Adam moments), and runs the first three
steps through the window's own feed and call: they are the warm-up and
what is checked. The loss's ``epoch`` is the mix's, past the binarization
loss's ramp. The loader is started once and serves the whole run
(``gan_train.Passes``); items are cached after their first load (the
config's ``allow_cache``), as in every epoch of a real run but the first.

The check: the plain reference (``reference/sambert.py``) follows the same
three steps from the same weights on the same batches, with the dropout
masks the program drew in them (recorded below the autograd layer as the
dropout kernels return them: ``native_dropout``'s mask on the card,
``bernoulli_``'s draw on the CPU) and the hard path of the plain Viterbi
run on the program's own soft map of each step (``mas_path_cells``: the
cells where it differs from K1's path, which must be none); everything
continuous, the soft map included, the reference computes itself. It reads
each loss of step 1 (relative gaps, ``first_loss_gap``; ``loss_gap`` of
all three steps), the norm of each leaf's first gradient as Adam got it,
clipped, from its first moment (``grad_gap``; a leaf with no moment got
no gradient and reads 0), and the norm of each leaf's change over the
three steps (``change_gap``, the worst leaf;
``median_change_gap``, each part's median leaf, the largest of them; a
part is a top-level module). Gaps of leaves are taken as in
``gan_train.py`` (``leaf_gaps``, ``LEAF_FLOOR``).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import statistics
import tempfile
import time
from typing import Callable, Dict, List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from h100bench import devtrace
from h100bench.am_corpus import write_mas_corpus
from h100bench.devtrace import Laps
from h100bench.harness import set_tf32
from h100bench.paths.gan_train import BATCHES, CHECKED_STEPS, LEAF_FLOOR, Passes, leaf_gaps
from h100bench.reference import sambert as ref

# The program: what the timed path calls.
from kantts_tpu_torch.data.dataset import DataLoader, DistributedSampler, get_am_datasets
from kantts_tpu_torch.losses import criterion_builder
from kantts_tpu_torch.models.builder import build_sambert, sambert_model_builder
from kantts_tpu_torch.ops.mas import b_mas_cuda
from kantts_tpu_torch.train.steps import make_sambert_step
from kantts_tpu_torch.train.trainer import batch_to_device

DROPOUT_OPS = (torch.ops.aten.native_dropout.default, torch.ops.aten.bernoulli_.float)


class Drawn(TorchDispatchMode):
    """The dropout masks drawn while it is active, as (mask, p), in order:
    ``native_dropout``'s returned mask (a CUDA tensor's dropout), or the 0/1
    draw of ``bernoulli_`` (a CPU tensor's, drawn into a fresh tensor and
    then scaled in place, hence the copy)."""

    def __init__(self):
        super().__init__()
        self.masks: List[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is DROPOUT_OPS[0]:
            self.masks.append((out[1], float(args[1])))
        elif func is DROPOUT_OPS[1]:
            self.masks.append((out.clone(), 1.0 - float(args[1] if len(args) > 1
                                                        else kwargs.get("p", 0.5))))
        return out


def part(name: str) -> str:
    return name.split(".", 1)[0]


def device_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The reference's copy of a collated batch."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items() if v is not None}


class ProgramSteps:
    """The port's step and the state it updates. ``record()`` holds, for the
    calls inside it, the dropout masks and the MAS soft map and hard path of
    the last forward."""

    def __init__(self, config: dict, seed: int, device, epoch: int, first_update: int):
        torch.manual_seed(seed % 2 ** 63)  # dropout's draws
        built = sambert_model_builder(config, seed % 2 ** 63, device)
        self.model, self.opt = built["model"], built["optimizer"]
        sched = built["scheduler"]
        sched.last_epoch = first_update  # resumed at this update
        for group, base, factor in zip(self.opt.param_groups, sched.base_lrs,
                                       sched.lr_lambdas):
            group["lr"] = base * factor(first_update)
        sched._last_lr = [g["lr"] for g in self.opt.param_groups]
        rng = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
        self.step = make_sambert_step(self.model, criterion_builder(config), self.opt,
                                      sched, built["clip"], with_mas=True, generator=rng)
        self.device, self.epoch = device, epoch

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return self.step(batch_to_device(batch, self.device), self.epoch)

    @contextlib.contextmanager
    def record(self):
        seen: Dict[str, object] = {}
        handle = self.model.register_forward_hook(lambda module, args, res: seen.update(
            soft=res["attn_soft"].detach(), path=res["attn_hard"]))
        drawn = Drawn()
        try:
            with drawn:
                yield seen
        finally:
            handle.remove()
        seen["masks"] = drawn.masks

    def first_grad_norms(self) -> Dict[str, float]:
        """Every leaf's; one that Adam holds no moment for (it got no
        gradient) reads 0."""
        b1 = self.opt.param_groups[0]["betas"][0]
        out = {}
        for n, p in self.model.named_parameters():
            state = self.opt.state.get(p, {})
            out[n] = (float(torch.linalg.vector_norm(state["exp_avg"]) / (1 - b1))
                      if "exp_avg" in state else 0.0)
        return out

    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"model": dict(self.model.named_parameters())}


class ControlSteps:
    """The reference in the program's place, in TF32, drawing its own
    dropout masks and taking the path from its own soft map."""

    def __init__(self, config: dict, weights: Dict[str, torch.Tensor], seed: int,
                 device, tf32: bool, epoch: int, first_update: int):
        self.ref = ref.SambertReference(config, weights, first_update)
        self.gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
        self.device, self.tf32, self.epoch = device, tf32, epoch
        self.first, self.seen = None, {}

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        set_tf32(True)
        try:
            drop = ref.Dropout(generator=self.gen)
            out = self.ref.step(device_batch(batch, self.device), self.epoch, drop)
        finally:
            set_tf32(self.tf32)
        self.seen.update(soft=out["soft"], path=out["path"], masks=drop.drawn)
        if self.first is None:
            self.first = {k: float(torch.linalg.vector_norm(g))
                          for k, g in out["grads"].items()}
        return {**out["losses"], "TotalLoss": out["total"]}

    @contextlib.contextmanager
    def record(self):
        self.seen = {}
        yield self.seen

    def first_grad_norms(self) -> Dict[str, float]:
        return self.first

    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"model": self.ref.w}


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.config = dict(cfg["sambert"], audio_config=cfg["audio_config"],
                           batch_size=mix["batch"])
        self.params_cfg = self.config["Model"]["KanTtsSAMBERT"]["params"]
        self.frame_s = cfg["audio_config"]["hop_length"] / cfg["audio_config"]["sampling_rate"]
        self.control = False
        self.wrap: Callable = lambda step: step  # the tests break the step here
        self.dir = None

    def use_control(self) -> None:
        self.control = True

    # set-up
    def setup(self) -> None:
        lap = Laps()
        mix = self.mix
        self.dir = tempfile.mkdtemp(prefix=f"h100bench_{os.getpid()}_")
        c = mix["corpus"]
        write_mas_corpus(self.dir, c["utterances"], tuple(c["symbols"]),
                         tuple(c["frames"]), self.params_cfg["num_mels"], self.seed)
        lap("corpus")
        train_set, _ = get_am_datasets(
            [os.path.join(self.dir, "raw_metafile.txt")], [self.dir], self.config,
            self.config.get("allow_cache", False), input_bucket=mix["input_bucket"],
            frame_bucket=mix["frame_bucket"])
        sampler = Passes(DistributedSampler(len(train_set), 1, 0, shuffle=True,
                                            seed=self.seed % 2 ** 31),
                         BATCHES * mix["batch"])
        self.batches = iter(DataLoader(train_set, mix["batch"], sampler=sampler,
                                       drop_last=True, num_workers=mix["num_workers"]))
        epoch, first = mix["epoch"], mix["first_update"]
        if self.control:
            weights = dict(build_sambert(self.config, self.seed % 2 ** 63).to(
                self.device).named_parameters())
            self.steps = ControlSteps(self.config, weights, self.seed, self.device,
                                      self.cfg["tf32"], epoch, first)
        else:
            self.steps = ProgramSteps(self.config, self.seed, self.device, epoch, first)
        self.weights = {k: v.detach().clone()
                        for k, v in self.steps.params()["model"].items()}
        self.timed = self.wrap(self.steps)
        lap("weights")
        self.seen = []
        for k in range(CHECKED_STEPS):
            batch = next(self.batches)
            with self.steps.record() as rec:
                out = self.timed(batch)
            losses = {key: float(out[key]) for key in ref.LOSSES}
            self.seen.append({"batch": {key: None if v is None else v.copy()
                                        for key, v in batch.items()},
                              "losses": losses, **rec})
            if k == 0:
                self.grad_norms = self.steps.first_grad_norms()
        batch0 = self.seen[0]["batch"]
        self.k1_shape = (*batch0["mel_targets"].shape[:2], batch0["input_lings"].shape[1])
        theta = self.steps.params()["model"]
        self.change_norms = {k: float(torch.linalg.vector_norm(theta[k].detach() - w))
                             for k, w in self.weights.items()}
        self.sync()
        lap("checked_steps")
        self.phases = lap.phases

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step_flops(self) -> int:
        """Operations of one step: the reference step at the checked
        batches' padded shape on the meta device (CTC is not counted)."""
        meta = torch.device("meta")
        w = {k: torch.empty(v.shape, device=meta) for k, v in self.weights.items()}
        r = ref.SambertReference(self.config, w, self.mix["first_update"])
        b = {k: torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype, device=meta)
             for k, v in self.seen[0]["batch"].items() if v is not None}
        B, T_mel, _ = b["mel_targets"].shape
        path = torch.empty((B, 1, T_mel, b["input_lings"].shape[1]), device=meta)
        with FlopCounterMode(display=False) as counter:
            r.step(b, self.mix["epoch"], ref.Dropout(active=False), path=path,
                   with_ctc=False)
        return counter.get_total_flops()

    # the window
    def window(self, seconds: float) -> Dict[str, float]:
        self.n_steps, self.wait_s, frames = 0, 0.0, 0
        self.t_start = time.perf_counter()
        while time.perf_counter() - self.t_start < seconds:
            t0 = time.perf_counter()
            batch = next(self.batches)
            self.wait_s += time.perf_counter() - t0
            self.timed(batch)
            self.n_steps += 1
            frames += int(batch["valid_output_lengths"].sum())
        self.sync()
        self.window_s = time.perf_counter() - self.t_start
        return {"gan_train_audio_s_per_s": frames * self.frame_s / self.window_s}

    def profile(self, seconds: float) -> devtrace.Traced:
        """Trace about ``seconds`` of further steps (at least 3), twice;
        ``k1_launches``: K1's launches in each traced window, by its own
        counter."""
        n = self.traced_steps = max(3, int(seconds * self.n_steps / self.window_s))
        self.k1_launches = []

        def run() -> None:
            before = b_mas_cuda.launches
            for _ in range(n):
                with torch.profiler.record_function(devtrace.CALL_SPAN):
                    self.timed(next(self.batches))
            with torch.profiler.record_function(devtrace.CALL_SPAN):
                self.sync()
            self.k1_launches.append(b_mas_cuda.launches - before)
        return devtrace.profile_twice(run, self.sync)

    def release(self) -> None:
        self.steps = self.timed = None

    def cleanup(self) -> None:
        if getattr(self, "batches", None) is not None:
            self.batches.close()  # stops the loader's prefetch thread
            self.batches = None
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)
            self.dir = None

    # the check
    def check(self) -> Dict[str, List[float]]:
        reference = ref.SambertReference(self.config, self.weights, self.mix["first_update"])
        gen = torch.Generator(device=self.device).manual_seed(self.seed % 2 ** 63 + 1)
        loss_gaps, cells = [], []
        for k, s in enumerate(self.seen):
            out = reference.step(device_batch(s["batch"], self.device), self.mix["epoch"],
                                 ref.Dropout(s["masks"], generator=gen), path_soft=s["soft"])
            n = s["path"].shape[0]
            cells.append(float((out["path"][:n] != s["path"].to(out["path"].dtype)).sum()))
            for key in ref.LOSSES:
                want = float(out["losses"][key])
                loss_gaps.append(abs(s["losses"][key] - want) / abs(want))
            if k == 0:
                grads = {n: float(torch.linalg.vector_norm(g))
                         for n, g in out["grads"].items()}
        # every leaf of the model; one given no gradient on either side reads 0
        grads = {n: grads.get(n, 0.0) for n in self.weights}
        got = {n: self.grad_norms.get(n, 0.0) for n in self.weights}
        grad_gaps = leaf_gaps(got, grads, "model")
        change_gaps, medians = {}, {}
        for name in sorted({part(n) for n in grads}):
            mine = {n: g for n, g in grads.items() if part(n) == name}
            want = {n: float(torch.linalg.vector_norm(reference.w[n] - self.weights[n]))
                    for n in mine}
            floor = LEAF_FLOOR * statistics.median(mine.values())
            gaps = leaf_gaps(self.change_norms, want, name, lambda n: mine[n] >= floor)
            change_gaps.update(gaps)
            medians[name] = statistics.median(gaps.values())
        self.notes = {"worst_grad_leaf": max(grad_gaps, key=grad_gaps.get),
                      "worst_change_leaf": max(change_gaps, key=change_gaps.get),
                      "median_change_by_part": medians}
        n_losses = len(ref.LOSSES)
        return {"first_loss_gap": loss_gaps[:n_losses], "loss_gap": loss_gaps,
                "grad_gap": list(grad_gaps.values()),
                "change_gap": list(change_gaps.values()),
                "median_change_gap": list(medians.values()), "mas_path_cells": cells}

    def attempted(self) -> int:
        return self.n_steps

"""HiFi-GAN training: the port's ``make_gan_step`` (generator and
discriminator losses, both backward passes, both Adam updates and
schedules) fed back to back by its ``VocDataset`` and ``DataLoader``
(``bin/train_hifigan.py::VocLoader``, the config's workers), each batch
put on the card as the trainer puts it (``array_to_device``).

Set-up writes a seeded synthetic corpus under ``TMPDIR`` (removed at the
end), builds the generator and the discriminators with weights from the
seed and their optimizers, and runs the first three steps through the
window's own feed and call: they are the warm-up and what is checked.
The window goes on with the same object from step 4.

The loader is started once and serves the whole run: its sampler
(``Passes``) gives the port's ``DistributedSampler``'s order of one pass
of the corpus after another, so no pass ends inside the window, as none
does in a corpus whose epoch outlasts the window. Items are cached after
their first load (the config's ``allow_cache``), as in every epoch of a
real run but the first.

The check: the plain reference (``reference/gan.py``) follows the same
three steps from the same weights on the same batches. It reads each
step's generator and discriminator loss (relative gaps: ``first_loss_gap``
of step 1, ``loss_gap`` of all three), the norm of each leaf's first
gradient as Adam got it, worked out from its first moment after one step
(``grad_gap``), and the norm of each leaf's change over the three steps
(``change_gap``, the worst leaf; ``median_change_gap``, each network's
median leaf, the largest of them). A leaf's gap is taken against the
larger of its reference norm and the median leaf's of its network. Leaves
whose first reference gradient is under a thousandth of the median
leaf's move by round-off alone under Adam and are left out of the change.
``workloads/<cell>.json`` names the readings compared, with their limits.
"""

from __future__ import annotations

import os
import shutil
import statistics
import tempfile
import time
from typing import Callable, Dict, List

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench import devtrace
from h100bench.devtrace import Laps
from h100bench.harness import set_tf32
from h100bench.corpus import write_voc_corpus
from h100bench.reference import gan as ref_gan
from h100bench.reference import hifigan as ref_g
from h100bench.weights import seeded_weights

# The program: what the timed path calls.
from kantts_tpu_torch.bin.train_hifigan import VocLoader
from kantts_tpu_torch.data.dataset import DistributedSampler, get_voc_datasets
from kantts_tpu_torch.losses import criterion_builder
from kantts_tpu_torch.models.builder import vocoder_dtype
from kantts_tpu_torch.models.hifigan.discriminators import DISCRIMINATOR_CLASSES
from kantts_tpu_torch.models.hifigan.generator import Generator
from kantts_tpu_torch.train.optim import optimizer_builder
from kantts_tpu_torch.train.steps import make_gan_step
from kantts_tpu_torch.train.trainer import array_to_device

CHECKED_STEPS = 3
BATCHES = 4096  # the loader's batches in one run: more than any run takes
LEAF_FLOOR = 1e-3  # of the median leaf's first gradient: moved by round-off alone


def shapes(config: dict) -> Dict[str, dict]:
    """{network: {name: shape}}: the generator, then each discriminator
    family of the config, in the program's order."""
    model = config["Model"]
    out = {"Generator": ref_g.param_shapes(model["Generator"]["params"])}
    for fam in DISCRIMINATOR_CLASSES:
        if fam in model:
            out[fam] = ref_gan.DISCRIMINATORS[fam][1](model[fam]["params"])
    return out


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], net: str,
              keep: Callable[[str], bool] = lambda k: True) -> Dict[str, float]:
    """{net/leaf: |got - want| over the larger of want and the median
    leaf's want}."""
    median = statistics.median(want.values())
    return {f"{net}/{k}": abs(got[k] - want[k]) / max(want[k], median)
            for k in want if keep(k)}


class Passes:
    """The indices of ``sampler``'s passes 0, 1, 2, ... end to end, ``n`` of
    them in all: each pass the port's own order for that epoch."""

    def __init__(self, sampler: DistributedSampler, n: int):
        self.sampler, self.n = sampler, n

    def __iter__(self):
        epoch, left = 0, self.n
        while left > 0:
            self.sampler.set_epoch(epoch)
            indices = list(self.sampler)[:left]
            yield from indices
            left -= len(indices)
            epoch += 1

    def __len__(self) -> int:
        return self.n


class ProgramSteps:
    """The port's step and the state it updates."""

    def __init__(self, config: dict, weights: Dict[str, dict], seed: int, device):
        model = config["Model"]
        gp = model["Generator"]["params"]
        with torch.device(device):
            gen = Generator(**gp, dtype=vocoder_dtype(config))
            discs = {fam: DISCRIMINATOR_CLASSES[fam](**model[fam].get("params", {}),
                                                     dtype=gen.dtype)
                     for fam in weights if fam != "Generator"}
        self.nets = {"Generator": gen, **discs}
        self.opts, scheds, clips = {}, {}, {}
        for fam, net in self.nets.items():
            net.load_state_dict(weights[fam], strict=True)
            net.to(device).train()  # buffers made from numpy, the db3 filters
            key = "generator_grad_norm" if fam == "Generator" else "discriminator_grad_norm"
            self.opts[fam], scheds[fam], clips[fam] = optimizer_builder(
                net.parameters(), model[fam]["optimizer"], model[fam].get("scheduler"),
                config.get(key, -1))
        rng = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
        fams = [f for f in self.nets if f != "Generator"]
        self.step = make_gan_step(
            gen, discs, criterion_builder(config), self.opts["Generator"],
            scheds["Generator"], {f: self.opts[f] for f in fams},
            {f: scheds[f] for f in fams}, clips["Generator"],
            {f: clips[f] for f in fams}, train_generator=True,
            include_adversarial=True, pqmf=None, rng=rng)
        self.device = device

    def __call__(self, wav: np.ndarray, mel: np.ndarray) -> Dict[str, torch.Tensor]:
        return self.step(array_to_device(wav, self.device),
                         array_to_device(mel, self.device))

    def first_grad_norms(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for fam, net in self.nets.items():
            opt = self.opts[fam]
            b1 = opt.param_groups[0]["betas"][0]
            out[fam] = {n: float(torch.linalg.vector_norm(opt.state[p]["exp_avg"]) / (1 - b1))
                        for n, p in net.named_parameters()}
        return out

    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {fam: dict(net.named_parameters()) for fam, net in self.nets.items()}


class ControlSteps:
    """The reference in the program's place, in TF32."""

    def __init__(self, config: dict, weights: Dict[str, dict], device, tf32: bool):
        self.ref = ref_gan.GanReference(config, weights, device)
        self.device, self.tf32, self.first = device, tf32, None

    def __call__(self, wav: np.ndarray, mel: np.ndarray) -> Dict[str, torch.Tensor]:
        set_tf32(True)
        try:
            out = self.ref.step(torch.from_numpy(wav).to(self.device),
                                torch.from_numpy(mel).to(self.device))
        finally:
            set_tf32(self.tf32)
        if self.first is None:
            self.first = {fam: {k: float(torch.linalg.vector_norm(g)) for k, g in gs.items()}
                          for fam, gs in out["grads"].items()}
        return out

    def first_grad_norms(self):
        return self.first

    def params(self):
        return self.ref.w


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.config = dict(cfg["hifigan"], audio_config=cfg["audio_config"],
                           batch_size=mix["batch"], batch_max_steps=mix["batch_max_steps"])
        self.sr = cfg["audio_config"]["sampling_rate"]
        self.control = False
        self.wrap: Callable = lambda step: step  # the tests break the step here
        self.dir = None

    def use_control(self) -> None:
        self.control = True

    # set-up
    def setup(self) -> None:
        lap = Laps()
        self.dir = tempfile.mkdtemp(prefix=f"h100bench_{os.getpid()}_")
        c = self.mix["corpus"]
        write_voc_corpus(self.dir, c["utterances"], tuple(c["seconds"]),
                         self.cfg["audio_config"], self.seed)
        lap("corpus")
        train_set, _ = get_voc_datasets(self.config, [self.dir])
        sampler = Passes(DistributedSampler(len(train_set), 1, 0, shuffle=True,
                                            seed=self.seed % 2 ** 31),
                         BATCHES * self.mix["batch"])
        self.batches = iter(VocLoader(train_set, self.mix["batch"], sampler,
                                      seed=self.seed % 2 ** 32,
                                      num_workers=self.config.get("num_workers", 0)))
        self.weights = {fam: seeded_weights(s, self.seed + i, self.device)
                        for i, (fam, s) in enumerate(shapes(self.config).items())}
        if self.control:
            self.steps = ControlSteps(self.config, self.weights, self.device,
                                      self.cfg["tf32"])
        else:
            self.steps = ProgramSteps(self.config, self.weights, self.seed, self.device)
        self.timed = self.wrap(self.steps)
        lap("weights")
        self.seen = []
        for k in range(CHECKED_STEPS):
            wav, mel = next(self.batches)
            self.seen.append((wav.copy(), mel.copy()))
            out = self.timed(wav, mel)
            self.seen[-1] += (float(out["generator_loss"]), float(out["discriminator_loss"]))
            if k == 0:
                self.grad_norms = self.steps.first_grad_norms()
        theta = self.steps.params()
        self.change_norms = {
            fam: {k: float(torch.linalg.vector_norm(theta[fam][k].detach() - w[k]))
                  for k in theta[fam]} for fam, w in self.weights.items()}
        self.sync()
        lap("checked_steps")
        self.phases = lap.phases

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step_flops(self) -> int:
        """Operations of one step: the reference step at the batch's shape
        on the meta device (FFTs are not counted)."""
        meta = torch.device("meta")
        w = {fam: {k: torch.empty(s, device=meta) for k, s in sh.items()}
             for fam, sh in shapes(self.config).items()}
        ref = ref_gan.GanReference(self.config, w, meta)
        gp = self.config["Model"]["Generator"]["params"]
        B, T = self.mix["batch"], self.mix["batch_max_steps"]
        frames = T // ref_g.hop(gp)
        with FlopCounterMode(display=False) as counter:
            ref.step(torch.empty((B, T, 1), device=meta),
                     torch.empty((B, frames, gp["in_channels"]), device=meta))
        return counter.get_total_flops()

    # the window
    def window(self, seconds: float) -> Dict[str, float]:
        self.n_steps, self.wait_s = 0, 0.0
        self.t_start = time.perf_counter()
        while time.perf_counter() - self.t_start < seconds:
            t0 = time.perf_counter()
            batch = next(self.batches)
            self.wait_s += time.perf_counter() - t0
            self.timed(*batch)
            self.n_steps += 1
        self.sync()
        self.window_s = time.perf_counter() - self.t_start
        audio_s = self.n_steps * self.mix["batch"] * self.mix["batch_max_steps"] / self.sr
        return {"gan_train_audio_s_per_s": audio_s / self.window_s}

    def profile(self, seconds: float) -> devtrace.Traced:
        """Trace about ``seconds`` of further steps (at least 3), twice."""
        n = self.traced_steps = max(3, int(seconds * self.n_steps / self.window_s))

        def run() -> None:
            for _ in range(n):
                with torch.profiler.record_function(devtrace.CALL_SPAN):
                    self.timed(*next(self.batches))
            with torch.profiler.record_function(devtrace.CALL_SPAN):
                self.sync()
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
        ref = ref_gan.GanReference(self.config, self.weights, self.device)
        loss_gaps = []
        for k, (wav, mel, g_loss, d_loss) in enumerate(self.seen):
            out = ref.step(torch.from_numpy(wav).to(self.device),
                           torch.from_numpy(mel).to(self.device))
            for got, key in ((g_loss, "generator_loss"), (d_loss, "discriminator_loss")):
                want = float(out[key])
                loss_gaps.append(abs(got - want) / abs(want))
            if k == 0:
                grads = {fam: {n: float(torch.linalg.vector_norm(g)) for n, g in gs.items()}
                         for fam, gs in out["grads"].items()}
        grad_gaps, change_gaps, medians = {}, {}, []
        for fam, w in self.weights.items():
            want = {n: float(torch.linalg.vector_norm(ref.w[fam][n] - w[n]))
                    for n in ref.w[fam]}
            floor = LEAF_FLOOR * statistics.median(grads[fam].values())
            grad_gaps.update(leaf_gaps(self.grad_norms[fam], grads[fam], fam))
            gaps = leaf_gaps(self.change_norms[fam], want, fam,
                             lambda n: grads[fam][n] >= floor)
            change_gaps.update(gaps)
            medians.append(statistics.median(gaps.values()))
        self.notes = {"worst_grad_leaf": max(grad_gaps, key=grad_gaps.get),
                      "worst_change_leaf": max(change_gaps, key=change_gaps.get)}
        return {"first_loss_gap": loss_gaps[:2], "loss_gap": loss_gaps,
                "grad_gap": list(grad_gaps.values()),
                "change_gap": list(change_gaps.values()),
                "median_change_gap": medians}

    def attempted(self) -> int:
        return self.n_steps

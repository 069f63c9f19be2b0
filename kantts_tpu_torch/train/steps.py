"""Train and eval steps of SAM-BERT, Textsy-BERT and the HiFi-GAN GAN
(counterparts of ``make_sambert_step``, ``make_sybert_step``,
``make_gan_step`` and ``make_gan_eval_step`` in
``kantts_tpu/train/steps.py``).

SAM-BERT: one optimizer; the total is mel(dec) + mel(postnet) + duration +
pitch + energy, plus CTC and the binarization KL with MAS, plus the FP
cross-entropy with FP. Textsy-BERT: the masked cross-entropy divided by
the sy vocabulary size, as KAN-TTS divides it before backward. The GAN step:
generator losses and update, the fake regenerated by the updated generator,
then the discriminator losses and one update per discriminator family.
Steps take device tensors and return their metrics as detached device
scalars: nothing in a step reads a value back to the host, so the caller
decides when to wait (the trainer does at log time). On a CUDA device a GAN
step function replays one CUDA graph of its step from its second call on,
where the step allows it (``make_gan_step``).

Data parallelism (``data_parallel``, by default whenever the process is in a
process group; ``parallel/mesh.py``): each rank runs its shard of the global
batch. The criteria take their normalisers summed over the ranks, so each
rank's loss is its share of the global-batch loss; the SAM-BERT band width is
the global batch's; after the backward the gradients are summed over the
ranks, one collective per optimizer, before the clip and the update; the
metrics returned are the global ones, summed as one device vector. None of
it reads a value back to the host. Under tensor parallelism (``group``, a
grid's data group; ``parallel/tp.py``) all of it goes over the data group,
while the sharded layers reduce over the model group inside the forward and
backward, and the clip (``tp.make_clip``) takes the norm of the logical
parameters.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from kantts_tpu_torch.losses.losses import Reduce
from kantts_tpu_torch.parallel import mesh
from kantts_tpu_torch.train import optim
from kantts_tpu_torch.utils import profiling
from kantts_tpu_torch.utils.profiling import span

Metrics = Dict[str, torch.Tensor]
# SAM-BERT metrics that are equal on every rank, not shares of a sum
REPLICATED_METRICS = ("x_band_width", "h_band_width")


class DataParallel:
    """What a step does across ranks, or nothing (``enabled`` False): the
    reducer of the criteria, the band-width maximum, the gradient all-reduce
    and the metrics' sum, over ``group`` (the world by default). ``timer``
    (a ``mesh.CollectiveTimer``) times the collectives."""

    def __init__(self, enabled: Optional[bool] = None,
                 timer: Optional[mesh.CollectiveTimer] = None,
                 group: mesh.Group = None):
        self.enabled = mesh.is_distributed() if enabled is None else enabled
        self.timer = timer
        self.group = group
        self.reduce: Optional[Reduce] = (
            functools.partial(mesh.global_sum, timer=timer, group=group)
            if self.enabled else None)
        self.global_max = (functools.partial(mesh.global_max, timer=timer, group=group)
                           if self.enabled else None)

    def grads(self, optimizer: torch.optim.Optimizer) -> None:
        """Sum the gradients of ``optimizer``'s parameters over the ranks."""
        if self.enabled:
            mesh.all_reduce_grads(mesh.optimizer_params(optimizer), self.timer,
                                  self.group)

    def metrics(self, metrics: Metrics) -> Metrics:
        """The global metrics: every share summed over the ranks in one call."""
        keys = [k for k in metrics if k not in REPLICATED_METRICS]
        if not self.enabled or not keys:
            return metrics
        return {**metrics, **dict(zip(keys, self.reduce(*(metrics[k] for k in keys))))}

    def batch_share(self, batch_size: int, like: torch.Tensor
                    ) -> Optional[torch.Tensor]:
        """This shard's items over the global batch's (None without data
        parallelism): the weight of a plain mean over crops of one length."""
        if not self.enabled:
            return None
        local = like.new_full((), batch_size, dtype=torch.int64)
        total, = self.reduce(local)
        return local / total


def _scaled(x, share: Optional[torch.Tensor]):
    return x if share is None else x * share


def sambert_forward(model: nn.Module, batch: Dict[str, Any],
                    ss_prob: Optional[float] = None,
                    generator: Optional[torch.Generator] = None,
                    fp_dict_lings: Optional[torch.Tensor] = None,
                    global_max: Optional[Callable] = None) -> Dict[str, Any]:
    """The teacher-forced forward on a batch with the dataset's keys; an FP
    batch's ``fp_plan`` splices in the filler triples ``fp_dict_lings``
    (the dataset's, (3, 3, 4)). ``global_max`` is the band width's maximum
    over the ranks."""
    return model(
        batch["input_lings"], batch["input_emotions"], batch["input_speakers"],
        batch["valid_input_lengths"], batch["valid_output_lengths"],
        batch["mel_targets"], duration_targets=batch.get("durations"),
        pitch_targets=batch["pitch_contours"],
        energy_targets=batch["energy_contours"],
        attn_priors=batch.get("attn_priors"), fp_plan=batch.get("fp_plan"),
        fp_dict_lings=fp_dict_lings, ss_prob=ss_prob, generator=generator,
        global_max=global_max)


def sambert_losses(model: nn.Module, criterion: Dict[str, Any],
                   batch: Dict[str, Any], epoch: int, with_mas: bool,
                   ss_prob: Optional[float] = None,
                   generator: Optional[torch.Generator] = None,
                   fp_dict_lings: Optional[torch.Tensor] = None,
                   dp: Optional[DataParallel] = None
                   ) -> Tuple[torch.Tensor, Metrics]:
    """Forward and criteria in the model's current mode -> (total, metrics).
    The prosody losses are masked by ``valid_inter_lengths`` (the spliced
    lengths of an FP batch), the FP loss by the input lengths. With ``dp``
    the total is this rank's share of the global batch's."""
    dp = dp if dp is not None else DataParallel(False)
    reduce = dp.reduce
    with span(profiling.AM_FORWARD):
        res = sambert_forward(model, batch, ss_prob, generator, fp_dict_lings,
                              dp.global_max)
    with span(profiling.AM_LOSS):
        mel_loss_, mel_loss = criterion["MelReconLoss"](
            batch["valid_output_lengths"], batch["mel_targets"],
            res["dec_outputs"], res["postnet_outputs"], reduce=reduce)
        dur_loss, pitch_loss, energy_loss = criterion["ProsodyReconLoss"](
            res["valid_inter_lengths"], res["duration_targets"],
            res["pitch_targets"], res["energy_targets"],
            res["log_duration_predictions"], res["pitch_predictions"],
            res["energy_predictions"], reduce=reduce)
        total = mel_loss_ + mel_loss + dur_loss + pitch_loss + energy_loss
        metrics = {
            "mel_loss_": mel_loss_, "mel_loss": mel_loss, "dur_loss": dur_loss,
            "pitch_loss": pitch_loss, "energy_loss": energy_loss,
            "x_band_width": res["x_band_width"].float(),
            "h_band_width": res["h_band_width"].float(),
        }
        if getattr(model, "fp_enable", False):
            fp_loss = criterion["FpCELoss"](batch["valid_input_lengths"],
                                            res["fp_predictions"], batch["fp_label"],
                                            reduce=reduce)
            total = total + fp_loss
            metrics["fp_loss"] = fp_loss
        if with_mas:
            ctc = criterion["AttentionCTCLoss"](
                res["attn_logprob"], batch["valid_input_lengths"],
                batch["valid_output_lengths"], reduce=reduce)
            kl = criterion["AttentionBinarizationLoss"](
                epoch, res["attn_hard"], res["attn_soft"], reduce=reduce)
            total = total + ctc + kl
            metrics["attn_ctc_loss"] = ctc
            metrics["attn_kl_loss"] = kl
        metrics["TotalLoss"] = total
        return total, {k: v.detach() for k, v in metrics.items()}


def make_sambert_step(model: nn.Module, criterion: Dict[str, Any],
                      optimizer: torch.optim.Optimizer,
                      scheduler: torch.optim.lr_scheduler.LRScheduler,
                      clip: Optional[Callable[[], torch.Tensor]], with_mas: bool,
                      train: bool = True,
                      generator: Optional[torch.Generator] = None,
                      fp_dict_lings: Optional[torch.Tensor] = None,
                      data_parallel: Optional[bool] = None,
                      timer: Optional[mesh.CollectiveTimer] = None,
                      group: mesh.Group = None
                      ) -> Callable[[Dict[str, torch.Tensor], int], Metrics]:
    """-> step(batch, epoch) -> metrics. ``clip`` is the global-norm clip of
    ``optimizer_builder`` (None: no clip). The train step runs in ``train()``
    mode: zero the gradients, forward, backward, clip, update, advance the
    schedule, each train call inside the span ``kantts.am.step`` and its
    phases inside theirs (``utils/profiling.py``). The eval step runs in
    ``eval()`` mode without gradients.

    Scheduled sampling follows the config keys ``scheduled_sampling_prob``
    (the largest replacement probability; 0 is off) and
    ``scheduled_sampling_ramp_steps`` (the updates over which it ramps up
    linearly from 0); the update count is the scheduler's, so it resumes
    with it. Its draws come from ``generator``. An FP model's steps splice
    in ``fp_dict_lings``. ``data_parallel``, ``timer`` and ``group``: see
    ``DataParallel``; under tensor parallelism ``group`` is the grid's data
    group and ``clip`` is ``tp.make_clip``'s."""
    dp = DataParallel(data_parallel, timer, group)
    cfg = getattr(model, "config", {}) or {}
    ss_max = float(cfg.get("scheduled_sampling_prob", 0.0))
    ss_ramp = float(cfg.get("scheduled_sampling_ramp_steps", 10_000))

    if not train:
        @torch.no_grad()
        def eval_step(batch, epoch):
            model.eval()
            return dp.metrics(sambert_losses(model, criterion, batch, epoch,
                                             with_mas, fp_dict_lings=fp_dict_lings,
                                             dp=dp)[1])

        return eval_step

    def train_step(batch, epoch):
        with span(profiling.AM_STEP):
            model.train()
            ss_prob = None
            if ss_max > 0.0:
                ss_prob = ss_max * min(scheduler.last_epoch / ss_ramp, 1.0)
            optimizer.zero_grad(set_to_none=True)
            total, metrics = sambert_losses(model, criterion, batch, epoch, with_mas,
                                            ss_prob, generator, fp_dict_lings, dp)
            with span(profiling.AM_BACKWARD):
                total.backward()
                dp.grads(optimizer)
            if clip is not None:
                with span(profiling.AM_CLIP):
                    clip()
            with span(profiling.AM_UPDATE):
                optimizer.step()
                scheduler.step()
            return dp.metrics(metrics)

    return train_step


# ------------------------------------------------------------ Textsy-BERT


def sybert_losses(model: nn.Module, criterion: Dict[str, Any],
                  batch: Dict[str, torch.Tensor],
                  reduce: Optional[Reduce] = None) -> Tuple[torch.Tensor, Metrics]:
    """Textsy-BERT's forward and ``SeqCELoss`` in the model's current mode ->
    (loss, metrics). The loss is divided by the sy vocabulary size (the
    logits' last axis) before backward, as KAN-TTS divides it in train and
    eval: the scale changes the gradients and how hard ``grad_norm`` clips
    them. With ``reduce`` both are this rank's shares of the global batch's."""
    res = model(batch["input_lings"], batch["valid_input_lengths"])
    loss, err = criterion["SeqCELoss"](res["logits"], batch["targets"],
                                       batch["loss_masks"], reduce=reduce)
    loss = loss / res["logits"].shape[-1]
    return loss, {"loss": loss.detach(), "error_rate": err.detach()}


def make_sybert_step(model: nn.Module, criterion: Dict[str, Any],
                     optimizer: torch.optim.Optimizer,
                     scheduler: torch.optim.lr_scheduler.LRScheduler,
                     clip: Optional[Callable[[], torch.Tensor]],
                     train: bool = True, data_parallel: Optional[bool] = None,
                     timer: Optional[mesh.CollectiveTimer] = None
                     ) -> Callable[[Dict[str, torch.Tensor]], Metrics]:
    """-> step(batch) -> metrics ("loss", "error_rate"). The train step runs
    in ``train()`` mode: zero the gradients, forward, backward, clip,
    update, advance the schedule; the eval step in ``eval()`` mode without
    gradients. ``data_parallel`` and ``timer``: see ``DataParallel``."""
    dp = DataParallel(data_parallel, timer)
    if not train:
        @torch.no_grad()
        def eval_step(batch):
            model.eval()
            return dp.metrics(sybert_losses(model, criterion, batch, dp.reduce)[1])

        return eval_step

    def train_step(batch):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = sybert_losses(model, criterion, batch, dp.reduce)
        loss.backward()
        dp.grads(optimizer)
        if clip is not None:
            clip()
        optimizer.step()
        scheduler.step()
        return dp.metrics(metrics)

    return train_step


# ------------------------------------------------------------------ GAN

Discriminators = Dict[str, nn.Module]


def run_discriminators(discriminators: Discriminators, y: torch.Tensor,
                       update_stats: bool = False):
    """y (B, 1, T) through every discriminator -> ({name: scores},
    {name: feature maps})."""
    outs, fmaps = {}, {}
    for name, disc in discriminators.items():
        with span(profiling.gan_net(name)):
            outs[name], fmaps[name] = disc(y, update_stats)
    return outs, fmaps


def generator_losses(generator: nn.Module, discriminators: Discriminators,
                     criterion: Dict[str, Any], wav: torch.Tensor,
                     mel: torch.Tensor, include_adversarial: bool,
                     pqmf: Optional[nn.Module] = None,
                     rng: Optional[torch.Generator] = None,
                     reduce: Optional[Reduce] = None,
                     share: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Metrics]:
    """wav (B, T, 1), mel (B, frames, C) -> (generator loss, metrics): the
    weighted sum of the multi-resolution STFT loss, the sub-band STFT loss,
    the mel loss and, with ``include_adversarial``, the adversarial and
    feature-matching losses. With ``pqmf`` the generator's output is the
    sub-band signal and its synthesis the full band that every term but the
    sub-band one sees. The sub-band term first halves the loss so far (the
    STFT term alone, as the JAX step does), then adds half its own sum,
    unweighted. The discriminators run with their stored spectral vectors;
    the real feature maps are taken without gradient. An NSF generator
    draws from ``rng``. Under data parallelism the STFT losses take their
    sums over the ranks through ``reduce`` and every mean is weighted by
    ``share``, the shard's part of the global batch."""
    with span(profiling.GAN_GENERATOR):
        y_ = generator(mel, generator=rng)
    y_full = pqmf.synthesis(y_) if pqmf is not None else y_
    yt, yt_ = wav[..., 0], y_full[..., 0]
    gen_loss = 0.0
    metrics = {}
    if "stft_loss" in criterion:
        sc, mag = criterion["stft_loss"](yt_, yt, reduce)
        gen_loss = gen_loss + (sc + mag) * criterion["stft_loss"].weights
        metrics["spectral_convergence_loss"] = sc
        metrics["log_stft_magnitude_loss"] = mag
    if "subband_stft_loss" in criterion and pqmf is not None:
        gen_loss = gen_loss * 0.5
        sub_sc, sub_mag = criterion["subband_stft_loss"](
            y_.transpose(1, 2), pqmf.analysis(wav).transpose(1, 2), reduce)
        gen_loss = gen_loss + 0.5 * (sub_sc + sub_mag)
        metrics["sub_spectral_convergence_loss"] = sub_sc
        metrics["sub_log_stft_magnitude_loss"] = sub_mag
    if "mel_loss" in criterion:
        mel_l = _scaled(criterion["mel_loss"](yt_, yt), share)
        gen_loss = gen_loss + mel_l * criterion["mel_loss"].weights
        metrics["mel_loss"] = mel_l
    if include_adversarial:
        fake_outs, fake_fmaps = run_discriminators(discriminators,
                                                   y_full.transpose(1, 2))
        adv = _scaled(sum(criterion["generator_adv_loss"](fake_outs[n])
                          for n in discriminators), share)
        gen_loss = gen_loss + adv * criterion["generator_adv_loss"].weights
        metrics["adversarial_loss"] = adv
        if "feat_match_loss" in criterion:
            with torch.no_grad():
                _, real_fmaps = run_discriminators(discriminators,
                                                   wav.transpose(1, 2))
            fm = _scaled(sum(criterion["feat_match_loss"](fake_fmaps[n], real_fmaps[n])
                             for n in discriminators), share)
            gen_loss = gen_loss + fm * criterion["feat_match_loss"].weights
            metrics["feature_matching_loss"] = fm
    metrics["generator_loss"] = gen_loss
    return gen_loss, {k: v.detach() for k, v in metrics.items()}


def discriminator_losses(discriminators: Discriminators,
                         criterion: Dict[str, Any], wav: torch.Tensor,
                         y_fake: torch.Tensor, share: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Metrics]:
    """wav and y_fake (B, 1, T) -> (real + fake loss, metrics). The real pass
    stores the new spectral vectors (``update_stats``); the fake pass runs
    first, so that both read the same stored vectors, as in the JAX step,
    where the fake pass reads the old ones. ``share`` weights the means by
    the shard's part of the global batch."""
    fake_outs, _ = run_discriminators(discriminators, y_fake)
    real_outs, _ = run_discriminators(discriminators, wav, update_stats=True)
    real_total = fake_total = 0.0
    for name in discriminators:
        real_l, fake_l = criterion["discriminator_adv_loss"](fake_outs[name],
                                                              real_outs[name])
        real_total = real_total + real_l
        fake_total = fake_total + fake_l
    real_total, fake_total = _scaled(real_total, share), _scaled(fake_total, share)
    dis_loss = real_total + fake_total
    return dis_loss, {"real_loss": real_total.detach(),
                      "fake_loss": fake_total.detach(),
                      "discriminator_loss": dis_loss.detach()}


def _set_requires_grad(params: Iterable[nn.Parameter], flag: bool) -> None:
    for p in params:
        p.requires_grad_(flag)


class _StepGraph:
    """The CUDA graph of one GAN step function's ``body`` (its losses,
    backward passes and updates, without the schedules), for the shapes of
    its first batch.

    The first call is the warm-up: the optimizers are made capturable
    (``optim.make_capturable``), then ``eager`` runs a real step on a side
    stream, which makes cuDNN's, cuFFT's and cuBLAS's state and Adam's
    before anything is captured. The next call of those shapes captures
    ``body`` on copies of its inputs and replays it once (a capture runs
    nothing, so that replay is the step); every later one copies its
    inputs in and replays. A call of other shapes runs ``eager``.

    Each optimizer group's learning rate is a device tensor during the
    capture alone, filled from the group's float before every replay: the
    replay follows the schedules, which step after it, and the groups, the
    schedules and their checkpoints keep floats. The metrics of a replay are
    new tensors, one stack of the graph's own a dtype, so a caller may hold
    them across steps. The graph holds the optimizers' state tensors: state
    is loaded into the optimizers before the first step, not after."""

    def __init__(self, body: Callable, schedule: Callable[[], None],
                 eager: Callable, optimizers, stats: Dict[str, int]):
        self.body, self.schedule, self.eager = body, schedule, eager
        self.optimizers, self.stats = optimizers, stats
        self.key = self.graph = None

    def takes(self, wav: torch.Tensor, mel: torch.Tensor) -> bool:
        if self.key is None:
            return wav.is_cuda and all(p.device == wav.device for o in self.optimizers
                                       for g in o.param_groups for p in g["params"])
        return _batch_key(wav, mel) == self.key

    def __call__(self, wav: torch.Tensor, mel: torch.Tensor) -> Metrics:
        if self.key is None:
            return self.warm_up(wav, mel)
        if self.graph is None:
            self.capture(wav, mel)
        else:
            self.wav.copy_(wav)
            self.mel.copy_(mel)
        with span(profiling.GAN_REPLAY):
            for lr, group in self.lrs:
                lr.fill_(group["lr"])
            self.graph.replay()
        self.stats["replays"] += 1
        self.schedule()
        out = {}
        for keys, values in self.outputs:
            out.update(zip(keys, torch.stack(values).unbind()))
        return {k: out[k] for k in self.order}

    def warm_up(self, wav: torch.Tensor, mel: torch.Tensor) -> Metrics:
        for opt in self.optimizers:
            optim.make_capturable(opt)
        side, main = torch.cuda.Stream(wav.device), torch.cuda.current_stream(wav.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            metrics = self.eager(wav, mel)
        main.wait_stream(side)
        self.key = _batch_key(wav, mel)
        self.stats["eager"] += 1
        return metrics

    def capture(self, wav: torch.Tensor, mel: torch.Tensor) -> None:
        self.wav, self.mel = wav.clone(), mel.clone()
        groups = [g for o in self.optimizers for g in o.param_groups]
        rates = [g["lr"] for g in groups]
        self.lrs = [(torch.full((), r, device=wav.device), g) for r, g in zip(rates, groups)]
        graph = torch.cuda.CUDAGraph()
        try:
            for lr, group in self.lrs:
                group["lr"] = lr
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                metrics = self.body(self.wav, self.mel)
        finally:
            for rate, group in zip(rates, groups):
                group["lr"] = rate
        by_dtype: Dict[torch.dtype, list] = {}
        for k, v in metrics.items():
            by_dtype.setdefault(v.dtype, []).append(k)
        self.outputs = [(keys, [metrics[k] for k in keys]) for keys in by_dtype.values()]
        self.order = list(metrics)
        self.graph = graph
        self.stats["captures"] += 1


def _batch_key(wav: torch.Tensor, mel: torch.Tensor) -> tuple:
    return (wav.shape, wav.dtype, wav.device, mel.shape, mel.dtype, mel.device)


def make_gan_step(generator: nn.Module, discriminators: Discriminators,
                  criterion: Dict[str, Any],
                  gen_optimizer: torch.optim.Optimizer,
                  gen_scheduler: torch.optim.lr_scheduler.LRScheduler,
                  disc_optimizers: Dict[str, torch.optim.Optimizer],
                  disc_schedulers: Dict[str, torch.optim.lr_scheduler.LRScheduler],
                  gen_clip: Optional[Callable[[], torch.Tensor]] = None,
                  disc_clips: Optional[Dict[str, Optional[Callable]]] = None,
                  train_generator: bool = True, include_adversarial: bool = True,
                  pqmf: Optional[nn.Module] = None,
                  rng: Optional[torch.Generator] = None,
                  data_parallel: Optional[bool] = None,
                  timer: Optional[mesh.CollectiveTimer] = None
                  ) -> Callable[[torch.Tensor, torch.Tensor], Metrics]:
    """-> step(wav (B, T, 1), mel (B, frames, C)) -> metrics.
    ``train_generator`` and ``include_adversarial`` are the warm-up gates;
    ``pqmf`` synthesises a multi-band generator's full band. An NSF
    generator draws from ``rng``: both of a step's generator forwards make
    the same draws (the JAX step passes one key to both), and the step
    leaves ``rng`` one draw further on.

    1. Generator losses with the discriminators frozen (the JAX step
       differentiates the generator's parameters only), backward, clip,
       update.
    2. With ``include_adversarial``: the fake regenerated by the updated
       generator without gradient, the discriminator losses, backward, and
       per family clip and update.
    3. The schedules of the optimizers the step updated.

    ``data_parallel`` and ``timer``: see ``DataParallel``; the gradients are
    summed over the ranks after each backward, the generator's in one
    collective and each discriminator family's in one.

    On a CUDA device, 1 and 2 run as one CUDA graph (``_StepGraph``) from
    the step function's second call on, where what the step can observe
    allows it: no data parallelism, a generator with no NSF source (its
    draws rewind ``rng`` between the two forwards), Adam or AdamW
    optimizers (``capturable``), and the shapes and dtypes of the first
    batch. Every other call runs them eagerly. ``step.graph`` is the
    ``_StepGraph``, None where no call can replay; ``step.graph_stats``
    counts the calls: ``captures``, ``replays`` and ``eager``;
    ``step.eager`` is the step run eagerly, what the graph captures, for
    tests to hold the graph against.

    A step opens the spans of ``utils/profiling.py``: ``kantts.gan.step``
    around it; on an eager step one span a phase (``GAN_PHASES``:
    ``g_loss``, ``g_backward``, ``g_update``, then ``d_regen``, ``d_loss``,
    ``d_backward``, ``d_update``; a phase that a gate skips opens none) and
    one around each network forward; on a replay ``kantts.gan.replay``."""
    dp = DataParallel(data_parallel, timer)
    disc_params = [p for d in discriminators.values() for p in d.parameters()]
    disc_clips = disc_clips or {}
    optimizers = (([gen_optimizer] if train_generator else [])
                  + (list(disc_optimizers.values()) if include_adversarial else []))

    def body(wav: torch.Tensor, mel: torch.Tensor,
             rewind: Optional[Callable[[], None]] = None) -> Metrics:
        metrics = {}
        share = dp.batch_share(wav.shape[0], wav)
        if train_generator:
            try:
                with span(profiling.GAN_G_LOSS):
                    gen_optimizer.zero_grad(set_to_none=True)
                    _set_requires_grad(disc_params, False)
                    gen_loss, gmetrics = generator_losses(
                        generator, discriminators, criterion, wav, mel,
                        include_adversarial, pqmf, rng, dp.reduce, share)
                with span(profiling.GAN_G_BACKWARD):
                    gen_loss.backward()
            finally:
                _set_requires_grad(disc_params, True)
            with span(profiling.GAN_G_UPDATE):
                dp.grads(gen_optimizer)
                if gen_clip is not None:
                    gen_clip()
                gen_optimizer.step()
            metrics.update(gmetrics)
        if include_adversarial:
            with span(profiling.GAN_D_REGEN):
                if rewind is not None:
                    rewind()
                with torch.no_grad():
                    with span(profiling.GAN_GENERATOR):
                        y_fake = generator(mel, generator=rng)
                    if pqmf is not None:
                        y_fake = pqmf.synthesis(y_fake)
                    y_fake = y_fake.transpose(1, 2)
            with span(profiling.GAN_D_LOSS):
                for opt in disc_optimizers.values():
                    opt.zero_grad(set_to_none=True)
                dis_loss, dmetrics = discriminator_losses(
                    discriminators, criterion, wav.transpose(1, 2), y_fake, share)
            with span(profiling.GAN_D_BACKWARD):
                dis_loss.backward()
            with span(profiling.GAN_D_UPDATE):
                for name in discriminators:
                    dp.grads(disc_optimizers[name])
                    if disc_clips.get(name) is not None:
                        disc_clips[name]()
                    disc_optimizers[name].step()
            metrics.update(dmetrics)
        return dp.metrics(metrics)

    def schedule() -> None:
        if train_generator:
            gen_scheduler.step()
        if include_adversarial:
            for name in discriminators:
                disc_schedulers[name].step()

    def eager(wav: torch.Tensor, mel: torch.Tensor) -> Metrics:
        rewind = None
        if rng is not None:
            rewind = functools.partial(rng.set_state, rng.get_state())
        metrics = body(wav, mel, rewind)
        schedule()
        return metrics

    stats = {"captures": 0, "replays": 0, "eager": 0}
    graph = None
    if (optimizers and not dp.enabled
            and getattr(generator, "nsf_params", None) is None
            and all("capturable" in o.defaults for o in optimizers)):
        graph = _StepGraph(body, schedule, eager, optimizers, stats)

    def step(wav: torch.Tensor, mel: torch.Tensor) -> Metrics:
        with span(profiling.GAN_STEP):
            if graph is not None and graph.takes(wav, mel):
                return graph(wav, mel)
            stats["eager"] += 1
            return eager(wav, mel)

    def step_eagerly(wav: torch.Tensor, mel: torch.Tensor) -> Metrics:
        with span(profiling.GAN_STEP):
            return eager(wav, mel)

    step.graph, step.graph_stats, step.eager = graph, stats, step_eagerly
    return step


def make_gan_eval_step(generator: nn.Module, discriminators: Discriminators,
                       criterion: Dict[str, Any], pqmf: Optional[nn.Module] = None,
                       rng: Optional[torch.Generator] = None,
                       data_parallel: Optional[bool] = None,
                       timer: Optional[mesh.CollectiveTimer] = None
                       ) -> Callable[[torch.Tensor, torch.Tensor],
                                     Tuple[Metrics, torch.Tensor]]:
    """-> eval_step(wav, mel) -> (metrics, generated wav (B, T, 1)): the
    criteria of the config without gradient and without updates (the
    generated wav is the full band, after ``pqmf``'s synthesis); the
    discriminators keep their spectral vectors. An NSF generator draws from
    ``rng``. Under data parallelism the metrics are the global batch's."""
    dp = DataParallel(data_parallel, timer)

    @torch.no_grad()
    def eval_step(wav: torch.Tensor, mel: torch.Tensor):
        share = dp.batch_share(wav.shape[0], wav)
        y_ = generator(mel, generator=rng)
        if pqmf is not None:
            y_ = pqmf.synthesis(y_)
        yt, yt_ = wav[..., 0], y_[..., 0]
        metrics = {}
        if "mel_loss" in criterion:
            metrics["mel_loss"] = _scaled(criterion["mel_loss"](yt_, yt), share)
        if "stft_loss" in criterion:
            sc, mag = criterion["stft_loss"](yt_, yt, dp.reduce)
            metrics["spectral_convergence_loss"] = sc
            metrics["log_stft_magnitude_loss"] = mag
        adv = fm = real_total = fake_total = 0.0
        fake_outs, fake_fmaps = run_discriminators(discriminators,
                                                   y_.transpose(1, 2))
        real_outs, real_fmaps = run_discriminators(discriminators,
                                                   wav.transpose(1, 2))
        for name in discriminators:
            if "generator_adv_loss" in criterion:
                adv = adv + criterion["generator_adv_loss"](fake_outs[name])
            if "feat_match_loss" in criterion:
                fm = fm + criterion["feat_match_loss"](fake_fmaps[name],
                                                       real_fmaps[name])
            if "discriminator_adv_loss" in criterion:
                real_l, fake_l = criterion["discriminator_adv_loss"](
                    fake_outs[name], real_outs[name])
                real_total = real_total + real_l
                fake_total = fake_total + fake_l
        adv, fm = _scaled(adv, share), _scaled(fm, share)
        real_total, fake_total = _scaled(real_total, share), _scaled(fake_total, share)
        if "generator_adv_loss" in criterion:
            metrics["adversarial_loss"] = adv
        if "feat_match_loss" in criterion:
            metrics["feature_matching_loss"] = fm
        if "discriminator_adv_loss" in criterion:
            metrics["real_loss"] = real_total
            metrics["fake_loss"] = fake_total
            metrics["discriminator_loss"] = real_total + fake_total
        return dp.metrics(metrics), y_

    return eval_step

"""SAM-BERT train and eval steps (counterpart of ``make_sambert_step`` in
``kantts_tpu/train/steps.py``).

One optimizer; the total is mel(dec) + mel(postnet) + duration + pitch +
energy, plus CTC and the binarization KL with MAS. Steps take a batch of
device tensors with the dataset's keys and return their metrics as detached
device scalars: nothing in a step reads a value back to the host, so the
caller decides when to wait (the trainer does at log time).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

Metrics = Dict[str, torch.Tensor]


def sambert_forward(model: nn.Module, batch: Dict[str, torch.Tensor],
                    ss_prob: Optional[float] = None,
                    generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """The teacher-forced forward on a batch with the dataset's keys."""
    return model(
        batch["input_lings"], batch["input_emotions"], batch["input_speakers"],
        batch["valid_input_lengths"], batch["valid_output_lengths"],
        batch["mel_targets"], duration_targets=batch.get("durations"),
        pitch_targets=batch["pitch_contours"],
        energy_targets=batch["energy_contours"],
        attn_priors=batch.get("attn_priors"), ss_prob=ss_prob,
        generator=generator)


def sambert_losses(model: nn.Module, criterion: Dict[str, Any],
                   batch: Dict[str, torch.Tensor], epoch: int, with_mas: bool,
                   ss_prob: Optional[float] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, Metrics]:
    """Forward and criteria in the model's current mode -> (total, metrics)."""
    res = sambert_forward(model, batch, ss_prob, generator)
    mel_loss_, mel_loss = criterion["MelReconLoss"](
        batch["valid_output_lengths"], batch["mel_targets"],
        res["dec_outputs"], res["postnet_outputs"])
    dur_loss, pitch_loss, energy_loss = criterion["ProsodyReconLoss"](
        res["valid_inter_lengths"], res["duration_targets"],
        res["pitch_targets"], res["energy_targets"],
        res["log_duration_predictions"], res["pitch_predictions"],
        res["energy_predictions"])
    total = mel_loss_ + mel_loss + dur_loss + pitch_loss + energy_loss
    metrics = {
        "mel_loss_": mel_loss_, "mel_loss": mel_loss, "dur_loss": dur_loss,
        "pitch_loss": pitch_loss, "energy_loss": energy_loss,
        "x_band_width": res["x_band_width"].float(),
        "h_band_width": res["h_band_width"].float(),
    }
    if with_mas:
        ctc = criterion["AttentionCTCLoss"](
            res["attn_logprob"], batch["valid_input_lengths"],
            batch["valid_output_lengths"])
        kl = criterion["AttentionBinarizationLoss"](
            epoch, res["attn_hard"], res["attn_soft"])
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
                      generator: Optional[torch.Generator] = None
                      ) -> Callable[[Dict[str, torch.Tensor], int], Metrics]:
    """-> step(batch, epoch) -> metrics. ``clip`` is the global-norm clip of
    ``optimizer_builder`` (None: no clip). The train step runs in ``train()``
    mode: zero the gradients, forward, backward, clip, update, advance the
    schedule. The eval step runs in ``eval()`` mode without gradients.

    Scheduled sampling follows the config keys ``scheduled_sampling_prob``
    (the largest replacement probability; 0 is off) and
    ``scheduled_sampling_ramp_steps`` (the updates over which it ramps up
    linearly from 0); the update count is the scheduler's, so it resumes
    with it. Its draws come from ``generator``."""
    cfg = getattr(model, "config", {}) or {}
    ss_max = float(cfg.get("scheduled_sampling_prob", 0.0))
    ss_ramp = float(cfg.get("scheduled_sampling_ramp_steps", 10_000))

    if not train:
        @torch.no_grad()
        def eval_step(batch, epoch):
            model.eval()
            return sambert_losses(model, criterion, batch, epoch, with_mas)[1]

        return eval_step

    def train_step(batch, epoch):
        model.train()
        ss_prob = None
        if ss_max > 0.0:
            ss_prob = ss_max * min(scheduler.last_epoch / ss_ramp, 1.0)
        optimizer.zero_grad(set_to_none=True)
        total, metrics = sambert_losses(model, criterion, batch, epoch, with_mas,
                                        ss_prob, generator)
        total.backward()
        if clip is not None:
            clip()
        optimizer.step()
        scheduler.step()
        return metrics

    return train_step

"""SAM-BERT training criteria (counterpart of ``kantts_tpu/losses/losses.py``).

Reductions divide by the number of valid elements under the padding masks,
so bucketed padding cannot change a loss value. ``criterion_builder`` keeps
the config contract (per-loss ``enable``/``params``/``weights``); the
vocoder's criteria and the Textsy-BERT and FP losses are not ported yet and
are refused by name when enabled.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from kantts_tpu_torch.utils.mask import get_mask_from_lengths


def _elementwise(loss_type: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if loss_type == "mae":
        return (a - b).abs()
    if loss_type == "mse":
        return (a - b) ** 2
    raise ValueError(f"Unknown loss type: {loss_type}")


class MelReconLoss:
    """Masked L1/L2 on the decoder and postnet mels."""

    def __init__(self, loss_type: str = "mae"):
        self.loss_type = loss_type
        self.weights = 1.0

    def __call__(self, output_lengths, mel_targets, dec_outputs,
                 postnet_outputs=None):
        valid = ~get_mask_from_lengths(output_lengths, mel_targets.shape[1])
        denom = valid.sum() * mel_targets.shape[-1]
        mel_loss_ = (_elementwise(self.loss_type, mel_targets, dec_outputs)
                     * valid[..., None]).sum() / denom
        mel_loss = 0.0
        if postnet_outputs is not None:
            mel_loss = (_elementwise(self.loss_type, mel_targets, postnet_outputs)
                        * valid[..., None]).sum() / denom
        return mel_loss_, mel_loss


class ProsodyReconLoss:
    """Masked log-duration, pitch and energy losses."""

    def __init__(self, loss_type: str = "mae"):
        self.loss_type = loss_type
        self.weights = 1.0

    def __call__(self, input_lengths, duration_targets, pitch_targets,
                 energy_targets, log_duration_predictions, pitch_predictions,
                 energy_predictions):
        valid = ~get_mask_from_lengths(input_lengths, duration_targets.shape[1])
        denom = valid.sum()

        def masked_mean(target, pred):
            return (_elementwise(self.loss_type, target, pred) * valid).sum() / denom

        dur_loss = masked_mean(torch.log(duration_targets.float() + 1.0),
                               log_duration_predictions)
        return (dur_loss, masked_mean(pitch_targets, pitch_predictions),
                masked_mean(energy_targets, energy_predictions))


class AttentionBinarizationLoss:
    """KL between the hard and the soft MAS attention, ramped in linearly over
    ``warmup_epoch`` epochs from ``start_epoch``."""

    def __init__(self, start_epoch: int = 0, warmup_epoch: int = 100):
        self.start_epoch = start_epoch
        self.warmup_epoch = warmup_epoch
        self.weights = 1.0

    def __call__(self, epoch: int, hard_attention, soft_attention,
                 eps: float = 1e-12):
        log_sum = (torch.log(soft_attention.clamp(min=eps)) * hard_attention).sum()
        kl = -log_sum / hard_attention.sum()
        warmup = (min(max((epoch - self.start_epoch) / self.warmup_epoch, 0.0), 1.0)
                  * float(epoch >= self.start_epoch))
        return kl * warmup


class AttentionCTCLoss:
    """CTC of the mel frames against the text positions 1..in_len over the
    attention log-probabilities, blank = class 0, normalised by each item's
    text length, then averaged over the batch. Text classes past an item's
    length are set to -1e9 before the log-softmax. ``F.ctc_loss`` computes
    it; ``zero_infinity`` zeroes an item that cannot align (fewer frames than
    text positions), as the KAN-TTS loss does."""

    def __init__(self, blank_logprob: float = -1.0):
        self.blank_logprob = blank_logprob
        self.weights = 1.0

    def __call__(self, attn_logprob, in_lens, out_lens):
        """attn_logprob (B, 1, T_mel, T_text); in_lens, out_lens (B,)."""
        B, _, T_mel, T_text = attn_logprob.shape
        dev = attn_logprob.device
        logits = F.pad(attn_logprob[:, 0], (1, 0), value=self.blank_logprob)
        cls = torch.arange(T_text + 1, device=dev)
        logits = logits.masked_fill(cls[None, None, :] > in_lens[:, None, None], -1e9)
        logp = torch.log_softmax(logits, dim=-1)
        targets = torch.arange(1, T_text + 1, device=dev).repeat(B, 1)
        per_seq = F.ctc_loss(logp.transpose(0, 1), targets, out_lens.long(),
                             in_lens.long(), blank=0, reduction="none",
                             zero_infinity=True)
        return (per_seq / in_lens.float()).mean()


loss_dict = {
    "MelReconLoss": MelReconLoss,
    "ProsodyReconLoss": ProsodyReconLoss,
    "AttentionBinarizationLoss": AttentionBinarizationLoss,
    "AttentionCTCLoss": AttentionCTCLoss,
}

# criteria of the JAX package that the port does not have yet
NOT_PORTED = ("generator_adv_loss", "discriminator_adv_loss", "stft_loss",
              "mel_loss", "subband_stft_loss", "feat_match_loss", "SeqCELoss",
              "FpCELoss")


def criterion_builder(config: Dict[str, Any]) -> Dict[str, Any]:
    """The enabled criteria of ``config["Loss"]``, each carrying its
    ``weights``. An enabled criterion that is not ported yet raises."""
    criterion = {}
    for key, value in config["Loss"].items():
        if key not in loss_dict and key not in NOT_PORTED:
            raise NotImplementedError(f"{key} is not implemented")
        if not value.get("enable", False):
            continue
        if key in NOT_PORTED:
            raise NotImplementedError(f"{key} is not ported to kantts_tpu_torch yet")
        crit = loss_dict[key](**value.get("params", {}))
        crit.weights = value.get("weights", 1.0)
        criterion[key] = crit
    return criterion

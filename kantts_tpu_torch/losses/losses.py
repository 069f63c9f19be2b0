"""Training criteria of SAM-BERT and HiFi-GAN (counterpart of
``kantts_tpu/losses/losses.py``).

SAM-BERT's reductions divide by the number of valid elements under the
padding masks, so bucketed padding cannot change a loss value.
``criterion_builder`` keeps the config contract (per-loss
``enable``/``params``/``weights``); the sub-band STFT loss is a
``MultiResolutionSTFTLoss`` on PQMF sub-bands (``train/steps.py``).
``FpCELoss`` and ``SeqCELoss`` are the filled-pause and Textsy-BERT
criteria.

Data parallelism: a criterion given ``reduce`` (``parallel.mesh.global_sum``
or any function that sums 0-d tensors over the shards of a global batch)
returns this shard's share of the global-batch loss, its local sum over the
global count, so that the shares, and the gradients of the shares, summed
over the ranks are the loss and the gradient of one process holding the
global batch. The spectral convergence of ``STFTLoss``, a ratio of norms,
is taken from the two global squared norms instead. The GAN criteria are
plain means over crops of one length, and the GAN step weights them by the
shard's share of the global batch (``train/steps.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from kantts_tpu_torch.dsp.mel import LossMelSpectrogram
from kantts_tpu_torch.dsp.stft import hann_window, stft_magnitude
from kantts_tpu_torch.utils.mask import get_mask_from_lengths

Scores = Union[torch.Tensor, Sequence[torch.Tensor]]
Reduce = Callable[..., Tuple[torch.Tensor, ...]]


def _global(reduce: Optional[Reduce], *counts: torch.Tensor
            ) -> Tuple[torch.Tensor, ...]:
    """The normalisers of a reduction: this shard's, or with ``reduce`` the
    sums over every shard, in one call."""
    return counts if reduce is None else tuple(reduce(*counts))


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
                 postnet_outputs=None, reduce: Optional[Reduce] = None):
        valid = ~get_mask_from_lengths(output_lengths, mel_targets.shape[1])
        denom, = _global(reduce, valid.sum() * mel_targets.shape[-1])
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
                 energy_predictions, reduce: Optional[Reduce] = None):
        valid = ~get_mask_from_lengths(input_lengths, duration_targets.shape[1])
        denom, = _global(reduce, valid.sum())

        def masked_mean(target, pred):
            return (_elementwise(self.loss_type, target, pred) * valid).sum() / denom

        dur_loss = masked_mean(torch.log(duration_targets.float() + 1.0),
                               log_duration_predictions)
        return (dur_loss, masked_mean(pitch_targets, pitch_predictions),
                masked_mean(energy_targets, energy_predictions))


class FpCELoss:
    """Class-weighted cross-entropy over the 4 FP classes, masked by the
    input lengths. ``fp_pd`` (B, T, 4) holds probabilities: KAN-TTS feeds
    its FP predictor's softmax output to a cross-entropy that takes
    logits, so the loss is -w * log_softmax(p), a double softmax, not
    -w * log(p). Kept as is."""

    def __init__(self, loss_type: str = "ce", weight: Sequence[float] = (1, 4, 4, 8)):
        self.weight = torch.tensor(weight, dtype=torch.float32)
        self.weights = 1.0

    def __call__(self, input_lengths, fp_pd, fp_label,
                 reduce: Optional[Reduce] = None):
        valid = ~get_mask_from_lengths(input_lengths, fp_label.shape[1])
        logp = torch.log_softmax(fp_pd.float(), dim=-1)
        label = fp_label.long()
        if self.weight.device != logp.device:  # once: no copy in every step
            self.weight = self.weight.to(logp.device)
        ce = -logp.gather(-1, label[..., None])[..., 0] * self.weight[label]
        denom, = _global(reduce, valid.sum())
        return (ce * valid).sum() / denom


class SeqCELoss:
    """Masked cross-entropy of Textsy-BERT's logits against the sy targets,
    and the error rate of their argmax, both over the masked positions."""

    def __init__(self, loss_type: str = "ce"):
        self.weights = 1.0

    def __call__(self, logits, targets, masks, reduce: Optional[Reduce] = None):
        logp = torch.log_softmax(logits.float(), dim=-1)
        ce = -logp.gather(-1, targets.long()[..., None])[..., 0]
        masks = masks.float()
        denom, = _global(reduce, masks.sum())
        loss = (ce * masks).sum() / denom
        err = ((logits.argmax(-1) != targets).float() * masks).sum() / denom
        return loss, err


class AttentionBinarizationLoss:
    """KL between the hard and the soft MAS attention, ramped in linearly over
    ``warmup_epoch`` epochs from ``start_epoch``."""

    def __init__(self, start_epoch: int = 0, warmup_epoch: int = 100):
        self.start_epoch = start_epoch
        self.warmup_epoch = warmup_epoch
        self.weights = 1.0

    def __call__(self, epoch: int, hard_attention, soft_attention,
                 eps: float = 1e-12, reduce: Optional[Reduce] = None):
        log_sum = (torch.log(soft_attention.clamp(min=eps)) * hard_attention).sum()
        count, = _global(reduce, hard_attention.sum())
        kl = -log_sum / count
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

    def __call__(self, attn_logprob, in_lens, out_lens,
                 reduce: Optional[Reduce] = None):
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
        items, = _global(reduce, in_lens.new_full((), B))
        return (per_seq / in_lens.float()).sum() / items


class GeneratorAdversarialLoss:
    """mean((D(G(x)) - 1)^2) ("mse") or -mean(D(G(x))) ("hinge"), summed
    over a list of discriminator outputs and averaged over them when
    ``average_by_discriminators``."""

    def __init__(self, average_by_discriminators: bool = True,
                 loss_type: str = "mse"):
        if loss_type not in ("mse", "hinge"):
            raise ValueError(f"Unknown loss type: {loss_type}")
        self.average_by_discriminators = average_by_discriminators
        self.loss_type = loss_type
        self.weights = 1.0

    def _one(self, x):
        if self.loss_type == "mse":
            return ((x - 1.0) ** 2).mean()
        return -x.mean()

    def __call__(self, outputs: Scores):
        if isinstance(outputs, (tuple, list)):
            adv = sum(self._one(o) for o in outputs)
            if self.average_by_discriminators:
                adv = adv / len(outputs)
            return adv
        return self._one(outputs)


class DiscriminatorAdversarialLoss:
    """-> (real loss, fake loss): mean((D(y) - 1)^2) and mean(D(G(x))^2)
    ("mse"), or the hinge pair; over a list of outputs, summed and averaged
    over them when ``average_by_discriminators``. An output that is itself a
    list counts by its last entry."""

    def __init__(self, average_by_discriminators: bool = True,
                 loss_type: str = "mse"):
        if loss_type not in ("mse", "hinge"):
            raise ValueError(f"Unknown loss type: {loss_type}")
        self.average_by_discriminators = average_by_discriminators
        self.loss_type = loss_type
        self.weights = 1.0

    def _real(self, x):
        if self.loss_type == "mse":
            return ((x - 1.0) ** 2).mean()
        return -torch.clamp(x - 1.0, max=0.0).mean()

    def _fake(self, x):
        if self.loss_type == "mse":
            return (x ** 2).mean()
        return -torch.clamp(-x - 1.0, max=0.0).mean()

    def __call__(self, outputs_hat: Scores, outputs: Scores):
        if isinstance(outputs, (tuple, list)):
            real = fake = 0.0
            for o_hat, o in zip(outputs_hat, outputs):
                if isinstance(o_hat, (tuple, list)):
                    o_hat, o = o_hat[-1], o[-1]
                real = real + self._real(o)
                fake = fake + self._fake(o_hat)
            if self.average_by_discriminators:
                real = real / len(outputs)
                fake = fake / len(outputs)
            return real, fake
        return self._real(outputs), self._fake(outputs_hat)


class FeatureMatchLoss:
    """L1 between the feature maps of the fake and of the real waveform, the
    real ones detached: a mean per map, summed over maps (averaged over them
    with ``average_by_layers``) and over discriminators (averaged with
    ``average_by_discriminators``)."""

    def __init__(self, average_by_layers: bool = True,
                 average_by_discriminators: bool = True):
        self.average_by_layers = average_by_layers
        self.average_by_discriminators = average_by_discriminators
        self.weights = 1.0

    def __call__(self, feats_hat: List[List[torch.Tensor]],
                 feats: List[List[torch.Tensor]]):
        total = 0.0
        for fmap_hat, fmap in zip(feats_hat, feats):
            fm = 0.0
            for f_hat, f in zip(fmap_hat, fmap):
                fm = fm + (f_hat - f.detach()).abs().mean()
            if self.average_by_layers:
                fm = fm / len(fmap)
            total = total + fm
        if self.average_by_discriminators:
            total = total / len(feats)
        return total


class MelSpectrogramLoss:
    """L1 between the loss-flavour mels (``dsp.mel.LossMelSpectrogram``) of
    the fake and the real waveform."""

    def __init__(self, fs=22050, fft_size=1024, hop_size=256, win_length=None,
                 window="hann", num_mels=80, fmin=80, fmax=7600, center=True,
                 normalized=False, onesided=True, eps=1e-10, log_base=10.0):
        del normalized, onesided
        self.mel = LossMelSpectrogram(
            fs=fs, fft_size=fft_size, hop_size=hop_size, win_length=win_length,
            window=window, num_mels=num_mels, fmin=fmin, fmax=fmax,
            center=center, eps=eps, log_base=log_base)
        self.weights = 1.0

    def __call__(self, y_hat, y):
        return (self.mel(y_hat) - self.mel(y)).abs().mean()


class STFTLoss:
    """-> (spectral convergence, log-magnitude L1) at one resolution, on
    reflect-padded magnitudes clamped at power 1e-7.

    The spectral convergence ``||y - x|| / ||y||`` is taken over the whole
    (global) batch. A shard holds only its part of each squared norm, so
    with ``reduce`` it takes the global squared norms, with the other
    shards' parts held constant in the gradient, and returns its share of
    the value in proportion to its part of ``||y - x||^2``."""

    def __init__(self, fft_size=1024, shift_size=120, win_length=600,
                 window="hann_window"):
        if window != "hann_window":
            raise ValueError(f"{window} window is not implemented")
        self.fft_size = fft_size
        self.shift_size = shift_size
        self.win_length = win_length
        self.window = torch.from_numpy(hann_window(win_length))
        self._on: dict = {}  # device -> the window there

    def sums(self, x, y) -> Tuple[torch.Tensor, ...]:
        """-> the shard's ||y - x||^2, ||y||^2, sum |log y - log x| and its
        count of magnitudes, the sums that the two terms are made of."""
        if x.device not in self._on:  # once: no copy from the host in a step
            self._on[x.device] = self.window.to(x.device)
        window = self._on[x.device]
        x_mag = stft_magnitude(x, self.fft_size, self.shift_size,
                               self.win_length, window)
        y_mag = stft_magnitude(y, self.fft_size, self.shift_size,
                               self.win_length, window)
        return (((y_mag - x_mag) ** 2).sum(), (y_mag ** 2).sum(),
                (torch.log(y_mag) - torch.log(x_mag)).abs().sum(),
                y_mag.new_full((), y_mag.numel(), dtype=torch.int64))

    @staticmethod
    def terms(sums, global_sums) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sc, mag) of a shard from its ``sums`` and their sums over every
        shard (the same tensors when there is one)."""
        d2, y2, log_l1, _ = sums
        g_d2, g_y2, _, g_n = global_sums
        sc = (torch.sqrt(d2 + (g_d2 - d2.detach()))
              / torch.sqrt(y2 + (g_y2 - y2.detach())))
        share = d2.detach() / g_d2.clamp(min=torch.finfo(g_d2.dtype).tiny)
        return sc - (sc * (1.0 - share)).detach(), log_l1 / g_n

    def __call__(self, x, y, reduce: Optional[Reduce] = None):
        sums = self.sums(x, y)
        return self.terms(sums, _global(reduce, *(s.detach() for s in sums)))


class MultiResolutionSTFTLoss:
    """``STFTLoss`` averaged over resolutions; (B, 1, T) inputs are
    flattened to (B, T). With ``reduce``, the sums of every resolution go
    through one call."""

    def __init__(self, fft_sizes=(1024, 2048, 512), hop_sizes=(120, 240, 50),
                 win_lengths=(600, 1200, 240), window="hann_window"):
        if not len(fft_sizes) == len(hop_sizes) == len(win_lengths):
            raise ValueError("one hop and window length per FFT size")
        self.stft_losses = [STFTLoss(f, s, w, window)
                            for f, s, w in zip(fft_sizes, hop_sizes, win_lengths)]
        self.weights = 1.0

    def __call__(self, x, y, reduce: Optional[Reduce] = None):
        if x.ndim == 3:
            x = x.reshape(-1, x.shape[-1])
            y = y.reshape(-1, y.shape[-1])
        sums = [f.sums(x, y) for f in self.stft_losses]
        flat = _global(reduce, *(s.detach() for res in sums for s in res))
        sc_total = mag_total = 0.0
        for i, res in enumerate(sums):
            sc, mag = STFTLoss.terms(res, flat[4 * i: 4 * i + 4])
            sc_total = sc_total + sc
            mag_total = mag_total + mag
        n = len(self.stft_losses)
        return sc_total / n, mag_total / n


loss_dict = {
    "generator_adv_loss": GeneratorAdversarialLoss,
    "discriminator_adv_loss": DiscriminatorAdversarialLoss,
    "stft_loss": MultiResolutionSTFTLoss,
    "mel_loss": MelSpectrogramLoss,
    "subband_stft_loss": MultiResolutionSTFTLoss,
    "feat_match_loss": FeatureMatchLoss,
    "MelReconLoss": MelReconLoss,
    "ProsodyReconLoss": ProsodyReconLoss,
    "AttentionBinarizationLoss": AttentionBinarizationLoss,
    "AttentionCTCLoss": AttentionCTCLoss,
    "FpCELoss": FpCELoss,
    "SeqCELoss": SeqCELoss,
}


def criterion_builder(config: Dict[str, Any]) -> Dict[str, Any]:
    """The enabled criteria of ``config["Loss"]``, each carrying its
    ``weights``. An unknown criterion raises."""
    criterion = {}
    for key, value in config["Loss"].items():
        if key not in loss_dict:
            raise NotImplementedError(f"{key} is not implemented")
        if not value.get("enable", False):
            continue
        crit = loss_dict[key](**value.get("params", {}))
        crit.weights = value.get("weights", 1.0)
        criterion[key] = crit
    return criterion

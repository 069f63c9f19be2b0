"""KanTtsSAMBERT acoustic model (counterpart of
``kantts_tpu/models/sambert/sambert.py``).

The teacher-forced ``forward`` is the training forward: the MAS branch
(ConvAttention, then the hard alignment from ``mas_align``, kernel K1 on the
card) and scheduled sampling; FP, SE and byte inputs are not ported yet.
``sambert_infer`` is the acoustic inference: the autoregressive duration
loop and the PNCA decode are Python loops over steps.

Shape contract, as in the JAX package: the mel length is a multiple of r,
and in the teacher-forced pass durations sum to the padded mel length.
Submodule names follow the KAN-TTS state-dict layout.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from kantts_tpu_torch.models.sambert.adaptors import (
    VarFsmnRnnNARPredictor,
    VarRnnARPredictor,
    length_regulate,
)
from kantts_tpu_torch.models.sambert.alignment import mas_align
from kantts_tpu_torch.models.sambert.attention import ConvAttention
from kantts_tpu_torch.models.sambert.common import (
    FFTBlock,
    conv1d_same,
    masked_zero,
    torch_linear,
)
from kantts_tpu_torch.models.sambert.fsmn import FsmnEncoderV2
from kantts_tpu_torch.models.sambert.lstm import LSTM
from kantts_tpu_torch.models.sambert.pnca import MelPNCADecoder, pnca_decoder_infer
from kantts_tpu_torch.models.sambert.positions import (
    add_sinusoidal_position,
    duration_position_encoding,
)
from kantts_tpu_torch.utils.mask import get_mask_from_lengths

UNSUPPORTED = ("FP", "SE", "NSF", "using_byte")


class SelfAttentionEncoder(nn.Module):
    """N FFT blocks with sinusoidal positions and a final LayerNorm."""

    def __init__(self, d_in: int, n_layer: int, d_model: int, n_head: int,
                 d_head: int, d_inner: int, dropout: float, dropout_att: float,
                 dropout_relu: float, max_len: int):
        super().__init__()
        self.d_model, self.max_len = d_model, max_len
        self.fft = nn.ModuleList([
            FFTBlock(d_in if i == 0 else d_model, d_model, n_head, d_head,
                     d_inner, (3, 1), dropout, dropout_att, dropout_relu)
            for i in range(n_layer)])
        self.ln = nn.LayerNorm(d_model, eps=1e-6)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, mask=None):
        h = add_sinusoidal_position(x * math.sqrt(self.d_model), self.max_len)
        h = self.dropout(h)
        attns = []
        for block in self.fft:
            h, attn = block(h, mask)
            attns.append(attn)
        return self.ln(h), attns


class TextFftEncoder(nn.Module):
    """Four summed linguistic embeddings -> encoder -> projection."""

    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        d_emb, d_model = cfg["embedding_dim"], cfg["encoder_num_units"]
        self.d_model = d_model
        self.sy_emb = nn.Embedding(cfg["sy"], d_emb)
        self.tone_emb = nn.Embedding(cfg["tone"], d_emb)
        self.syllable_flag_emb = nn.Embedding(cfg["syllable_flag"], d_emb)
        self.ws_emb = nn.Embedding(cfg["word_segment"], d_emb)
        self.ling_enc = SelfAttentionEncoder(
            d_emb, cfg["encoder_num_layers"], d_model,
            cfg["encoder_num_heads"], d_model // cfg["encoder_num_heads"],
            cfg["encoder_ffn_inner_dim"], cfg["encoder_dropout"],
            cfg["encoder_attention_dropout"], cfg["encoder_relu_dropout"],
            cfg["max_len"])
        self.ling_proj = torch_linear(d_model, cfg["encoder_projection_units"],
                                      bias=False)

    def forward(self, inputs_ling, masks=None):
        """-> (text_hid, attns, MAS keys). The reference scales its encoder
        input in place, which aliases the embedding that MAS later reads: its
        MAS keys are the embeddings times sqrt(d_model). Kept as is."""
        ling_embedding = (self.sy_emb(inputs_ling[:, :, 0])
                          + self.tone_emb(inputs_ling[:, :, 1])
                          + self.syllable_flag_emb(inputs_ling[:, :, 2])
                          + self.ws_emb(inputs_ling[:, :, 3]))
        enc_output, attns = self.ling_enc(ling_embedding, masks)
        return (self.ling_proj(enc_output), attns,
                ling_embedding * math.sqrt(self.d_model))


class PostNet(nn.Module):
    """FSMN (look-ahead shift) -> LSTM -> FC mel residual."""

    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        self.fsmn = FsmnEncoderV2(
            cfg["num_mels"], cfg["postnet_filter_size"],
            cfg["postnet_fsmn_num_layers"], cfg["postnet_num_memory_units"],
            cfg["postnet_ffn_inner_dim"], cfg["postnet_dropout"],
            cfg["postnet_shift"])
        self.lstm = LSTM(cfg["postnet_num_memory_units"], cfg["postnet_lstm_units"])
        self.fc = torch_linear(cfg["postnet_lstm_units"], cfg["num_mels"])

    def forward(self, x, mask=None):
        h, _ = self.lstm(self.fsmn(x, mask))
        return self.fc(h)


class VarianceAdaptor(nn.Module):
    """Container for the predictors and prosody embeddings (KAN-TTS names)."""

    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        proj = cfg["encoder_projection_units"]
        var_in = proj + cfg["emotion_units"] + cfg["speaker_units"]

        def nar():
            return VarFsmnRnnNARPredictor(
                var_in, cfg["predictor_filter_size"],
                cfg["predictor_fsmn_num_layers"],
                cfg["predictor_num_memory_units"],
                cfg["predictor_ffn_inner_dim"], cfg["predictor_dropout"],
                cfg["predictor_shift"], cfg["predictor_lstm_units"])

        self.pitch_predictor = nar()
        self.energy_predictor = nar()
        self.duration_predictor = VarRnnARPredictor(
            var_in, cfg["dur_pred_prenet_units"], cfg["dur_pred_lstm_units"],
            float(cfg.get("dur_pred_bias_init", 0.0)))
        self.pitch_emb = conv1d_same(1, proj, 9)
        self.energy_emb = conv1d_same(1, proj, 9)


def average_frame_feat(feat: torch.Tensor, durs: torch.Tensor) -> torch.Tensor:
    """Mean of the nonzero frame values within each token's duration span.
    feat (B, T_mel); durs (B, T_in) -> (B, T_in)."""
    T_mel = feat.shape[1]
    ends = torch.cumsum(durs.long(), dim=1).clamp(0, T_mel)
    starts = F.pad(ends[:, :-1], (1, 0))
    nz_cums = F.pad(torch.cumsum((feat != 0.0).float(), dim=1), (1, 0))
    f_cums = F.pad(torch.cumsum(feat, dim=1), (1, 0))
    sums = f_cums.gather(1, ends) - f_cums.gather(1, starts)
    nelems = nz_cums.gather(1, ends) - nz_cums.gather(1, starts)
    return torch.where(nelems == 0.0, 0.0,
                       sums / torch.where(nelems == 0, 1.0, nelems))


class KanTtsSAMBERT(nn.Module):
    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        cfg = dict(config)
        on = [k for k in UNSUPPORTED if cfg.get(k, False)]
        if on:
            raise NotImplementedError(f"not ported yet: {', '.join(on)}")
        self.config = cfg
        self.r, self.d_mel = cfg["outputs_per_step"], cfg["num_mels"]
        self.text_encoder = TextFftEncoder(cfg)
        self.spk_tokenizer = nn.Embedding(cfg["speaker"], cfg["speaker_units"])
        self.emo_tokenizer = nn.Embedding(cfg["emotion"], cfg["emotion_units"])
        self.variance_adaptor = VarianceAdaptor(cfg)
        d_mem = (cfg["encoder_projection_units"] * self.r + cfg["emotion_units"]
                 + cfg["speaker_units"])
        self.mel_decoder = MelPNCADecoder(
            cfg["decoder_prenet_units"], cfg["decoder_num_layers"],
            cfg["decoder_num_heads"], cfg["decoder_num_units"],
            cfg["decoder_ffn_inner_dim"], d_mem, self.d_mel, self.r,
            cfg["decoder_dropout"], cfg["decoder_attention_dropout"],
            cfg["decoder_relu_dropout"])
        self.mel_postnet = PostNet(cfg)
        self.mas_enable = cfg.get("MAS", False)
        if self.mas_enable:
            self.align_attention = ConvAttention(
                cfg["num_mels"], cfg["embedding_dim"], cfg["num_mels"])

    # ----------------------------------------------------------- sub-passes

    def encode(self, inputs_ling, input_masks):
        return self.text_encoder(inputs_ling, input_masks)

    def tokenize(self, inputs_emotion, inputs_speaker):
        return self.emo_tokenizer(inputs_emotion), self.spk_tokenizer(inputs_speaker)

    def variance_pre(self, text_hid, emo_hid, spk_hid, masks,
                     pitch_targets=None, energy_targets=None):
        """Pitch/energy prediction and the duration condition."""
        va = self.variance_adaptor
        var_inputs = torch.cat([text_hid, spk_hid, emo_hid], dim=-1)
        pitch_pred = va.pitch_predictor(var_inputs, masks)
        energy_pred = va.energy_predictor(var_inputs, masks)
        pitch_src = pitch_targets if pitch_targets is not None else pitch_pred
        energy_src = energy_targets if energy_targets is not None else energy_pred
        text_aug = (text_hid + va.pitch_emb(pitch_src[..., None])
                    + va.energy_emb(energy_src[..., None]))
        dur_cond = torch.cat([text_aug, spk_hid, emo_hid], dim=-1)
        return pitch_pred, energy_pred, text_aug, dur_cond

    def duration_teacher(self, duration_targets, dur_cond, masks):
        """Teacher-forced duration pass over log(previous target + 1)."""
        shifted = F.pad(duration_targets[:, :-1].float(), (1, 0))
        log_dur, _ = self.variance_adaptor.duration_predictor(
            torch.log(shifted + 1.0)[..., None], dur_cond, masks=masks)
        return log_dur

    def build_memory(self, LR_text, LR_emo, LR_spk):
        """Regroup frames by r and concatenate the decoder memory."""
        B, T_mel, _ = LR_text.shape
        r = self.r
        lfr_text = LR_text.reshape(B, T_mel // r, r * LR_text.shape[-1])
        lfr_emo = LR_emo.reshape(B, T_mel // r, -1)[:, :, :LR_emo.shape[-1]]
        lfr_spk = LR_spk.reshape(B, T_mel // r, -1)[:, :, :LR_spk.shape[-1]]
        return torch.cat([lfr_text, lfr_spk, lfr_emo], dim=-1)

    def decode_postnet(self, dec_outputs, output_masks):
        """Undo the frame grouping, then add the postnet residual."""
        dec = masked_zero(dec_outputs.reshape(dec_outputs.shape[0], -1, self.d_mel),
                          output_masks)
        post = self.mel_postnet(dec, output_masks) + dec
        return dec, masked_zero(post, output_masks)

    def _regulate(self, text_aug, emo_hid, spk_hid, durations, T_mel,
                  output_masks=None):
        LR_text, LR_length = length_regulate(text_aug, durations, T_mel,
                                             output_masks)
        LR_pos = duration_position_encoding(durations, text_aug.shape[-1],
                                            T_mel, output_masks)
        LR_emo, _ = length_regulate(emo_hid, durations, T_mel, output_masks)
        LR_spk, _ = length_regulate(spk_hid, durations, T_mel, output_masks)
        return LR_text + LR_pos, LR_emo, LR_spk, LR_length

    # ------------------------------------------------------------- training

    def forward(self, inputs_ling, inputs_emotion, inputs_speaker,
                input_lengths, output_lengths, mel_targets,
                duration_targets=None, pitch_targets=None, energy_targets=None,
                attn_priors=None, ss_prob: Optional[float] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Teacher-forced forward, as the training step runs it (no loss).
        Dropout follows the module's ``train()``/``eval()`` mode.

        ``ss_prob`` turns on scheduled sampling: a first decoder pass without
        gradient makes the model's own coarse frames, and the previous-frame
        input of the second pass takes them in place of the targets on LFR
        groups drawn Bernoulli(ss_prob) from ``generator`` (on the model's
        device). Only the second pass takes gradient."""
        B, T_in = inputs_ling.shape[:2]
        T_mel = mel_targets.shape[1]
        r = self.r

        input_masks = get_mask_from_lengths(input_lengths, T_in)
        text_hid, enc_attns, ling_emb = self.encode(inputs_ling, input_masks)
        res: Dict[str, Any] = {"enc_slf_attn_lst": enc_attns}

        if self.mas_enable:
            attn_soft, attn_logprob = self.align_attention(
                mel_targets, ling_emb, input_masks, attn_priors)
            attn_hard = mas_align(attn_soft, input_lengths, output_lengths)
            duration_targets = attn_hard.sum(dim=2)[:, 0, :]
            pitch_targets = average_frame_feat(pitch_targets, duration_targets)
            energy_targets = average_frame_feat(energy_targets, duration_targets)
            # the mel padding goes on the EOS slot so durations sum to T_mel;
            # an item with no EOS slot (input_length == T_in) gets none
            pad_amount = (T_mel - output_lengths).to(duration_targets.dtype)
            duration_targets = F.pad(duration_targets, (0, 1)).scatter(
                1, input_lengths.long()[:, None], pad_amount[:, None])[:, :T_in]
            res.update(attn_soft=attn_soft, attn_hard=attn_hard,
                       attn_logprob=attn_logprob)

        emo_hid, spk_hid = self.tokenize(inputs_emotion, inputs_speaker)
        output_masks = get_mask_from_lengths(output_lengths, T_mel)
        pitch_pred, energy_pred, text_aug, dur_cond = self.variance_pre(
            text_hid, emo_hid, spk_hid, input_masks, pitch_targets,
            energy_targets)
        log_dur_pred = self.duration_teacher(duration_targets, dur_cond,
                                             input_masks)
        LR_text, LR_emo, LR_spk, LR_length = self._regulate(
            text_aug, emo_hid, spk_hid, duration_targets, T_mel, output_masks)
        memory = self.build_memory(LR_text, LR_emo, LR_spk)

        masked_dur = duration_targets.float().masked_fill(input_masks, 0.0)
        band_width = torch.floor(masked_dur.max() / r + 0.5).to(torch.int32)
        lfr_masks = get_mask_from_lengths((output_lengths + r - 1) // r, T_mel // r)
        dec_in = mel_targets
        if ss_prob is not None:
            with torch.no_grad():
                dec1, _, _ = self.mel_decoder(memory, band_width, band_width,
                                              mel_targets, lfr_masks)
            own = dec1.reshape(B, T_mel, self.d_mel).to(mel_targets.dtype)
            take = torch.rand((B, T_mel // r), generator=generator,
                              device=mel_targets.device) < ss_prob
            take = take.repeat_interleave(r, dim=1)[..., None]
            dec_in = torch.where(take, own, mel_targets)
        dec_outputs, pnca_x_attn, pnca_h_attn = self.mel_decoder(
            memory, band_width, band_width, dec_in, lfr_masks)
        dec, post = self.decode_postnet(dec_outputs, output_masks)

        res.update(
            x_band_width=band_width, h_band_width=band_width,
            pnca_x_attn_lst=pnca_x_attn, pnca_h_attn_lst=pnca_h_attn,
            dec_outputs=dec, postnet_outputs=post, LR_length_rounded=LR_length,
            log_duration_predictions=log_dur_pred,
            pitch_predictions=pitch_pred, energy_predictions=energy_pred,
            duration_targets=duration_targets, pitch_targets=pitch_targets,
            energy_targets=energy_targets, valid_inter_lengths=input_lengths,
            LR_text_outputs=LR_text, LR_emo_outputs=LR_emo,
            LR_spk_outputs=LR_spk)
        return res


@torch.no_grad()
def sambert_infer(model: KanTtsSAMBERT, inputs_ling, inputs_emotion,
                  inputs_speaker, input_lengths, max_output_len: int,
                  duration_override: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """Acoustic inference: symbols -> mel at a frame budget of
    ``max_output_len`` (a multiple of r); the valid length is
    ``LR_length_rounded``. ``duration_override`` (B, T_in) frames per phone
    replaces the decoded durations; the duration head still runs and its
    predictions are still returned."""
    r = model.r
    if max_output_len % r:
        raise ValueError(f"max_output_len {max_output_len} is not a multiple of r={r}")
    B, T_in = inputs_ling.shape[:2]
    input_masks = get_mask_from_lengths(input_lengths, T_in)
    text_hid, _, _ = model.encode(inputs_ling, input_masks)
    emo_hid, spk_hid = model.tokenize(inputs_emotion, inputs_speaker)
    pitch_pred, energy_pred, text_aug, dur_cond = model.variance_pre(
        text_hid, emo_hid, spk_hid, input_masks)

    # autoregressive duration decode, one phone per step
    predictor = model.variance_adaptor.duration_predictor
    prev = text_hid.new_zeros((B, 1, 1))
    state = None
    log_dur = text_hid.new_empty((B, T_in))
    for t in range(T_in):
        out, state = predictor(prev, dur_cond[:, t:t + 1], state)
        log_dur[:, t] = out[:, 0]
        prev = out[..., None]
    log_dur = log_dur.masked_fill(input_masks, 0.0)
    durations = (torch.exp(log_dur) - 1.0).masked_fill(input_masks, 0.0)
    if duration_override is not None:
        durations = duration_override.to(durations).masked_fill(input_masks, 0.0)

    LR_text, LR_emo, LR_spk, LR_length = model._regulate(
        text_aug, emo_hid, spk_hid, durations, max_output_len)
    LR_length = LR_length.clamp(max=max_output_len)
    memory = model.build_memory(LR_text, LR_emo, LR_spk)

    # band widths per item, so that batch composition cannot change an
    # utterance's mask: a scalar at B=1, (B, 1, 1, 1) otherwise
    if B == 1:
        band_width = torch.floor(durations.max() / r + 0.5).to(torch.int32)
        bw_step = band_width
    else:
        band_width = torch.floor(durations.max(dim=1).values / r + 0.5).to(torch.int32)
        bw_step = band_width.reshape(B, 1, 1, 1)

    output_masks = get_mask_from_lengths(LR_length, max_output_len)
    mem_pad_mask = get_mask_from_lengths((LR_length + r - 1) // r,
                                         max_output_len // r)
    dec_outputs = pnca_decoder_infer(model.mel_decoder, memory, bw_step,
                                     bw_step, mem_pad_mask)
    dec, post = model.decode_postnet(dec_outputs, output_masks)
    return {
        "dec_outputs": dec,
        "postnet_outputs": post,
        "LR_length_rounded": LR_length,
        "log_duration_predictions": log_dur,
        "duration_predictions": durations,
        "pitch_predictions": pitch_pred,
        "energy_predictions": energy_pred,
        "x_band_width": band_width,
        "h_band_width": band_width,
    }

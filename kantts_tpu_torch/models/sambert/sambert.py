"""KanTtsSAMBERT acoustic model (counterpart of
``kantts_tpu/models/sambert/sambert.py``).

The teacher-forced ``forward`` is the training forward: the MAS branch
(ConvAttention, then the hard alignment from ``mas_align``, kernel K1 on the
card), scheduled sampling, and filled pauses (``FP``): the FP predictor's
four-class head over the encoder states, and with a host-built insertion
plan the encoded filler syllables spliced into the text hiddens
(``fp.py``), after which every per-token length is the spliced one
(``valid_inter_lengths``). A byte voice
(``using_byte``) embeds one byte id per token in place of the four
linguistic tracks; an SE voice (``SE``) takes a float speaker embedding
(B, T_in, speaker_units) as its speaker input, used as it is.
``compute_dtype: bfloat16`` runs the encoder's FFT blocks and the PNCA
decoder in bf16 (``common.py``); the LSTMs, FSMN predictors, postnet and
``ConvAttention`` stay float32, so MAS sees float32 maps.
An NSF model (``NSF: true``) is the same model at ``num_mels`` 82: its
last two output channels are the normalised f0 and uv, which inference
denormalises on the host (``bin/infer_sambert.py::denorm_f0``).
``sambert_infer`` is the acoustic inference: the autoregressive duration
loop and the PNCA decode are Python loops over steps. It runs as stage
functions (``infer_encode``, ``infer_duration_step``, ``infer_regulate``,
the decoder's ``step``, ``infer_postnet``), which the serving artifact
exports one by one (``infer/exported.py``); ``sambert_infer_fp``
predicts the filled pauses first and splices them in. ``KanTtsTextsyBERT``
is the masked-LM pretrainer of the text encoder (Textsy-BERT).

Shape contract, as in the JAX package: the mel length is a multiple of r,
and in the teacher-forced pass durations sum to the padded mel length.
Submodule names follow the KAN-TTS state-dict layout.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

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
    compute_dtype,
    conv1d_same,
    masked_zero,
    torch_linear,
)
from kantts_tpu_torch.models.sambert.fp import (
    apply_fp_insertion,
    build_fp_insertion_plan,
    fp_classes_from_predictions,
)
from kantts_tpu_torch.models.sambert.fsmn import FsmnEncoderV2
from kantts_tpu_torch.models.sambert.lstm import LSTM
from kantts_tpu_torch.models.sambert.pnca import (
    MelPNCADecoder,
    pnca_decoder_infer,
    pnca_memory_kv,
)
from kantts_tpu_torch.models.sambert.positions import (
    add_sinusoidal_position,
    duration_position_encoding,
)
from kantts_tpu_torch.utils.mask import get_mask_from_lengths
from kantts_tpu_torch.utils.precision import Dtype


class SelfAttentionEncoder(nn.Module):
    """N FFT blocks with sinusoidal positions and a final LayerNorm."""

    def __init__(self, d_in: int, n_layer: int, d_model: int, n_head: int,
                 d_head: int, d_inner: int, dropout: float, dropout_att: float,
                 dropout_relu: float, max_len: int, dtype: Dtype = None):
        super().__init__()
        self.d_model, self.max_len = d_model, max_len
        self.fft = nn.ModuleList([
            FFTBlock(d_in if i == 0 else d_model, d_model, n_head, d_head,
                     d_inner, (3, 1), dropout, dropout_att, dropout_relu, dtype)
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
        return self.ln(h.float()), attns


class TextFftEncoder(nn.Module):
    """Four summed linguistic embeddings (or, with ``using_byte``, one byte
    embedding) -> encoder -> projection (Textsy-BERT's encoder has none:
    ``use_projection=False``)."""

    def __init__(self, cfg: Dict[str, Any], use_projection: bool = True):
        super().__init__()
        d_emb, d_model = cfg["embedding_dim"], cfg["encoder_num_units"]
        self.d_model = d_model
        self.using_byte = cfg.get("using_byte", False)
        if self.using_byte:
            self.byte_index_emb = nn.Embedding(cfg["byte_index"], d_emb)
        else:
            self.sy_emb = nn.Embedding(cfg["sy"], d_emb)
            self.tone_emb = nn.Embedding(cfg["tone"], d_emb)
            self.syllable_flag_emb = nn.Embedding(cfg["syllable_flag"], d_emb)
            self.ws_emb = nn.Embedding(cfg["word_segment"], d_emb)
        self.ling_enc = SelfAttentionEncoder(
            d_emb, cfg["encoder_num_layers"], d_model,
            cfg["encoder_num_heads"], d_model // cfg["encoder_num_heads"],
            cfg["encoder_ffn_inner_dim"], cfg["encoder_dropout"],
            cfg["encoder_attention_dropout"], cfg["encoder_relu_dropout"],
            cfg["max_len"], compute_dtype(cfg))
        self.ling_proj = (torch_linear(d_model, cfg["encoder_projection_units"],
                                       bias=False) if use_projection else None)

    def forward(self, inputs_ling, masks=None):
        """-> (text_hid, attns, MAS keys). The reference scales its encoder
        input in place, which aliases the embedding that MAS later reads: its
        MAS keys are the embeddings times sqrt(d_model), byte ones too.
        Kept as is."""
        if self.using_byte:
            ling_embedding = self.byte_index_emb(inputs_ling[:, :, 0])
        else:
            ling_embedding = (self.sy_emb(inputs_ling[:, :, 0])
                              + self.tone_emb(inputs_ling[:, :, 1])
                              + self.syllable_flag_emb(inputs_ling[:, :, 2])
                              + self.ws_emb(inputs_ling[:, :, 3]))
        enc_output, attns = self.ling_enc(ling_embedding, masks)
        if self.ling_proj is not None:
            enc_output = self.ling_proj(enc_output)
        return enc_output, attns, ling_embedding * math.sqrt(self.d_model)


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


class FP_Predictor(nn.Module):
    """Four-class filled-pause head over the encoder states: conv k=3 ->
    ReLU -> LN -> dropout -> conv k=1 -> ReLU -> LN -> dropout -> linear ->
    softmax, in float32 whatever the compute dtype. ``fp_dropout`` (0.1 by
    default, as KAN-TTS hardcodes) lets a parity check zero it."""

    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        d_in, d_hid = cfg["encoder_projection_units"], cfg["embedding_dim"] // 2
        self.w_1 = conv1d_same(d_in, d_hid, 3)
        self.layer_norm1 = nn.LayerNorm(d_hid, eps=1e-6)
        self.w_2 = conv1d_same(d_hid, d_in, 1)
        self.layer_norm2 = nn.LayerNorm(d_in, eps=1e-6)
        self.fc = torch_linear(d_in, 4)
        self.dropout = nn.Dropout(cfg.get("fp_dropout", 0.1))

    def forward(self, x):
        h = self.dropout(self.layer_norm1(torch.relu(self.w_1(x))))
        h = self.dropout(self.layer_norm2(torch.relu(self.w_2(h))))
        return torch.softmax(self.fc(h), dim=-1)


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
        self.config = cfg
        self.r, self.d_mel = cfg["outputs_per_step"], cfg["num_mels"]
        self.text_encoder = TextFftEncoder(cfg)
        self.se_enable = cfg.get("SE", False)
        if not self.se_enable:
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
            cfg["decoder_relu_dropout"], compute_dtype(cfg))
        self.mel_postnet = PostNet(cfg)
        self.mas_enable = cfg.get("MAS", False)
        if self.mas_enable:
            self.align_attention = ConvAttention(
                cfg["num_mels"], cfg["embedding_dim"], cfg["num_mels"])
        self.fp_enable = cfg.get("FP", False)
        if self.fp_enable:
            self.FP_predictor = FP_Predictor(cfg)

    # ----------------------------------------------------------- sub-passes

    def encode(self, inputs_ling, input_masks):
        return self.text_encoder(inputs_ling, input_masks)

    def tokenize(self, inputs_emotion, inputs_speaker):
        """-> (emotion, speaker) embeddings; an SE voice's speaker input is
        its (B, T_in, speaker_units) embedding already."""
        spk = (inputs_speaker if self.se_enable
               else self.spk_tokenizer(inputs_speaker))
        return self.emo_tokenizer(inputs_emotion), spk

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

    def insert_fp(self, text_hid, inputs_emotion, inputs_speaker, fp_plan,
                  fp_dict_lings):
        """Splice the encoded filler triples into ``text_hid`` by the plan
        ``(src_idx, filler_class, filler_phase, plan_lengths)``, and extend
        emotion and speaker (ids, or an SE voice's (B, T_in, units)
        embeddings) to the spliced length by wrap-around. The filler bank
        is ``fp_dict_lings`` (3, 3, 4) encoded without a mask. -> (text_hid,
        inputs_emotion, inputs_speaker) of length L."""
        src_idx, filler_class, filler_phase, _ = fp_plan
        filler_bank, _, _ = self.encode(fp_dict_lings, None)
        text_hid = apply_fp_insertion(text_hid, filler_bank, src_idx,
                                      filler_class, filler_phase)
        wrap = torch.arange(text_hid.shape[1], device=text_hid.device) % \
            inputs_emotion.shape[1]
        return text_hid, inputs_emotion[:, wrap], inputs_speaker[:, wrap]

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
                attn_priors=None, fp_plan=None, fp_dict_lings=None,
                ss_prob: Optional[float] = None,
                generator: Optional[torch.Generator] = None,
                global_max: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                ) -> Dict[str, Any]:
        """Teacher-forced forward, as the training step runs it (no loss).
        Dropout follows the module's ``train()``/``eval()`` mode.

        The PNCA band width comes from the batch's largest duration; under
        data parallelism ``global_max`` takes that to the largest over every
        rank, so that each shard decodes with the global batch's band.

        An FP model predicts its filled-pause classes from the encoder
        states (``fp_predictions``); with ``fp_plan`` (the collate's
        insertion plan) and ``fp_dict_lings`` it splices the fillers in
        (``insert_fp``), and the durations, pitch and energy targets are
        then of the plan's length, masked by its lengths.

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

        inter_lengths, fp_p = input_lengths, None
        if self.fp_enable:
            fp_p = self.FP_predictor(text_hid)
            if fp_plan is not None:
                text_hid, inputs_emotion, inputs_speaker = self.insert_fp(
                    text_hid, inputs_emotion, inputs_speaker, fp_plan,
                    fp_dict_lings)
                inter_lengths = fp_plan[3]

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
        inter_masks = get_mask_from_lengths(inter_lengths, text_hid.shape[1])
        output_masks = get_mask_from_lengths(output_lengths, T_mel)
        pitch_pred, energy_pred, text_aug, dur_cond = self.variance_pre(
            text_hid, emo_hid, spk_hid, inter_masks, pitch_targets,
            energy_targets)
        log_dur_pred = self.duration_teacher(duration_targets, dur_cond,
                                             inter_masks)
        LR_text, LR_emo, LR_spk, LR_length = self._regulate(
            text_aug, emo_hid, spk_hid, duration_targets, T_mel, output_masks)
        memory = self.build_memory(LR_text, LR_emo, LR_spk)

        masked_dur = duration_targets.float().masked_fill(inter_masks, 0.0)
        largest = masked_dur.max()
        if global_max is not None:
            largest = global_max(largest)
        band_width = torch.floor(largest / r + 0.5).to(torch.int32)
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
            energy_targets=energy_targets, fp_predictions=fp_p,
            valid_inter_lengths=inter_lengths,
            LR_text_outputs=LR_text, LR_emo_outputs=LR_emo,
            LR_spk_outputs=LR_spk)
        return res


class KanTtsTextsyBERT(nn.Module):
    """Textsy-BERT: the masked-LM over the sy track that pretrains the text
    encoder. ``TextFftEncoder`` without its projection, then ``fc`` to the
    sy vocabulary. Its builder sets no compute dtype, whatever
    ``mixed_precision`` says, as the JAX package's does."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        cfg = dict(config)
        self.config = cfg
        self.text_encoder = TextFftEncoder(cfg, use_projection=False)
        self.fc = torch_linear(cfg["encoder_num_units"], cfg["sy"])

    def forward(self, inputs_ling, input_lengths) -> Dict[str, Any]:
        input_masks = get_mask_from_lengths(input_lengths, inputs_ling.shape[1])
        text_hid, attns, _ = self.text_encoder(inputs_ling, input_masks)
        return {"logits": self.fc(text_hid), "enc_slf_attn_lst": attns}


@torch.no_grad()
def sambert_infer_fp(model: KanTtsSAMBERT, inputs_ling, inputs_emotion,
                     inputs_speaker, input_lengths, fp_dict_lings,
                     max_output_len: int) -> Dict[str, torch.Tensor]:
    """FP inference: predict the filled-pause classes, take their argmax on
    the host (zeroed on padding), build the insertion plan, splice the
    encoded filler triples in, then run ``sambert_infer`` on the spliced
    text hiddens at the spliced lengths. Adds ``fp_predictions`` and
    ``valid_inter_lengths`` to its result."""
    device = inputs_ling.device
    input_masks = get_mask_from_lengths(input_lengths, inputs_ling.shape[1])
    text_hid, _, _ = model.encode(inputs_ling, input_masks)
    fp_p = model.FP_predictor(text_hid)
    fp_classes = fp_classes_from_predictions(fp_p.cpu().numpy(),
                                             input_masks.cpu().numpy())
    src_idx, f_class, f_phase, inter_lengths, _ = build_fp_insertion_plan(
        fp_classes, input_lengths.cpu().numpy())
    plan = [torch.from_numpy(a).to(device)
            for a in (src_idx, f_class, f_phase, inter_lengths)]
    text_hid, emo, spk = model.insert_fp(text_hid, inputs_emotion, inputs_speaker,
                                         plan, fp_dict_lings)
    res = sambert_infer(model, inputs_ling, emo, spk, plan[3], max_output_len,
                        text_hid_override=text_hid)
    res["fp_predictions"] = fp_p
    res["valid_inter_lengths"] = plan[3]
    return res


def infer_encode(model: KanTtsSAMBERT, inputs_ling, inputs_emotion,
                 inputs_speaker, input_lengths,
                 text_hid_override: Optional[torch.Tensor] = None):
    """Inference stage 1: encoder, tokenizers and the variance predictors.
    -> (text_aug, emo_hid, spk_hid, dur_cond, pitch_pred, energy_pred)."""
    text_hid = text_hid_override
    T_in = (inputs_ling if text_hid is None else text_hid).shape[1]
    input_masks = get_mask_from_lengths(input_lengths, T_in)
    if text_hid is None:
        text_hid, _, _ = model.encode(inputs_ling, input_masks)
    emo_hid, spk_hid = model.tokenize(inputs_emotion, inputs_speaker)
    pitch_pred, energy_pred, text_aug, dur_cond = model.variance_pre(
        text_hid, emo_hid, spk_hid, input_masks)
    return text_aug, emo_hid, spk_hid, dur_cond, pitch_pred, energy_pred


def infer_duration_state(model: KanTtsSAMBERT, dur_cond: torch.Tensor):
    """The duration decode's start: (prev (B, 1, 1) zeros, h, c each
    (2, B, H) zeros)."""
    B = dur_cond.shape[0]
    lstm = model.variance_adaptor.duration_predictor.lstm
    h = dur_cond.new_zeros((lstm.num_layers, B, lstm.hidden_size))
    return dur_cond.new_zeros((B, 1, 1)), h, torch.zeros_like(h)


def infer_duration_step(model: KanTtsSAMBERT, prev, cond_t, h, c):
    """One step of the autoregressive duration decode: prev (B, 1, 1) the
    previous step's output, cond_t (B, 1, C) this phone's condition, the
    LSTM state h, c -> (out (B, 1, 1), h, c)."""
    out, (h, c) = model.variance_adaptor.duration_predictor(prev, cond_t, (h, c))
    return out[..., None], h, c


def infer_regulate(model: KanTtsSAMBERT, text_aug, emo_hid, spk_hid, log_dur,
                   input_lengths, max_output_len: int,
                   duration_override: Optional[torch.Tensor] = None):
    """Inference stage 3: durations from the decoded log-durations (or
    ``duration_override``), the length regulator, the decoder memory, the
    band widths and masks, and the memory-side keys and values.
    -> dict of log_dur (masked), durations, memory, h_k, h_v, band_width
    (a scalar at B=1, (B,) otherwise), bw_step (its broadcast form),
    mem_pad_mask and LR_length."""
    r = model.r
    B, T_in = log_dur.shape
    input_masks = get_mask_from_lengths(input_lengths, T_in)
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
    mem_pad_mask = get_mask_from_lengths((LR_length + r - 1) // r,
                                         max_output_len // r)
    h_k, h_v = pnca_memory_kv(model.mel_decoder, memory)
    return {"log_dur": log_dur, "durations": durations, "memory": memory,
            "h_k": h_k, "h_v": h_v, "band_width": band_width, "bw_step": bw_step,
            "mem_pad_mask": mem_pad_mask, "LR_length": LR_length}


def infer_postnet(model: KanTtsSAMBERT, dec_outputs, LR_length,
                  max_output_len: int):
    """Inference stage 5: the decoder's (B, T / r, d_mel * r) outputs ->
    (dec, postnet mel), each (B, T, d_mel), zero past ``LR_length``."""
    output_masks = get_mask_from_lengths(LR_length, max_output_len)
    return model.decode_postnet(dec_outputs, output_masks)


@torch.no_grad()
def sambert_infer(model: KanTtsSAMBERT, inputs_ling, inputs_emotion,
                  inputs_speaker, input_lengths, max_output_len: int,
                  text_hid_override: Optional[torch.Tensor] = None,
                  duration_override: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """Acoustic inference: symbols -> mel at a frame budget of
    ``max_output_len`` (a multiple of r); the valid length is
    ``LR_length_rounded``. ``text_hid_override`` (B, T, D) is an encoded
    text-hidden sequence that takes the encoder's place (the FP path),
    ``input_lengths`` then being its lengths. ``duration_override`` (B, T_in)
    frames per phone replaces the decoded durations; the duration head
    still runs and its predictions are still returned."""
    r = model.r
    if max_output_len % r:
        raise ValueError(f"max_output_len {max_output_len} is not a multiple of r={r}")
    text_aug, emo_hid, spk_hid, dur_cond, pitch_pred, energy_pred = infer_encode(
        model, inputs_ling, inputs_emotion, inputs_speaker, input_lengths,
        text_hid_override)

    # autoregressive duration decode, one phone per step
    B, T_in = dur_cond.shape[:2]
    prev, h, c = infer_duration_state(model, dur_cond)
    log_dur = dur_cond.new_empty((B, T_in))
    for t in range(T_in):
        prev, h, c = infer_duration_step(model, prev, dur_cond[:, t:t + 1], h, c)
        log_dur[:, t] = prev[:, 0, 0]

    reg = infer_regulate(model, text_aug, emo_hid, spk_hid, log_dur, input_lengths,
                         max_output_len, duration_override)
    # the PNCA decode, one group of r frames per step
    dec_outputs = pnca_decoder_infer(model.mel_decoder, reg["memory"], reg["h_k"],
                                     reg["h_v"], reg["bw_step"], reg["bw_step"],
                                     reg["mem_pad_mask"])
    dec, post = infer_postnet(model, dec_outputs, reg["LR_length"], max_output_len)
    return {
        "dec_outputs": dec,
        "postnet_outputs": post,
        "LR_length_rounded": reg["LR_length"],
        "log_duration_predictions": reg["log_dur"],
        "duration_predictions": reg["durations"],
        "pitch_predictions": pitch_pred,
        "energy_predictions": energy_pred,
        "x_band_width": reg["band_width"],
        "h_band_width": reg["band_width"],
    }

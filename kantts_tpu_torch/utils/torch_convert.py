"""KAN-TTS torch state dict -> JAX param tree, the direction that
``utils/convert.py`` inverts (a copy of the parts of
``kantts_tpu/utils/torch_convert.py``: SAM-BERT, Textsy-BERT, the
generator, MPD and MSD).

Tensor layout conventions:
- torch Linear weight (out, in)            -> Dense kernel (in, out): W.T
- torch Conv1d weight (out, in, k)         -> conv kernel (k, in, out)
- torch ConvTranspose1d weight (in, out, k)-> JAX kernel (k, out, in)
  (both are transpose(2, 1, 0))
- torch LSTM weight_ih (4H, in)            -> (in, 4H): W.T
- weight_g (c, 1, 1)                       -> (c,)
- LayerNorm weight/bias                    -> scale/bias
- Embedding weight                         -> embedding
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _set(tree: Dict, path: str, value: np.ndarray) -> None:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _linear(tree, prefix, sd, torch_prefix, bias=True):
    _set(tree, f"{prefix}/kernel", sd[f"{torch_prefix}.weight"].T)
    if bias and f"{torch_prefix}.bias" in sd:
        _set(tree, f"{prefix}/bias", sd[f"{torch_prefix}.bias"])


def _conv1d(tree, prefix, sd, torch_prefix, bias=True):
    _set(tree, f"{prefix}/kernel", sd[f"{torch_prefix}.weight"].transpose(2, 1, 0))
    if bias and f"{torch_prefix}.bias" in sd:
        _set(tree, f"{prefix}/bias", sd[f"{torch_prefix}.bias"])


def _layernorm(tree, prefix, sd, torch_prefix):
    _set(tree, f"{prefix}/scale", sd[f"{torch_prefix}.weight"])
    _set(tree, f"{prefix}/bias", sd[f"{torch_prefix}.bias"])


def _embed(tree, prefix, sd, torch_prefix):
    _set(tree, f"{prefix}/embedding", sd[f"{torch_prefix}.weight"])


def _lstm(tree, prefix, sd, torch_prefix, num_layers=1, bidirectional=False):
    suffixes = [""] + (["_reverse"] if bidirectional else [])
    for layer in range(num_layers):
        for sfx in suffixes:
            _set(tree, f"{prefix}/w_ih_l{layer}{sfx}",
                 sd[f"{torch_prefix}.weight_ih_l{layer}{sfx}"].T)
            _set(tree, f"{prefix}/w_hh_l{layer}{sfx}",
                 sd[f"{torch_prefix}.weight_hh_l{layer}{sfx}"].T)
            _set(tree, f"{prefix}/b_ih_l{layer}{sfx}",
                 sd[f"{torch_prefix}.bias_ih_l{layer}{sfx}"])
            _set(tree, f"{prefix}/b_hh_l{layer}{sfx}",
                 sd[f"{torch_prefix}.bias_hh_l{layer}{sfx}"])


def _wnconv(tree, prefix, sd, torch_prefix):
    """Weight-normed conv (the generator's layers wrap it as .conv1d/.deconv)."""
    _set(tree, f"{prefix}/kernel_v",
         sd[f"{torch_prefix}.weight_v"].transpose(2, 1, 0))
    _set(tree, f"{prefix}/kernel_g",
         sd[f"{torch_prefix}.weight_g"].reshape(-1))
    if f"{torch_prefix}.bias" in sd:
        _set(tree, f"{prefix}/bias", sd[f"{torch_prefix}.bias"])


def _fsmn(tree, prefix, sd, torch_prefix, num_layers):
    for i in range(num_layers):
        _conv1d(tree, f"{prefix}/ffn_{i}/w_1", sd,
                f"{torch_prefix}.ffn_lst.{i}.w_1")
        _conv1d(tree, f"{prefix}/ffn_{i}/w_2", sd,
                f"{torch_prefix}.ffn_lst.{i}.w_2", bias=False)
        # depthwise conv: torch (d, 1, k) -> JAX (k, 1, d)
        _set(tree, f"{prefix}/memory_{i}/conv_dw",
             sd[f"{torch_prefix}.memory_block_lst.{i}.conv_dw.weight"]
             .transpose(2, 1, 0))


def _prenet(tree, prefix, sd, torch_prefix, n_hidden, has_out):
    # Prenet fcs: Linear at indices 0, 3, 6, ... (ReLU/Dropout between)
    for i in range(n_hidden):
        _linear(tree, f"{prefix}/fc_{i}", sd, f"{torch_prefix}.fcs.{3 * i}")
    if has_out:
        _linear(tree, f"{prefix}/fc_out", sd,
                f"{torch_prefix}.fcs.{3 * n_hidden}")


def _fft_block(tree, prefix, sd, torch_prefix):
    _layernorm(tree, f"{prefix}/slf_attn/layer_norm", sd,
               f"{torch_prefix}.slf_attn.layer_norm")
    _linear(tree, f"{prefix}/slf_attn/w_qkv", sd,
            f"{torch_prefix}.slf_attn.w_qkv")
    _linear(tree, f"{prefix}/slf_attn/fc", sd, f"{torch_prefix}.slf_attn.fc")
    _layernorm(tree, f"{prefix}/pos_ffn/layer_norm", sd,
               f"{torch_prefix}.pos_ffn.layer_norm")
    _conv1d(tree, f"{prefix}/pos_ffn/w_1", sd, f"{torch_prefix}.pos_ffn.w_1")
    _conv1d(tree, f"{prefix}/pos_ffn/w_2", sd, f"{torch_prefix}.pos_ffn.w_2")


def _text_encoder(tree, prefix, sd, torch_prefix, cfg, with_proj=True):
    if cfg.get("using_byte", False):
        _embed(tree, f"{prefix}/byte_index_emb", sd,
               f"{torch_prefix}.byte_index_emb")
    else:
        for name in ("sy_emb", "tone_emb", "syllable_flag_emb", "ws_emb"):
            _embed(tree, f"{prefix}/{name}", sd, f"{torch_prefix}.{name}")
    for i in range(cfg["encoder_num_layers"]):
        _fft_block(tree, f"{prefix}/ling_enc/fft_{i}", sd,
                   f"{torch_prefix}.ling_enc.fft.{i}")
    _layernorm(tree, f"{prefix}/ling_enc/ln", sd, f"{torch_prefix}.ling_enc.ln")
    if with_proj:
        _linear(tree, f"{prefix}/ling_proj", sd, f"{torch_prefix}.ling_proj",
                bias=False)


def convert_sambert(sd: Dict[str, np.ndarray], cfg: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """KanTtsSAMBERT state dict -> JAX param tree."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    tree: Dict[str, Any] = {}

    _text_encoder(tree, "text_encoder", sd, "text_encoder", cfg)
    if not cfg.get("SE", False):
        _embed(tree, "spk_tokenizer", sd, "spk_tokenizer")
    _embed(tree, "emo_tokenizer", sd, "emo_tokenizer")

    for name in ("pitch_predictor", "energy_predictor"):
        tp = f"variance_adaptor.{name}"
        _fsmn(tree, f"{name}/fsmn", sd, f"{tp}.fsmn",
              cfg["predictor_fsmn_num_layers"])
        _lstm(tree, f"{name}/blstm", sd, f"{tp}.blstm", 1, bidirectional=True)
        _linear(tree, f"{name}/fc", sd, f"{tp}.fc")

    _prenet(tree, "duration_predictor/prenet", sd,
            "variance_adaptor.duration_predictor.prenet",
            len(cfg["dur_pred_prenet_units"]), has_out=False)
    _lstm(tree, "duration_predictor/lstm", sd,
          "variance_adaptor.duration_predictor.lstm", num_layers=2)
    _linear(tree, "duration_predictor/fc", sd,
            "variance_adaptor.duration_predictor.fc")

    _conv1d(tree, "pitch_emb", sd, "variance_adaptor.pitch_emb")
    _conv1d(tree, "energy_emb", sd, "variance_adaptor.energy_emb")

    dec = "mel_decoder.mel_dec"
    _prenet(tree, "mel_decoder/mel_dec/prenet", sd, f"{dec}.prenet",
            len(cfg["decoder_prenet_units"]), has_out=True)
    _linear(tree, "mel_decoder/mel_dec/dec_in_proj", sd, f"{dec}.dec_in_proj")
    for i in range(cfg["decoder_num_layers"]):
        p = f"mel_decoder/mel_dec/pnca_{i}"
        t = f"{dec}.pnca.{i}"
        _layernorm(tree, f"{p}/pnca_attn/layer_norm", sd,
                   f"{t}.pnca_attn.layer_norm")
        for lin in ("w_x_qkv", "fc_x", "w_h_kv", "fc_h"):
            _linear(tree, f"{p}/pnca_attn/{lin}", sd, f"{t}.pnca_attn.{lin}")
        _layernorm(tree, f"{p}/pos_ffn/layer_norm", sd,
                   f"{t}.pos_ffn.layer_norm")
        _conv1d(tree, f"{p}/pos_ffn/w_1", sd, f"{t}.pos_ffn.w_1")
        _conv1d(tree, f"{p}/pos_ffn/w_2", sd, f"{t}.pos_ffn.w_2")
    _layernorm(tree, "mel_decoder/mel_dec/ln", sd, f"{dec}.ln")
    _linear(tree, "mel_decoder/mel_dec/dec_out_proj", sd, f"{dec}.dec_out_proj")

    _fsmn(tree, "mel_postnet/fsmn", sd, "mel_postnet.fsmn",
          cfg["postnet_fsmn_num_layers"])
    _lstm(tree, "mel_postnet/lstm", sd, "mel_postnet.lstm")
    _linear(tree, "mel_postnet/fc", sd, "mel_postnet.fc")

    if cfg.get("MAS", False):
        att = "align_attention"
        _conv1d(tree, f"{att}/key_proj_0", sd, f"{att}.key_proj.0.conv")
        _conv1d(tree, f"{att}/key_proj_1", sd, f"{att}.key_proj.2.conv")
        _conv1d(tree, f"{att}/query_proj_0", sd, f"{att}.query_proj.0.conv")
        _conv1d(tree, f"{att}/query_proj_1", sd, f"{att}.query_proj.2.conv")
        _conv1d(tree, f"{att}/query_proj_2", sd, f"{att}.query_proj.4.conv")

    if cfg.get("FP", False):
        _conv1d(tree, "FP_predictor/w_1", sd, "FP_predictor.w_1")
        _conv1d(tree, "FP_predictor/w_2", sd, "FP_predictor.w_2")
        _layernorm(tree, "FP_predictor/layer_norm1", sd,
                   "FP_predictor.layer_norm1")
        _layernorm(tree, "FP_predictor/layer_norm2", sd,
                   "FP_predictor.layer_norm2")
        _linear(tree, "FP_predictor/fc", sd, "FP_predictor.fc")

    return tree


def convert_hifigan_generator(sd: Dict[str, np.ndarray], cfg: Dict[str, Any]
                              ) -> Dict[str, Any]:
    """HiFi-GAN Generator state dict -> JAX param tree."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    tree: Dict[str, Any] = {}
    n_up = len(cfg["upsample_scales"])
    n_res = len(cfg["resblock_kernel_sizes"])

    _wnconv(tree, "conv_pre", sd, "conv_pre.conv1d")
    for i in range(n_up):
        _wnconv(tree, f"transpose_upsamples_{i}", sd,
                f"transpose_upsamples.{i}.1.deconv")
        _wnconv(tree, f"repeat_upsamples_{i}", sd,
                f"repeat_upsamples.{i}.2.conv1d")
        for j in range(n_res):
            flat = i * n_res + j
            dil = cfg["resblock_dilations"][j]
            for d in range(len(dil)):
                _wnconv(tree, f"conv_blocks_{i}_{j}/convs1_{d}", sd,
                        f"conv_blocks.{flat}.convs1.{d}.conv1d")
                _wnconv(tree, f"conv_blocks_{i}_{j}/convs2_{d}", sd,
                        f"conv_blocks.{flat}.convs2.{d}.conv1d")
    _wnconv(tree, "conv_post", sd, "conv_post.conv1d")

    if cfg.get("nsf_params") is not None:
        _wnconv(tree, "source_module/ffn", sd, "source_module.ffn.0")
        for i in range(n_up):
            _wnconv(tree, f"source_downs_{i}", sd, f"source_downs.{i}.conv1d")
    return tree


def _wnconv_raw(tree, prefix, sd, torch_prefix, ndim=3):
    """Weight-normed conv whose torch module is the bare nn.ConvNd (the
    discriminators wrap convs directly). torch conv2d weight
    (out, in, kh, kw) -> JAX (kh, kw, in, out)."""
    perm = {3: (2, 1, 0), 4: (2, 3, 1, 0)}[ndim]
    _set(tree, f"{prefix}/kernel_v",
         sd[f"{torch_prefix}.weight_v"].transpose(*perm))
    _set(tree, f"{prefix}/kernel_g",
         sd[f"{torch_prefix}.weight_g"].reshape(-1))
    if f"{torch_prefix}.bias" in sd:
        _set(tree, f"{prefix}/bias", sd[f"{torch_prefix}.bias"])


def convert_mpd(sd: Dict[str, np.ndarray], periods, n_downs=5
                ) -> Dict[str, Any]:
    """MultiPeriodDiscriminator state dict -> param tree (conv_post is a
    plain conv)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    tree: Dict[str, Any] = {}
    for i in range(len(periods)):
        t = f"discriminators.{i}"
        for j in range(n_downs):
            _wnconv_raw(tree, f"discriminators_{i}/convs_{j}", sd,
                        f"{t}.convs.{j}.0", ndim=4)
        _set(tree, f"discriminators_{i}/conv_post/kernel_v",
             sd[f"{t}.conv_post.weight"].transpose(2, 3, 1, 0))
        _set(tree, f"discriminators_{i}/conv_post/bias",
             sd[f"{t}.conv_post.bias"])
    return tree


def convert_msd(sd: Dict[str, np.ndarray], scales=3, n_downs=5,
                has_dwt_aux=False) -> Dict[str, Any]:
    """MultiScaleDiscriminator state dict -> param tree, in the weight-norm
    layout only (``utils/convert.py`` shows spectral-normed convs to it as
    weight-normed ones)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    tree: Dict[str, Any] = {}
    for i in range(scales):
        t = f"discriminators.{i}"
        # convs: first + n_downs downsample + final k2 conv
        for j in range(n_downs + 2):
            _wnconv_raw(tree, f"discriminators_{i}/convs_{j}", sd,
                        f"{t}.convs.{j}.0", ndim=3)
        _wnconv_raw(tree, f"discriminators_{i}/conv_post", sd,
                    f"{t}.conv_post", ndim=3)
    if has_dwt_aux:
        for i in range(scales - 1):
            _wnconv_raw(tree, f"aux_convs_{i}", sd, f"aux_convs.{i}", ndim=3)
    return tree


def convert_sybert(sd: Dict[str, np.ndarray], cfg: Dict[str, Any]
                   ) -> Dict[str, Any]:
    """KanTtsTextsyBERT state dict -> JAX param tree: the text encoder
    without its projection, and the sy-vocabulary ``fc`` head."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    tree: Dict[str, Any] = {}
    _text_encoder(tree, "text_encoder", sd, "text_encoder", cfg,
                  with_proj=False)
    _linear(tree, "fc", sd, "fc")
    return tree

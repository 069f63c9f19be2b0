"""Model configurations the port runs, as Python dicts.

They repeat ``kantts_tpu/configs/sambert_16k_MAS.yaml`` and
``kantts_tpu/configs/hifigan_v1_16k.yaml`` (model parameters and the
linguistic unit; the vocoder's sampling rate is that of
``audio_config_16k.yaml``), so that the port needs no YAML parser. The
tests hold these dicts equal to the YAML files.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

SAMBERT_16K_MAS: Dict[str, Any] = {
    "model_type": "sambert",
    "Model": {"KanTtsSAMBERT": {"params": {
        "max_len": 800,
        "embedding_dim": 512,
        "encoder_num_layers": 8,
        "encoder_num_heads": 8,
        "encoder_num_units": 128,
        "encoder_ffn_inner_dim": 1024,
        "encoder_dropout": 0.1,
        "encoder_attention_dropout": 0.1,
        "encoder_relu_dropout": 0.1,
        "encoder_projection_units": 32,
        "speaker_units": 32,
        "emotion_units": 32,
        "predictor_filter_size": 41,
        "predictor_fsmn_num_layers": 3,
        "predictor_num_memory_units": 128,
        "predictor_ffn_inner_dim": 256,
        "predictor_dropout": 0.1,
        "predictor_shift": 0,
        "predictor_lstm_units": 128,
        "dur_pred_prenet_units": [128, 128],
        "dur_pred_lstm_units": 128,
        "decoder_prenet_units": [256, 256],
        "decoder_num_layers": 12,
        "decoder_num_heads": 8,
        "decoder_num_units": 128,
        "decoder_ffn_inner_dim": 1024,
        "decoder_dropout": 0.1,
        "decoder_attention_dropout": 0.1,
        "decoder_relu_dropout": 0.1,
        "outputs_per_step": 3,
        "num_mels": 80,
        "postnet_filter_size": 41,
        "postnet_fsmn_num_layers": 4,
        "postnet_num_memory_units": 256,
        "postnet_ffn_inner_dim": 512,
        "postnet_dropout": 0.1,
        "postnet_shift": 17,
        "postnet_lstm_units": 128,
        "MAS": True,
    }}},
    "linguistic_unit": {
        "cleaners": "english_cleaners",
        "lfeat_type_list": ("sy,tone,syllable_flag,word_segment,emo_category,"
                            "speaker_category"),
        "speaker_list": "F7",
    },
}

HIFIGAN_V1_16K: Dict[str, Any] = {
    "model_type": "hifigan",
    "Model": {"Generator": {"params": {
        "in_channels": 80,
        "out_channels": 1,
        "channels": 256,
        "kernel_size": 7,
        "upsample_scales": [10, 5, 2, 2],
        "upsample_kernal_sizes": [20, 10, 4, 4],
        "resblock_kernel_sizes": [3, 7, 11],
        "resblock_dilations": [[1, 3, 5, 7], [1, 3, 5, 7], [1, 3, 5, 7]],
        "bias": True,
        "causal": True,
        "nonlinear_activation": "LeakyReLU",
        "nonlinear_activation_params": {"negative_slope": 0.1},
        "use_weight_norm": True,
    }}},
    "audio_config": {"sampling_rate": 16000},
}


def get_config(name: str) -> Dict[str, Any]:
    """A deep copy of a named configuration."""
    return copy.deepcopy({"sambert_16k_MAS": SAMBERT_16K_MAS,
                          "hifigan_v1_16k": HIFIGAN_V1_16K}[name])

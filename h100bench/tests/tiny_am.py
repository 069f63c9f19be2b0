"""SAM-BERT with MAS at TINY widths for the CPU tests: the structure of
``voice16k_mas_am``'s ``sambert_16k_MAS`` (every part, every dropout at its
published rate) at widths a CPU run holds."""

import copy
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(
    max_len=64, embedding_dim=32, encoder_num_layers=2, encoder_num_heads=2,
    encoder_num_units=16, encoder_ffn_inner_dim=32, encoder_projection_units=8,
    speaker_units=8, emotion_units=8, predictor_filter_size=5,
    predictor_fsmn_num_layers=2, predictor_num_memory_units=16,
    predictor_ffn_inner_dim=16, predictor_lstm_units=8, dur_pred_prenet_units=[8, 8],
    dur_pred_lstm_units=8, decoder_prenet_units=[16, 16], decoder_num_layers=2,
    decoder_num_heads=2, decoder_num_units=16, decoder_ffn_inner_dim=32,
    postnet_filter_size=5, postnet_fsmn_num_layers=2, postnet_num_memory_units=16,
    postnet_ffn_inner_dim=16, postnet_shift=1, postnet_lstm_units=8)


def tiny_am_cfg() -> dict:
    """The ``voice16k_mas_am`` configuration with its SAM-BERT at TINY widths."""
    with open(os.path.join(BENCH, "configs", "voice16k_mas_am.json")) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["sambert"]["Model"]["KanTtsSAMBERT"]["params"].update(TINY)
    return cfg

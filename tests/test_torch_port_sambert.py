"""SAM-BERT modules of the PyTorch port against the JAX package, one module
at a time, on the same weights (moved by the weight bridge) and the same
numpy inputs. f32 outputs agree at atol 1e-5: both sides compute in float32
and differ only in the order of sums."""

import flax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from kantts_tpu.models.sambert.adaptors import length_regulate as j_length_regulate
from kantts_tpu.models.sambert.attention import ConvAttention as JConvAttention
from kantts_tpu.models.sambert.common import FFTBlock as JFFTBlock
from kantts_tpu.models.sambert.fsmn import FsmnEncoderV2 as JFsmn
from kantts_tpu.models.sambert.lstm import LSTM as JLSTM, BiLSTM as JBiLSTM
from kantts_tpu.models.sambert.pnca import MelPNCADecoder, pnca_band_masks
from kantts_tpu.models.sambert.positions import (
    duration_position_encoding as j_dur_pos,
)
from kantts_tpu.models.sambert.sambert import make_mel_decoder
from kantts_tpu.utils.torch_convert import convert_sambert
from kantts_tpu_torch.configs import get_config
from kantts_tpu_torch.models.builder import init_parameters
from kantts_tpu_torch.models.sambert.adaptors import length_regulate
from kantts_tpu_torch.models.sambert.pnca import pnca_band_masks as t_pnca_band_masks
from kantts_tpu_torch.models.sambert.pnca import pnca_memory_kv
from kantts_tpu_torch.models.sambert.positions import duration_position_encoding
from kantts_tpu_torch.models.sambert.sambert import KanTtsSAMBERT
from kantts_tpu_torch.utils.convert import sambert_state_dict_from_jax
from kantts_tpu_torch.utils.mask import get_mask_from_lengths
from test_sambert import TINY

ATOL = 1e-5
CFG = dict(TINY, MAS=True)


@pytest.fixture(scope="module")
def models():
    """A TINY MAS SAM-BERT of the port with seeded weights, and the same
    weights as JAX params (through the JAX package's converter)."""
    port = KanTtsSAMBERT(CFG)
    init_parameters(port, seed=0)
    params = convert_sambert({k: v.numpy() for k, v in port.state_dict().items()},
                             CFG)
    return params, port.eval()


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(jax_out, torch_out, atol=ATOL):
    np.testing.assert_allclose(np.asarray(jax_out), torch_out.detach().numpy(),
                               atol=atol, rtol=0)


def test_weight_bridge_round_trip(models):
    params, port = models
    sd = sambert_state_dict_from_jax(params, CFG)
    fresh = KanTtsSAMBERT(CFG)
    fresh.load_state_dict(sd, strict=True)
    for k, v in port.state_dict().items():
        assert torch.equal(sd[k], v), k
    back = convert_sambert({k: v.numpy() for k, v in sd.items()}, CFG)
    a = flax.traverse_util.flatten_dict(params)
    b = flax.traverse_util.flatten_dict(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg="/".join(k))


def test_configs_match_the_yaml():
    for name, section in (("sambert_16k_MAS", "KanTtsSAMBERT"),
                          ("hifigan_v1_16k", "Generator")):
        with open(f"kantts_tpu/configs/{name}.yaml") as f:
            ref = yaml.safe_load(f)
        ours = get_config(name)
        assert ours["Model"][section]["params"] == ref["Model"][section]["params"]
        assert ours["model_type"] == ref["model_type"]
        if "linguistic_unit" in ours:
            assert ours["linguistic_unit"] == ref["linguistic_unit"]
    with open("kantts_tpu/configs/audio_config_16k.yaml") as f:
        sr = yaml.safe_load(f)["audio_config"]["sampling_rate"]
    assert get_config("hifigan_v1_16k")["audio_config"]["sampling_rate"] == sr


@pytest.mark.parametrize("layer", [0, 1])
def test_fft_block(models, layer):
    params, port = models
    d_in = CFG["embedding_dim"] if layer == 0 else CFG["encoder_num_units"]
    x = _rand(0, 2, 7, d_in)
    lengths = np.array([7, 4])
    mask = np.arange(7)[None] >= lengths[:, None]
    d_model, heads = CFG["encoder_num_units"], CFG["encoder_num_heads"]
    j_out, j_attn = JFFTBlock(d_model, heads, d_model // heads,
                              CFG["encoder_ffn_inner_dim"]).apply(
        {"params": params["text_encoder"]["ling_enc"][f"fft_{layer}"]},
        jnp.asarray(x), jnp.asarray(mask),
        jnp.broadcast_to(jnp.asarray(mask)[:, None, :], (2, 7, 7)))
    t_out, t_attn = port.text_encoder.ling_enc.fft[layer](
        torch.from_numpy(x), torch.from_numpy(mask))
    _close(j_out, t_out)
    _close(j_attn, t_attn)


@pytest.mark.parametrize("where", ["pitch_predictor", "postnet"])
def test_fsmn(models, where):
    params, port = models
    if where == "postnet":
        p, mod, d_in = params["mel_postnet"]["fsmn"], port.mel_postnet.fsmn, CFG["num_mels"]
        jmod = JFsmn(CFG["postnet_filter_size"], CFG["postnet_fsmn_num_layers"],
                     CFG["postnet_num_memory_units"], CFG["postnet_ffn_inner_dim"],
                     0.0, CFG["postnet_shift"])
    else:
        p = params["pitch_predictor"]["fsmn"]
        mod = port.variance_adaptor.pitch_predictor.fsmn
        d_in = mod.ffn_lst[0].w_1.in_channels
        jmod = JFsmn(CFG["predictor_filter_size"], CFG["predictor_fsmn_num_layers"],
                     CFG["predictor_num_memory_units"],
                     CFG["predictor_ffn_inner_dim"], 0.0, CFG["predictor_shift"])
    x = _rand(1, 2, 9, d_in)
    mask = np.arange(9)[None] >= np.array([9, 5])[:, None]
    _close(jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask)),
           mod(torch.from_numpy(x), torch.from_numpy(mask)))


def test_lstm_with_carried_state(models):
    params, port = models
    mod = port.variance_adaptor.duration_predictor.lstm
    p = params["duration_predictor"]["lstm"]
    H = CFG["dur_pred_lstm_units"]
    x = _rand(2, 2, 5, mod.input_size)
    h0, c0 = _rand(3, 2, 2, H), _rand(4, 2, 2, H)
    j_out, (jh, jc) = JLSTM(H, num_layers=2).apply(
        {"params": p}, jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(c0)))
    t_out, (th, tc) = mod(torch.from_numpy(x), (torch.from_numpy(h0),
                                                torch.from_numpy(c0)))
    for a, b in ((j_out, t_out), (jh, th), (jc, tc)):
        _close(a, b)
    # one step at a time carries the same state as the whole sequence
    state, steps = (torch.from_numpy(h0), torch.from_numpy(c0)), []
    for t in range(5):
        out, state = mod(torch.from_numpy(x[:, t:t + 1]), state)
        steps.append(out)
    _close(j_out, torch.cat(steps, dim=1))


def test_bilstm_reverses_per_length(models):
    params, port = models
    mod = port.variance_adaptor.pitch_predictor.blstm
    x = _rand(5, 3, 6, mod.input_size)
    lengths = np.array([6, 4, 1])
    valid = np.arange(6)[None] < lengths[:, None]
    j_out = JBiLSTM(mod.hidden_size).apply(
        {"params": params["pitch_predictor"]["blstm"]}, jnp.asarray(x),
        jnp.asarray(lengths))
    t_out = mod(torch.from_numpy(x), torch.from_numpy(lengths))
    # padding positions are masked downstream; the JAX forward direction
    # runs on through them while the packed torch one stops
    _close(np.asarray(j_out)[valid], t_out[torch.from_numpy(valid)])
    assert not t_out[~torch.from_numpy(valid)].any()


def test_length_regulate_and_duration_positions():
    rng = np.random.RandomState(6)
    durs = rng.uniform(0, 4, (2, 6)).astype(np.float32)
    durs[0, 2] = 2.5  # rounds up, as floor(d + 0.5)
    x = _rand(7, 2, 6, 5)
    out_mask = np.arange(18)[None] >= np.array([18, 9])[:, None]
    j_lr, j_len = j_length_regulate(jnp.asarray(x), jnp.asarray(durs), 18,
                                    jnp.asarray(out_mask))
    t_lr, t_len = length_regulate(torch.from_numpy(x), torch.from_numpy(durs), 18,
                                  torch.from_numpy(out_mask))
    _close(j_lr, t_lr)
    np.testing.assert_array_equal(np.asarray(j_len), t_len.numpy())
    _close(j_dur_pos(jnp.asarray(durs), 8, 18, jnp.asarray(out_mask)),
           duration_position_encoding(torch.from_numpy(durs), 8, 18,
                                      torch.from_numpy(out_mask)))


def _decoder_inputs(seed=8, B=2, T=6):
    d_mem = (CFG["encoder_projection_units"] * CFG["outputs_per_step"]
             + CFG["emotion_units"] + CFG["speaker_units"])
    memory = _rand(seed, B, T, d_mem)
    target = _rand(seed + 1, B, T * CFG["outputs_per_step"], CFG["num_mels"])
    mask = np.arange(T)[None] >= np.array([T, T - 2])[:, None]
    return memory, target, mask


def test_pnca_teacher_forced(models):
    params, port = models
    memory, target, mask = _decoder_inputs()
    bw = np.int32(2)
    j_out, j_ax, j_ah = make_mel_decoder(CFG).apply(
        {"params": params["mel_decoder"]}, jnp.asarray(memory), jnp.asarray(bw),
        jnp.asarray(bw), jnp.asarray(target), jnp.asarray(mask),
        return_attns=True)
    t_out, t_ax, t_ah = port.mel_decoder(
        torch.from_numpy(memory), torch.tensor(2), torch.tensor(2),
        torch.from_numpy(target), torch.from_numpy(mask))
    _close(j_out, t_out)
    for a, b in zip(j_ax + j_ah, t_ax + t_ah):
        _close(a, b)
    jx, jh = pnca_band_masks(6, jnp.asarray(2), jnp.asarray(1), jnp.asarray(mask))
    tx, th = t_pnca_band_masks(6, torch.tensor(2), torch.tensor(1), torch.from_numpy(mask))
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())


def test_pnca_incremental_steps(models):
    """Three steps through the preallocated cache with per-item band widths,
    against the JAX step."""
    params, port = models
    memory, _, mask = _decoder_inputs(seed=10)
    B, T, _ = memory.shape
    bw = np.array([1, 2], np.int32).reshape(B, 1, 1, 1)
    dec = make_mel_decoder(CFG)
    v = {"params": params["mel_decoder"]}
    h_kv = dec.apply(v, jnp.asarray(memory), method=MelPNCADecoder.dec_prepare)
    L, H = CFG["decoder_num_layers"], CFG["decoder_num_heads"]
    dh = CFG["decoder_num_units"] // H
    caches = (jnp.zeros((L, B, H, T, dh)), jnp.zeros((L, B, H, T, dh)))
    mel_dec = port.mel_decoder.mel_dec
    t_mem = torch.from_numpy(memory)
    t_hk, t_hv = pnca_memory_kv(port.mel_decoder, t_mem)
    ck, cv = torch.zeros(L, B, H, T, dh), torch.zeros(L, B, H, T, dh)
    prev = _rand(11, B, 1, CFG["num_mels"])
    for t in range(3):
        j_out, caches = dec.apply(
            v, jnp.asarray(t), jnp.asarray(prev), jnp.asarray(memory[:, t:t + 1]),
            h_kv, caches, jnp.asarray(bw), jnp.asarray(bw), jnp.asarray(mask),
            method=MelPNCADecoder.dec_step)
        t_out = mel_dec.step(torch.tensor(t), torch.from_numpy(prev), t_mem, t_hk,
                             t_hv, ck, cv, torch.from_numpy(bw), torch.from_numpy(bw),
                             torch.from_numpy(mask))
        _close(j_out, t_out)
        _close(caches[0], ck)
        prev = np.array(j_out)[:, :, -CFG["num_mels"]:]


def test_conv_attention(models):
    params, port = models
    T_mel, T_text = 10, 7
    queries = _rand(12, 2, T_mel, CFG["num_mels"])
    keys = _rand(13, 2, T_text, CFG["embedding_dim"])
    mask = np.arange(T_text)[None] >= np.array([7, 5])[:, None]
    prior = np.abs(_rand(14, 2, T_mel, T_text)) + 0.1
    prior /= prior.sum(-1, keepdims=True)
    j_attn, j_logp = JConvAttention(CFG["num_mels"], CFG["embedding_dim"],
                                    CFG["num_mels"]).apply(
        {"params": params["align_attention"]}, jnp.asarray(queries),
        jnp.asarray(keys), jnp.asarray(mask), jnp.asarray(prior))
    t_attn, t_logp = port.align_attention(
        torch.from_numpy(queries), torch.from_numpy(keys), torch.from_numpy(mask),
        torch.from_numpy(prior))
    _close(j_attn, t_attn)
    _close(j_logp, t_logp)


def test_padding_mask():
    lengths = torch.tensor([3, 0, 5])
    np.testing.assert_array_equal(
        get_mask_from_lengths(lengths, 5).numpy(),
        np.arange(5)[None] >= lengths.numpy()[:, None])

"""int8 W8A8 vocoding in the port against the JAX package, at tiny widths on
the CPU: the int8 conv's plain version (kernel K2's reference), the int8
generator, its static calibrated scales, generators without weight norm,
and the int8 CLI and service.

Tolerances: the int8 values and the int32 sums are integers and equal the
JAX package's bit for bit; a layer's float32 output within 1 ulp (JAX may
contract the rescale and the bias add into one rounding); the int8
generator within 0.25 e_q of JAX's, e_q = max |JAX int8 - JAX f32| on the
same mel (a flip of one activation's rounding at a .5 boundary moves an
output by a fraction of the quantization error, not by more); float32
parity 1e-5, the generator's.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import serialization
from jax import lax

import kantts_tpu.bin.infer_hifigan as j_infer_hifigan
from kantts_tpu.models.hifigan.generator import Generator as JGenerator
from kantts_tpu.models.hifigan.generator import (
    calibrate_quant_scales as j_calibrate_quant_scales,
)
from kantts_tpu.models.hifigan.layers import WNConv1d as JWNConv1d
from kantts_tpu.models.hifigan.layers import WNConvTranspose1d as JWNConvTranspose1d
from kantts_tpu.models.hifigan.layers import _act_scale as j_act_scale
from kantts_tpu.models.hifigan.layers import _quantize_sym as j_quantize_sym
import kantts_tpu_torch.bin.infer_hifigan as infer_hifigan
from kantts_tpu_torch.infer.chunked import chunked_apply
from kantts_tpu_torch.models.builder import init_parameters, save_checkpoint
from kantts_tpu_torch.models.hifigan.generator import (
    Generator,
    calibrate_quant_scales,
    int8_convs,
)
from kantts_tpu_torch.models.hifigan.layers import (
    WNConv1d,
    WNConvTranspose1d,
    quantize_weights,
)
from kantts_tpu_torch.models.sambert.lstm import BiLSTM
from kantts_tpu_torch.ops.int8_conv import (
    act_scale,
    int8_sums_torch,
    quantize_sym,
    quantize_weight,
)
from kantts_tpu_torch.serve import TTSService
from kantts_tpu_torch.utils.convert import hifigan_state_dict_from_jax
from test_torch_port_serve import TEXTS as SERVE_TEXTS
from test_torch_port_slice import slice_models  # noqa: F401

KW = dict(in_channels=80, out_channels=1, channels=32, kernel_size=7,
          upsample_scales=(4, 4), upsample_kernal_sizes=(8, 8),
          resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),),
          causal=True)
HOP = 16


def _mel(B=2, T=50, C=80, seed=0):
    return np.random.RandomState(seed).randn(B, T, C).astype(np.float32)


def _ulp_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=float(np.spacing(np.abs(want).max())))


# ------------------------------------------------- the int8 conv, layer level

def _layer_pair(transposed, causal, k, stride, dilation, c_in, c_out, seed):
    """JAX and port layers without weight norm on one seeded float32 weight
    (JAX layout (k, in, out) for the conv, (k, out, in) for the transposed
    conv), int8 on."""
    rng = np.random.RandomState(seed)
    if transposed:
        w = rng.randn(k, c_out, c_in).astype(np.float32)
        pad = (k - stride) // 2
        j_layer = JWNConvTranspose1d(c_out, k, stride=stride, padding=pad,
                                     causal=causal, use_weight_norm=False, quant=True)
        port = WNConvTranspose1d(c_in, c_out, k, stride, padding=pad, causal=causal,
                                 use_weight_norm=False, quant=True)
        port.deconv.weight.data = torch.from_numpy(w.transpose(2, 1, 0).copy())
    else:
        w = rng.randn(k, c_in, c_out).astype(np.float32)
        j_layer = JWNConv1d(c_out, k, padding=(k * dilation - dilation) // 2,
                            dilation=dilation, causal=causal, use_weight_norm=False,
                            quant=True)
        port = WNConv1d(c_in, c_out, k, padding=(k * dilation - dilation) // 2,
                        dilation=dilation, causal=causal, use_weight_norm=False,
                        quant=True)
        port.conv1d.weight.data = torch.from_numpy(w.transpose(2, 1, 0).copy())
    b = rng.randn(c_out).astype(np.float32)
    port.params.bias.data = torch.from_numpy(b)
    quantize_weights(port)
    return j_layer, {"params": {"kernel_v": w, "bias": b}}, port, w


def _jax_int8(x_btc, w, transposed, causal, k, stride, dilation, pad):
    """The JAX package's int8 values and int32 sums, from its own functions."""
    x = jnp.asarray(x_btc)
    s_x = j_act_scale(x)
    xq = j_quantize_sym(x, s_x)
    if transposed:
        s_w = jnp.maximum(jnp.max(jnp.abs(w), axis=(0, 2)), 1e-12) / 127.0
        wq = j_quantize_sym(jnp.asarray(w), s_w[None, :, None])
        acc = lax.conv_transpose(xq, wq, strides=(stride,), padding="VALID",
                                 dimension_numbers=("NHC", "HIO", "NHC"),
                                 transpose_kernel=True,
                                 preferred_element_type=jnp.int32)
        acc = (acc[:, :x.shape[1] * stride] if causal
               else acc[:, pad:acc.shape[1] - pad])
    else:
        s_w = jnp.maximum(jnp.max(jnp.abs(w), axis=(0, 1)), 1e-12) / 127.0
        wq = j_quantize_sym(jnp.asarray(w), s_w[None, None, :])
        pads = [((k - 1) * dilation, 0)] if causal else [(pad, pad)]
        acc = lax.conv_general_dilated(xq, wq, window_strides=(1,), padding=pads,
                                       rhs_dilation=(dilation,),
                                       dimension_numbers=("NHC", "HIO", "NHC"),
                                       preferred_element_type=jnp.int32)
    return (np.asarray(s_x)[:, 0, 0], np.asarray(xq), np.asarray(s_w), np.asarray(wq),
            np.asarray(acc))


CONV_CASES = [("conv", causal, k, 1, d) for causal in (True, False)
              for k in (3, 7, 11) for d in (1, 3, 5)]
TRANSPOSED_CASES = [("transposed", causal, 2 * s, s, 1) for causal in (True, False)
                    for s in (10, 5, 2)]


@pytest.mark.parametrize("mode,causal,k,stride,dilation", CONV_CASES + TRANSPOSED_CASES)
def test_int8_conv_matches_jax(mode, causal, k, stride, dilation):
    """The same float32 w and x through both packages: the int8 values, the
    scales and the int32 sums equal bit for bit, the outputs within 1 ulp."""
    transposed = mode == "transposed"
    T = 9 if transposed else 23
    j_layer, j_vars, port, w = _layer_pair(transposed, causal, k, stride, dilation,
                                           8, 12, seed=k * 10 + stride + dilation)
    x = np.random.RandomState(k + dilation).randn(2, T, 8).astype(np.float32) * 3
    pad = (k - stride) // 2 if transposed else (k * dilation - dilation) // 2
    s_x, xq, s_w, wq, acc = _jax_int8(x, w, transposed, causal, k, stride, dilation,
                                      pad)
    xt = torch.from_numpy(x.transpose(0, 2, 1).copy())
    got_s_x = act_scale(xt)
    got_xq = quantize_sym(xt, got_s_x[:, None, None])
    np.testing.assert_array_equal(got_s_x.numpy(), s_x)
    np.testing.assert_array_equal(got_xq.numpy(), xq.transpose(0, 2, 1))
    np.testing.assert_array_equal(port.s_w.numpy(), s_w)
    np.testing.assert_array_equal(port.w_q.numpy(), wq.transpose(2, 1, 0))
    pl, pr = (port.padding, port.padding) if transposed else port.pads
    got_acc = int8_sums_torch(got_xq, port.w_q, stride, dilation, pl, pr,
                              transposed, causal)
    np.testing.assert_array_equal(got_acc.numpy(), acc.transpose(0, 2, 1))
    want = np.asarray(j_layer.apply(j_vars, jnp.asarray(x)))
    with torch.no_grad():
        got = port(xt).numpy().transpose(0, 2, 1)
    assert got.shape == want.shape
    _ulp_close(got, want)


def test_int8_sums_beyond_float32_integers():
    """C_in 256, k 7 on saturated inputs and weights: |acc| reaches
    127^2 * 1792 > 2^24, where float32 holds only even integers, and the
    exact sum here is odd. The plain version's float64 sums equal JAX's
    int32 sums; a float32 convolution of the same int8 values does not."""
    c_in, k, T = 256, 7, 20
    w = np.ones((k, c_in, 4), dtype=np.float32)
    w[3, 100, :] = 126.0 / 127.0  # one product 127 * 126: the total is odd
    x = np.ones((1, T, c_in), dtype=np.float32)
    x[:, T // 2:] = -1.0
    _, xq, _, wq, acc = _jax_int8(x, w, False, True, k, 1, 1, 0)
    assert np.abs(acc).max() > 2 ** 24 and np.abs(acc).max() % 2 == 1
    xq_t = torch.from_numpy(xq.transpose(0, 2, 1).copy())
    wq_t, _ = quantize_weight(torch.from_numpy(w.transpose(2, 1, 0).copy()), False)
    np.testing.assert_array_equal(wq_t.numpy(), wq.transpose(2, 1, 0))
    got = int8_sums_torch(xq_t, wq_t, 1, 1, k - 1, 0, False, True)
    np.testing.assert_array_equal(got.numpy(), acc.transpose(0, 2, 1))
    f32 = F.conv1d(F.pad(xq_t.float(), (k - 1, 0)), wq_t.float())
    assert (f32.double() != got.double()).any()


# ------------------------------------------------------- the int8 generator

def _port_generators(kw=KW, seed=0):
    """f32 and int8 port generators on the same seeded weights, folded."""
    gen = Generator(**kw).eval()
    init_parameters(gen, seed)
    genq = Generator(**kw, quant=True).eval()
    genq.load_state_dict(gen.state_dict(), strict=True)
    return gen, quantize_weights(genq)


def test_quant_params_identical_to_f32():
    gen, genq = _port_generators()
    a, b = dict(gen.named_parameters()), dict(genq.named_parameters())
    assert a.keys() == b.keys()
    g2 = Generator(**KW, quant=True)
    init_parameters(g2, 0)
    for name, p in g2.named_parameters():
        assert torch.equal(p, a[name]), name
    assert set(gen.state_dict()) == set(genq.state_dict())


def test_quant_output_close_to_f32():
    gen, genq = _port_generators()
    mel = torch.from_numpy(_mel())
    with torch.no_grad():
        y, yq = gen(mel).numpy(), genq(mel).numpy()
    assert y.shape == yq.shape and np.isfinite(yq).all()
    rel = np.linalg.norm(yq - y) / np.linalg.norm(y)
    corr = np.corrcoef(y.ravel(), yq.ravel())[0, 1]
    assert rel < 0.05, rel
    assert corr > 0.995, corr
    # 2 stages x (2 dilations x 2 resblock convs + 2 upsampling convs)
    assert len(int8_convs(genq)) == 12


def test_quant_nsf_generator_runs():
    # in_channels counts the mel alone: f0 and uv ride on as two more
    kw = dict(KW, nsf_params={"nb_harmonics": 4, "sampling_rate": 16000})
    gen, genq = _port_generators(kw)
    rng = np.random.RandomState(1)
    mel = torch.from_numpy(np.concatenate([
        rng.randn(1, 40, 80).astype(np.float32),
        np.abs(rng.randn(1, 40, 1)).astype(np.float32) * 100 + 100,
        np.ones((1, 40, 1), dtype=np.float32)], axis=-1))
    with torch.no_grad():
        y = gen(mel, generator=torch.Generator().manual_seed(2)).numpy()
        yq = genq(mel, generator=torch.Generator().manual_seed(2)).numpy()
    assert y.shape == yq.shape and np.isfinite(yq).all()
    rel = np.linalg.norm(yq - y) / np.linalg.norm(y)
    assert rel < 0.1, rel
    # the source convs stay float32: the edge-layer exemption
    assert not any(n.startswith(("source", "conv_pre", "conv_post"))
                   for n in int8_convs(genq))


def test_quant_batch_composition_invariant():
    """Per-example activation scales: an utterance quantizes identically
    alone and co-batched with louder traffic. The float32 edge convs run on
    PyTorch's own CPU conv: oneDNN's sums an item in an order that depends
    on the batch, which would hide the int8 path's exactness."""
    _, genq = _port_generators()
    mel = torch.from_numpy(_mel(B=1, T=50))
    loud = 50.0 * torch.from_numpy(_mel(B=1, T=50))
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        alone = genq(mel)
        batched = genq(torch.cat([mel, loud]))
    assert torch.equal(alone[0], batched[0])


def test_static_quant_chunked_bit_exact():
    """Static calibrated scales make the quantization input-independent, so
    chunked-batch inference reproduces the whole int8 call bit for bit (the
    float32 edge convs on PyTorch's own CPU conv, as above)."""
    gen, _ = _port_generators()
    genq = Generator(**KW, quant=True, quant_static=True).eval()
    genq.load_state_dict(gen.state_dict(), strict=False)
    quantize_weights(genq)
    mel = torch.from_numpy(_mel(B=1, T=64))
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        scales = calibrate_quant_scales(genq, [mel])
        assert scales and all(float(v) > 0 for v in scales.values())
        full = genq(mel)
        chunked = chunked_apply(genq, mel, 4)
        y32 = gen(mel)
    assert full.shape == chunked.shape
    assert torch.equal(chunked, full)
    rel = float(torch.linalg.vector_norm(full - y32) / torch.linalg.vector_norm(y32))
    assert rel < 0.05, rel


@pytest.fixture(scope="module")
def jax_pair():
    """A JAX generator's params and the port's int8 generator on them."""
    mel = jnp.asarray(_mel())
    params = jax.jit(JGenerator(**KW).init)(jax.random.PRNGKey(0), mel)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return params


def test_int8_generator_matches_jax(jax_pair):
    """Dynamic scales: within 0.25 e_q of JAX's int8 generator; static
    scales: the calibrated scales within 1e-6 relative of JAX's
    ``calibrate_quant_scales``, the static int8 output within 0.25 e_q."""
    params = jax_pair
    mel = _mel()
    y32 = np.asarray(jax.jit(JGenerator(**KW).apply)({"params": params},
                                                     jnp.asarray(mel)))
    y8 = np.asarray(jax.jit(JGenerator(**KW, quant=True).apply)(
        {"params": params}, jnp.asarray(mel)))
    e_q = np.abs(y8 - y32).max()
    assert e_q > 0
    port = Generator(**KW, quant=True).eval()
    port.load_state_dict(hifigan_state_dict_from_jax(params, KW), strict=True)
    quantize_weights(port)
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
    assert np.abs(got - y8).max() <= 0.25 * e_q, (np.abs(got - y8).max(), e_q)

    j_scales = j_calibrate_quant_scales(
        JGenerator(**KW, quant=True, quant_static=True, calibrate=True), params,
        [jnp.asarray(mel[:1]), jnp.asarray(mel[1:])])
    y8s = np.asarray(jax.jit(JGenerator(**KW, quant=True, quant_static=True).apply)(
        {"params": params, "quant": j_scales}, jnp.asarray(mel)))
    static = Generator(**KW, quant=True, quant_static=True).eval()
    static.load_state_dict(hifigan_state_dict_from_jax(params, KW), strict=False)
    quantize_weights(static)
    with torch.no_grad():
        scales = calibrate_quant_scales(
            static, [torch.from_numpy(mel[:1]), torch.from_numpy(mel[1:])])
        got_static = static(torch.from_numpy(mel)).numpy()
    bridged = hifigan_state_dict_from_jax(params, KW, quant=j_scales)
    assert len(scales) == len([k for k in bridged if k.endswith(".s_x")]) == 12
    for name, s in scales.items():
        want = float(bridged[f"{name}.s_x"])
        assert abs(float(s) - want) <= 1e-6 * want, (name, float(s), want)
    assert np.abs(got_static - y8s).max() <= 0.25 * e_q
    # the bridged scales load as the state of a static int8 generator
    static.load_state_dict(bridged, strict=True)


def test_no_weight_norm_generator_matches_jax():
    """``use_weight_norm: false``: plain ``weight`` entries for conv_pre,
    the upsampling convs and conv_post (the residual blocks stay
    weight-normed, as in the JAX generator), bridged, within 1e-5."""
    kw = dict(KW, use_weight_norm=False)
    mel = _mel(B=1, T=21)
    params = jax.jit(JGenerator(**kw).init)(jax.random.PRNGKey(3),
                                            jnp.asarray(mel))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    assert "kernel_g" not in params["conv_pre"]
    want = np.asarray(jax.jit(JGenerator(**kw).apply)({"params": params},
                                                      jnp.asarray(mel)))
    port = Generator(**kw).eval()
    sd = hifigan_state_dict_from_jax(params, kw)
    assert "conv_pre.conv1d.weight" in sd and "conv_post.conv1d.weight" in sd
    assert "transpose_upsamples.0.1.deconv.weight" in sd
    assert "conv_blocks.0.convs1.0.conv1d.weight_v" in sd
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ------------------------------------------------------ the CLI and service

def _write_voc_checkpoints(tmp_path, params, mixed_precision=False):
    """The same weights as a JAX msgpack checkpoint and a port checkpoint."""
    j_ckpt = tmp_path / "ckpt_0.msgpack"
    j_ckpt.write_bytes(serialization.msgpack_serialize(
        {"model": {"generator": params}}))
    config = {"model_type": "hifigan", "Model": {"Generator": {"params": dict(KW)}},
              "audio_config": {"sampling_rate": 16000},
              "mixed_precision": mixed_precision}
    port = Generator(**KW)
    port.load_state_dict(hifigan_state_dict_from_jax(params, KW), strict=True)
    t_ckpt = str(tmp_path / "voc.pt")
    save_checkpoint(t_ckpt, port, config)
    return str(j_ckpt), config, t_ckpt


def test_infer_hifigan_int8_cli_matches_jax(jax_pair, tmp_path, monkeypatch):
    """``infer_hifigan --int8 --device cpu``, alone and with ``--batch 2``,
    against the JAX package's ``hifigan_infer(int8=True)`` within 0.25 e_q;
    the batched run equals the plain one bit for bit. A config with
    ``mixed_precision`` still vocodes in float32 around the int8 convs, as
    the JAX package's loader builds it. ``--chunked`` with ``--int8`` is
    refused. The port's runs use PyTorch's own CPU conv for the float32
    edge convs (see ``test_quant_batch_composition_invariant``)."""
    j_ckpt, config, t_ckpt = _write_voc_checkpoints(tmp_path, jax_pair,
                                                    mixed_precision=True)
    mel_dir = tmp_path / "mels"
    mel_dir.mkdir()
    rng = np.random.RandomState(5)
    lengths = {"a": 37, "b": 120, "c": 64}
    for name, T in lengths.items():
        np.save(mel_dir / f"{name}.npy", rng.randn(T, 80).astype(np.float32))
    from test_torch_port_stream import _capture_wavs

    wavs = _capture_wavs(monkeypatch, j_infer_hifigan)
    j_infer_hifigan.hifigan_infer(str(mel_dir), j_ckpt, str(tmp_path / "j8"),
                                  config=config, int8=True)
    want8 = dict(wavs)
    j_infer_hifigan.hifigan_infer(str(mel_dir), j_ckpt, str(tmp_path / "j32"),
                                  config=config)
    want32 = dict(wavs)
    wavs = _capture_wavs(monkeypatch, infer_hifigan)
    runs = {}
    for name, extra in (("plain", []), ("batch", ["--batch", "2"])):
        with torch.backends.mkldnn.flags(enabled=False):
            infer_hifigan.main(["--ckpt", t_ckpt, "--input_mel", str(mel_dir),
                                "--output_dir", str(tmp_path / name), "--int8",
                                "--device", "cpu", *extra])
        runs[name] = dict(wavs)
    for utt, T in lengths.items():
        e_q = np.abs(want8[utt] - want32[utt]).max()
        got = runs["plain"][utt]
        assert got.shape == want8[utt].shape == (T * HOP,)
        assert np.abs(got - want8[utt]).max() <= 0.25 * e_q, utt
        np.testing.assert_array_equal(runs["batch"][utt], got)
    with pytest.raises(SystemExit, match="mutually exclusive"):
        infer_hifigan.hifigan_infer(str(mel_dir), t_ckpt, str(tmp_path / "o"),
                                    device="cpu", chunked=2, int8=True)


def test_int8_service_answers(slice_models):
    """``TTSService.from_checkpoints(int8=True)`` answers with the int8
    vocoder, within rel 0.05 of the float32 one; ``stream`` refuses it."""
    d = slice_models["ckpt_dir"]
    am, voc = str(d / "am.pt"), str(d / "voc.pt")
    wavs = {}
    for int8 in (False, True):
        svc = TTSService.from_checkpoints(am, voc, int8=int8, frontend="pinyin",
                                          device="cpu")
        try:
            assert svc.generator.quant is int8
            sr, wavs[int8] = svc.synthesize(SERVE_TEXTS[0])
            if int8:
                with pytest.raises(ValueError, match="int8"):
                    next(iter(svc.stream(SERVE_TEXTS[0])))
        finally:
            svc.close()
    assert sr == 16000 and wavs[True].shape == wavs[False].shape
    assert np.isfinite(wavs[True]).all()
    rel = np.linalg.norm(wavs[True] - wavs[False]) / np.linalg.norm(wavs[False])
    assert 0 < rel < 0.05, rel


# ------------------------------------------------- the export-safe BiLSTM

def test_bilstm_export_safe_equals_packed():
    """At ragged lengths (full, partial, 1) the gather-reversal form (taken
    without autograd) equals the packed form (taken with it) within 2e-4,
    zeros at padding included."""
    torch.manual_seed(0)
    lstm = BiLSTM(6, 5).eval()
    x = torch.randn(3, 11, 6)
    lengths = torch.tensor([11, 7, 1])
    with torch.no_grad():
        safe = lstm(x, lengths)
    packed = lstm(x, lengths).detach()
    assert safe.shape == packed.shape == (3, 11, 10)
    np.testing.assert_allclose(safe.numpy(), packed.numpy(), atol=2e-4, rtol=0)
    assert (safe[1, 7:] == 0).all() and (safe[2, 1:] == 0).all()

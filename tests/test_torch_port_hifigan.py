"""HiFi-GAN generator of the PyTorch port against the JAX package, on the same
weights (moved by the weight bridge) and the same numpy mel. f32 waveforms
agree at atol 1e-5."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kantts_tpu.models.hifigan.generator import Generator as JGenerator
from kantts_tpu.models.hifigan.layers import fold_weight_norm as j_fold
from kantts_tpu.utils.torch_convert import convert_hifigan_generator
from kantts_tpu_torch.models.hifigan.generator import Generator
from kantts_tpu_torch.models.hifigan.layers import fold_weight_norm
from kantts_tpu_torch.utils.convert import hifigan_state_dict_from_jax

ATOL = 1e-5


def small_generator_cfg(causal: bool = True) -> dict:
    return dict(in_channels=80, out_channels=1, channels=32, kernel_size=7,
                upsample_scales=(4, 4), upsample_kernal_sizes=(8, 8),
                resblock_kernel_sizes=(3, 7), resblock_dilations=((1, 3), (1, 3, 5)),
                causal=causal, nonlinear_activation="LeakyReLU",
                nonlinear_activation_params={"negative_slope": 0.1})


def _jax_and_port(cfg, seed=0):
    mel = np.random.RandomState(seed).randn(2, 21, 80).astype(np.float32)
    variables = JGenerator(**cfg).init(jax.random.PRNGKey(seed), jnp.asarray(mel))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    port = Generator(**cfg)
    port.load_state_dict(hifigan_state_dict_from_jax(params, cfg), strict=True)
    return mel, params, port.eval()


@pytest.mark.parametrize("causal", [True, False])
def test_generator_matches_jax(causal):
    cfg = small_generator_cfg(causal)
    mel, params, port = _jax_and_port(cfg)
    want = np.asarray(JGenerator(**cfg).apply({"params": params}, jnp.asarray(mel)))
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
    assert got.shape == (2, 21 * 16, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_fold_weight_norm_keeps_the_function():
    cfg = small_generator_cfg()
    mel, params, port = _jax_and_port(cfg, seed=1)
    with torch.no_grad():
        before = port(torch.from_numpy(mel))
        fold_weight_norm(port)
        after = port(torch.from_numpy(mel))
    np.testing.assert_allclose(after.numpy(), before.numpy(), atol=ATOL, rtol=0)
    # the folded weights are the JAX package's folded weights
    folded = hifigan_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, j_fold(params)), cfg)
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(v.numpy(), folded[k].numpy(), atol=1e-6, err_msg=k)


def test_weight_bridge_round_trip():
    cfg = small_generator_cfg()
    _, params, port = _jax_and_port(cfg, seed=2)
    back = convert_hifigan_generator(
        {k: v.numpy() for k, v in port.state_dict().items()}, cfg)
    a = flax.traverse_util.flatten_dict(params)
    b = flax.traverse_util.flatten_dict(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg="/".join(k))


def test_transposed_conv_norms_per_input_channel():
    cfg = small_generator_cfg()
    _, _, port = _jax_and_port(cfg, seed=3)
    deconv = port.transpose_upsamples[0][1].deconv
    assert deconv.weight_v.shape[0] == cfg["channels"]  # (in, out, k)
    norms = torch.linalg.vector_norm(deconv.weight(), dim=(1, 2))
    np.testing.assert_allclose(norms.detach().numpy(),
                               deconv.weight_g.detach().reshape(-1).numpy(),
                               rtol=1e-5)

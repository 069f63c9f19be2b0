"""The plain reference against the port at tiny widths on the CPU, with
the weights the harness makes from the seed."""

import numpy as np
import pytest
import torch

from h100bench.reference import hifigan as ref
from h100bench.weights import seeded_weights
from kantts_tpu_torch.bin.infer_hifigan import bucket_pad, vocode
from kantts_tpu_torch.models.hifigan.generator import Generator
from kantts_tpu_torch.models.hifigan.layers import fold_weight_norm
from tiny_voices import tiny_cfg


def models(config, seed=7):
    p = tiny_cfg(config)["hifigan"]["Model"]["Generator"]["params"]
    w = seeded_weights(ref.param_shapes(p), seed, torch.device("cpu"))
    g = Generator(**p)
    g.load_state_dict(w, strict=True)
    return p, w, fold_weight_norm(g).eval()


def mels(p, lengths, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        m = rng.standard_normal((n, p["in_channels"])).astype(np.float32) - 4.0
        if p.get("nsf_params"):
            f0 = rng.uniform(80, 400, (n, 1)).astype(np.float32)
            uv = (rng.uniform(size=(n, 1)) > 0.3).astype(np.float32)
            m = np.concatenate([m, f0, uv], 1)
        out.append(m)
    return out


def test_weights_are_seeded():
    p = tiny_cfg("voice24k_nsf")["hifigan"]["Model"]["Generator"]["params"]
    a = seeded_weights(ref.param_shapes(p), 2 ** 31 + 3, torch.device("cpu"))
    b = seeded_weights(ref.param_shapes(p), 2 ** 31 + 3, torch.device("cpu"))
    c = seeded_weights(ref.param_shapes(p), 4, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_pre.conv1d.weight_v"], c["conv_pre.conv1d.weight_v"])
    v = a["conv_pre.conv1d.weight_v"]
    assert v.abs().max() <= 1 / np.sqrt(v[0].numel())
    assert torch.allclose(a["conv_pre.conv1d.weight_g"][:, 0, 0], v.flatten(1).norm(dim=1))


@pytest.mark.parametrize("config", ["voice16k_mas", "voice24k_nsf"])
def test_reference_matches_the_port_on_a_padded_batch(config):
    p, w, g = models(config)
    ms = mels(p, [13, 30, 21])
    hop = ref.hop(p)
    x = torch.from_numpy(bucket_pad(ms, 10, 4))
    with torch.inference_mode(), torch.backends.mkldnn.flags(enabled=False):
        got = vocode(g, None, x)[..., 0].numpy()
        want = ref.vocode_utterances([torch.from_numpy(m) for m in ms], w, p,
                                     tuple(x.shape[:2]))
    for m, y, r in zip(ms, got, want):
        r = r.numpy()
        assert r.shape == (m.shape[0] * hop,)
        np.testing.assert_allclose(y[:r.shape[0]], r, atol=2e-6 * np.abs(r).max())


def test_reference_differs_from_a_broken_port():
    """A changed weight moves the reference far beyond the tolerance above."""
    p, w, g = models("voice16k_mas")
    ms = mels(p, [20])
    w2 = dict(w)
    w2["conv_blocks.0.convs1.0.conv1d.bias"] = w["conv_blocks.0.convs1.0.conv1d.bias"] + 0.01
    a = ref.vocode_utterances([torch.from_numpy(ms[0])], w, p)[0]
    b = ref.vocode_utterances([torch.from_numpy(ms[0])], w2, p)[0]
    assert (a - b).abs().max() > 1e-4 * a.abs().max()

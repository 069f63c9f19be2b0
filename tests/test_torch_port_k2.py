"""K2's packed weights on the CPU, at tiny widths: the packing in the order of
the MMA's A fragments is exact and invertible; the plain version computed
from the packed weight equals ``int8_conv_torch`` and the JAX package's int8
conv (C_in off 32, transposed convs causal and not, a kernel that is no
multiple of its stride); the layers pack once, not per call; an int8 export
holds one ``kantts::int8_conv1d`` node a conv and runs as the eager model
does; and K2's wrapper refuses a CPU tensor instead of running it there.

Tolerances: int8 values and int32 sums are integers and equal bit for bit;
the port's float32 output equals ``int8_conv_torch``'s exactly and JAX's
within 1 ulp (JAX may contract the rescale and the bias add into one
rounding), as in ``test_torch_port_quant.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kantts_tpu_torch.models.hifigan.layers as layers
from kantts_tpu_torch.models.builder import init_parameters
from kantts_tpu_torch.models.hifigan.generator import Generator, int8_convs
from kantts_tpu_torch.ops.int8_conv import (
    int8_conv1d,
    int8_conv_cuda,
    int8_conv_packed_torch,
    int8_conv_torch,
    int8_sums_torch,
    pack_weight,
    quantize_sym,
    quantize_weight,
    scales,
    unpack_weight,
)
from test_torch_port_quant import _jax_int8, _layer_pair, _ulp_close

GEOMS = [  # C_in, C_out, k, stride, transposed
    (20, 12, 3, 1, False), (16, 16, 11, 1, False), (36, 40, 7, 1, False),
    (33, 20, 10, 5, True), (64, 32, 4, 2, True), (20, 8, 7, 3, True)]


def _w_q(C_in, C_out, k, transposed, seed=0):
    shape = (C_in, C_out, k) if transposed else (C_out, C_in, k)
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return quantize_weight(torch.from_numpy(w), transposed)


@pytest.mark.parametrize("geom", GEOMS)
def test_pack_weight_is_the_mma_fragment_order(geom):
    """Each byte of the packed weight is the weight the m16n8k32 A fragment
    wants at its lane and register (PTX ISA, mma.m16n8k32 .s8): lane 4g + t,
    register r holds row g + 8 (r % 2) at channels 16 (r // 2) + 4t + e;
    padding is zero; ``unpack_weight`` inverts it."""
    C_in, C_out, k, s, transposed = geom
    w_q, _ = _w_q(C_in, C_out, k, transposed)
    w_p = pack_weight(w_q, transposed, s)
    taps = -(-k // s) * s if transposed else k
    assert w_p.shape == (-(-C_out // 16), taps, -(-C_in // 32), 512)
    assert w_p.dtype == torch.int8 and w_p.is_contiguous()
    M = -(-k // s)
    wp = w_p.numpy()
    wq = w_q.numpy()
    for idx in np.ndindex(wp.shape):
        mi, tap, c, byte = idx
        lane, r, e = byte // 16, byte % 16 // 4, byte % 4
        o = 16 * mi + lane // 4 + 8 * (r % 2)
        ci = 32 * c + 16 * (r // 2) + 4 * (lane % 4) + e
        if transposed:  # phase tap // M, its tap (M - 1 - tap % M)
            j = tap // M + (M - 1 - tap % M) * s
            want = wq[ci, o, j] if o < C_out and ci < C_in and j < k else 0
        else:
            want = wq[o, ci, tap] if o < C_out and ci < C_in else 0
        assert wp[idx] == want, idx
    assert torch.equal(unpack_weight(w_p, C_in, C_out, k, transposed, s), w_q)


CASES = [("conv", True, 3, 1, 2, 20), ("conv", False, 7, 1, 3, 20),
         ("conv", True, 11, 1, 1, 36), ("transposed", True, 10, 5, 1, 20),
         ("transposed", False, 10, 5, 1, 20), ("transposed", False, 4, 2, 1, 36)]


@pytest.mark.parametrize("mode,causal,k,stride,dilation,c_in", CASES)
def test_plain_from_packed_matches_plain_and_jax(mode, causal, k, stride, dilation,
                                                 c_in):
    """The same float32 w and x through JAX's int8 conv and the port's plain
    version from the packed weight: the int32 sums equal JAX's, the output
    equals ``int8_conv_torch``'s bit for bit and the JAX layer's within 1
    ulp; the operator ``kantts::int8_conv1d`` gives the same on the CPU."""
    transposed = mode == "transposed"
    T = 9 if transposed else 23
    j_layer, j_vars, port, w = _layer_pair(transposed, causal, k, stride, dilation,
                                           c_in, 12, seed=k + stride + dilation)
    x = np.random.RandomState(k).randn(2, T, c_in).astype(np.float32) * 3
    pad = (k - stride) // 2 if transposed else (k * dilation - dilation) // 2
    _, _, _, _, acc = _jax_int8(x, w, transposed, causal, k, stride, dilation, pad)
    xt = torch.from_numpy(x.transpose(0, 2, 1).copy())
    pl, pr = (port.padding, port.padding) if transposed else port.pads
    geo = (stride, dilation, pl, pr, transposed, causal)
    w_p = pack_weight(port.w_q, transposed, stride)
    assert torch.equal(port.w_p, w_p)
    w_q = unpack_weight(w_p, c_in, 12, k, transposed, stride)
    s_x = scales(xt, None)
    sums = int8_sums_torch(quantize_sym(xt, s_x[:, None, None]), w_q, *geo)
    np.testing.assert_array_equal(sums.numpy(), acc.transpose(0, 2, 1))
    bias = port.params.bias.detach()
    got = int8_conv_packed_torch(xt, w_p, port.s_w, bias, None, k, *geo)
    assert torch.equal(got, int8_conv_torch(xt, port.w_q, port.s_w, bias, None, *geo))
    want = np.asarray(j_layer.apply(j_vars, jnp.asarray(x)))
    _ulp_close(got.numpy().transpose(0, 2, 1), want)
    op = torch.ops.kantts.int8_conv1d(xt, w_p, port.s_w, bias, None, k, *geo)
    assert torch.equal(op, got)
    s_static = torch.tensor(0.05)
    assert torch.equal(
        int8_conv1d(xt, w_p, port.s_w, bias, s_static, k, *geo),
        int8_conv_torch(xt, port.w_q, port.s_w, bias, s_static, *geo))


KW = dict(in_channels=16, out_channels=1, channels=32, kernel_size=7,
          upsample_scales=(4, 2), upsample_kernal_sizes=(8, 4),
          resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),), causal=True)


def _int8_generator():
    gen = Generator(**KW, quant=True).eval()
    init_parameters(gen, 0)
    return layers.quantize_weights(layers.fold_weight_norm(gen))


def test_weights_are_packed_once(monkeypatch):
    """``quantize_weights`` packs each int8 conv's weight once, into a buffer
    kept out of the state dict; calls do not pack again."""
    gen = _int8_generator()
    convs = int8_convs(gen)
    assert len(convs) == 12
    for name, m in convs.items():
        assert torch.equal(m.w_p, pack_weight(m.w_q, m.transposed, m.stride))
        assert not any(k.endswith("w_p") for k in gen.state_dict()), name
    ptrs = {name: m.w_p.data_ptr() for name, m in convs.items()}
    packs = []

    def counted(*args, **kw):
        packs.append(args)
        return pack_weight(*args, **kw)

    monkeypatch.setattr(layers, "pack_weight", counted)
    mel = torch.from_numpy(np.random.RandomState(1).randn(2, 12, 16).astype(np.float32))
    with torch.no_grad():
        gen(mel)
        gen(mel)
    assert packs == []
    assert {name: m.w_p.data_ptr() for name, m in convs.items()} == ptrs


def test_int8_export_holds_one_node_a_conv():
    """torch.export of an int8 generator: one ``kantts::int8_conv1d`` node
    for each int8 conv, the packed weights in the program's state, and the
    program's output equal to the eager model's."""
    gen = _int8_generator()
    mel = torch.from_numpy(np.random.RandomState(2).randn(1, 10, 16).astype(np.float32))
    with torch.no_grad():
        program = torch.export.export(gen, (mel,))
        want = gen(mel)
    nodes = [n for n in program.graph.nodes
             if n.target is torch.ops.kantts.int8_conv1d.default]
    assert len(nodes) == len(int8_convs(gen)) == 12
    held = {**program.state_dict, **program.constants}
    for name, m in int8_convs(gen).items():
        assert torch.equal(held[f"{name}.w_p"], m.w_p)
    with torch.no_grad():
        assert torch.equal(program.module()(mel), want)


def test_k2_refuses_cpu_tensors():
    """K2's wrapper takes CUDA tensors only: a CPU tensor raises before any
    build, and never runs on the CPU under K2's name."""
    w_q, s_w = _w_q(20, 12, 3, False)
    x = torch.zeros(1, 20, 8)
    launches = int8_conv_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        int8_conv_cuda(x, pack_weight(w_q, False), s_w, None, None, 3, 1, 1, 2, 0,
                       False, True)
    assert int8_conv_cuda.launches == launches and int8_conv_cuda._lib is None

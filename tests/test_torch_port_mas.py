"""MAS (K1's plain version and dispatcher) in the PyTorch port against the
JAX package: the Pallas kernel in interpret mode, the lax.scan version and
the numpy DP. Hard alignments must be equal bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kantts_tpu.models.sambert.alignment import b_mas, mas_width1_np
from kantts_tpu.ops.mas_pallas import b_mas_pallas
from kantts_tpu_torch.models.sambert.alignment import b_mas_torch, mas_align
from kantts_tpu_torch.ops.mas import b_mas_cuda


def _ragged(seed, B, T_mel, T_text):
    rng = np.random.RandomState(seed)
    attn = rng.rand(B, 1, T_mel, T_text).astype(np.float32)
    attn /= attn.sum(-1, keepdims=True)
    in_lens = rng.randint(2, T_text + 1, B).astype(np.int32)
    out_lens = np.maximum(rng.randint(2, T_mel + 1, B), in_lens).astype(np.int32)
    in_lens[0], out_lens[0] = T_text, T_mel
    return attn, in_lens, out_lens


def _uniform_rows(B, T_mel, T_text):
    """Every row uniform: every DP comparison is an exact tie."""
    attn = np.full((B, 1, T_mel, T_text), 1.0 / T_text, dtype=np.float32)
    in_lens = np.array([T_text, T_text // 2, 3][:B], dtype=np.int32)
    out_lens = np.array([T_mel, T_mel - 3, T_mel // 2][:B], dtype=np.int32)
    return attn, in_lens, out_lens


def _port(attn, in_lens, out_lens):
    return b_mas_torch(torch.from_numpy(attn), torch.from_numpy(in_lens),
                       torch.from_numpy(out_lens)).numpy()


@pytest.mark.parametrize("case", ["ragged", "ragged_long", "ties"])
def test_b_mas_torch_equals_jax(case):
    attn, in_lens, out_lens = {
        "ragged": lambda: _ragged(0, 5, 24, 16),
        "ragged_long": lambda: _ragged(1, 3, 61, 23),
        "ties": lambda: _uniform_rows(3, 20, 8),
    }[case]()
    hard = _port(attn, in_lens, out_lens)
    args = (jnp.asarray(attn), jnp.asarray(in_lens), jnp.asarray(out_lens))
    np.testing.assert_array_equal(hard, np.asarray(b_mas(*args)))
    np.testing.assert_array_equal(
        hard, np.asarray(b_mas_pallas(*args, group=2, interpret=True)))
    for b in range(attn.shape[0]):
        o, i = out_lens[b], in_lens[b]
        np.testing.assert_array_equal(hard[b, 0, :o, :i],
                                      mas_width1_np(attn[b, 0, :o, :i]))
        assert hard[b, 0].sum() == o  # one column per valid frame, zero elsewhere


def test_ties_take_the_previous_column():
    attn, in_lens, out_lens = _uniform_rows(1, 10, 4)
    hard = _port(attn, in_lens, out_lens)[0, 0]
    # with every path equal, the backtrack steps back a column at each tie:
    # the path holds column 0 and reaches the last column on the diagonal
    np.testing.assert_array_equal(hard.argmax(-1), [0, 0, 0, 0, 0, 0, 0, 1, 2, 3])


def test_mas_align_on_cpu_runs_the_plain_version():
    attn, in_lens, out_lens = _ragged(2, 2, 12, 6)
    hard = mas_align(torch.from_numpy(attn).requires_grad_(),
                     torch.from_numpy(in_lens), torch.from_numpy(out_lens))
    np.testing.assert_array_equal(hard.numpy(), _port(attn, in_lens, out_lens))
    assert b_mas_cuda.launches == 0


def test_k1_wrapper_refuses_cpu_tensors():
    attn, in_lens, out_lens = (torch.from_numpy(a) for a in _ragged(3, 2, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        b_mas_cuda(attn, in_lens, out_lens)
    assert b_mas_cuda.launches == 0


def _special(case, seed=7, B=5, T_mel=40, T_text=13):
    """Maps with the cells a diverged soft attention can hold, ties, and
    lengths at their edges."""
    rng = np.random.RandomState(seed)
    attn = rng.rand(B, 1, T_mel, T_text).astype(np.float32)
    attn /= attn.sum(-1, keepdims=True)
    in_lens = rng.randint(2, T_text + 1, B).astype(np.int32)
    out_lens = rng.randint(2, T_mel + 1, B).astype(np.int32)
    in_lens[0], out_lens[0] = T_text, T_mel
    if case == "nan":
        attn[0, 0, 5:9, 2:5] = np.nan
        attn[1, 0, 0, 0] = np.nan  # the pinned start cell
        attn[2, 0, 12:, 1] = np.nan
    elif case == "inf_zero_negative":
        attn[0, 0, 3:6, :4] = 0.0
        attn[1, 0, 7, 3] = np.inf
        attn[2, 0, 9:11, 2:6] = -0.5
        attn[3, 0, 4, :] = -np.inf
        attn[4, 0, :, 5] = 0.0
    elif case == "ties":
        attn = np.round(attn * 8) / 8  # few values: ties and zeros everywhere
    elif case == "edge_lengths":
        in_lens[:] = [0, 1, T_text, 1, T_text][:B]
        out_lens[:] = [T_mel, T_mel, 0, 1, 1][:B]
    return attn.astype(np.float32), in_lens, out_lens


@pytest.mark.parametrize("case", ["nan", "inf_zero_negative", "ties", "edge_lengths"])
def test_b_mas_torch_equals_jax_on_special_maps(case):
    """Exact against the JAX package's b_mas, NaN included: a NaN score
    loses every comparison, so the DP takes "stay" as b_mas's where() does."""
    attn, in_lens, out_lens = _special(case)
    args = (jnp.asarray(attn), jnp.asarray(in_lens), jnp.asarray(out_lens))
    np.testing.assert_array_equal(_port(attn, in_lens, out_lens),
                                  np.asarray(b_mas(*args)))


@pytest.mark.parametrize("case", ["inf_zero_negative", "ties", "edge_lengths"])
def test_b_mas_torch_equals_pallas_without_nan(case):
    """The Pallas kernel (interpret mode) agrees wherever there is no NaN;
    its jnp.maximum spreads a NaN that b_mas drops, so NaN maps are held to
    b_mas only."""
    attn, in_lens, out_lens = _special(case)
    args = (jnp.asarray(attn), jnp.asarray(in_lens), jnp.asarray(out_lens))
    np.testing.assert_array_equal(
        _port(attn, in_lens, out_lens),
        np.asarray(b_mas_pallas(*args, group=2, interpret=True)))

"""Port tests that need a CUDA card; they skip without one. This file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_gpu.py
"""

import numpy as np
import pytest
import torch

from kantts_tpu_torch.models.sambert.alignment import b_mas_torch, mas_align
from kantts_tpu_torch.ops.mas import b_mas_cuda

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(5, 24, 16), (3, 130, 1100), (32, 576, 128)])
def test_k1_equals_plain_version(cuda, shape):
    B, T_mel, T_text = shape
    rng = np.random.RandomState(0)
    attn = rng.rand(B, 1, T_mel, T_text).astype(np.float32)
    attn /= attn.sum(-1, keepdims=True)
    in_lens = rng.randint(1, T_text + 1, B).astype(np.int32)
    out_lens = rng.randint(1, T_mel + 1, B).astype(np.int32)
    attn, in_lens, out_lens = (torch.from_numpy(a).to(cuda)
                               for a in (attn, in_lens, out_lens))
    before = b_mas_cuda.launches
    hard = mas_align(attn, in_lens, out_lens)
    torch.cuda.synchronize()
    assert b_mas_cuda.launches == before + 1
    assert torch.equal(hard, b_mas_torch(attn, in_lens, out_lens))


def test_k1_ties(cuda):
    attn = torch.full((2, 1, 20, 8), 1.0 / 8, device=cuda)
    lens = torch.tensor([8, 5], dtype=torch.int32, device=cuda)
    out = torch.tensor([20, 11], dtype=torch.int32, device=cuda)
    assert torch.equal(b_mas_cuda(attn, lens, out), b_mas_torch(attn, lens, out))


def test_k1_refuses_what_it_does_not_take(cuda):
    attn = torch.rand(2, 1, 8, 4, device=cuda)
    lens = torch.tensor([4, 3], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        b_mas_cuda(attn.double(), lens, lens)
    with pytest.raises(ValueError):
        b_mas_cuda(attn.transpose(2, 3).contiguous().transpose(2, 3), lens, lens)
    with pytest.raises(ValueError):
        b_mas_cuda(attn, lens.long(), lens)

"""Port tests that need a CUDA card; they skip without one. This file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_gpu.py
"""

import os

import numpy as np
import pytest
import torch
import yaml

from kantts_tpu_torch.bin.train_hifigan import train as train_hifigan
from kantts_tpu_torch.bin.train_sambert import train
from kantts_tpu_torch.models.builder import load_checkpoint
from kantts_tpu_torch.models.hifigan.generator import Generator
from kantts_tpu_torch.models.sambert.alignment import b_mas_torch, mas_align
from kantts_tpu_torch.ops.mas import b_mas_cuda
from kantts_tpu_torch.utils.corpus import write_mas_corpus, write_voc_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


def test_train_steps_on_the_card_launch_k1(cuda, tmp_path):
    """Three MAS train steps of a narrow sambert_16k_MAS through
    train_sambert on the card: K1 runs in every step and the checkpoint
    loads for serving."""
    with open(os.path.join(ROOT, "kantts_tpu/configs/sambert_16k_MAS.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["Model"]["KanTtsSAMBERT"]["params"].update(
        embedding_dim=64, encoder_num_layers=2, encoder_num_units=32,
        encoder_ffn_inner_dim=64, decoder_num_layers=2, decoder_num_units=32,
        decoder_ffn_inner_dim=64, postnet_fsmn_num_layers=1)
    cfg.update(batch_size=4, num_workers=0, train_max_steps=3,
               save_interval_steps=3, eval_interval_steps=100, log_interval_steps=3)
    path = str(tmp_path / "model.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    data = str(tmp_path / "data")
    write_mas_corpus(data, 12, (20, 30), (90, 150), seed=3)
    before = b_mas_cuda.launches
    trainer = train(path, data, str(tmp_path / "stage"))
    assert trainer.steps_taken == 3
    assert b_mas_cuda.launches - before >= 3
    logged = trainer.history[-1][2]
    assert all(np.isfinite(v) for v in logged.values()), logged
    model, _ = load_checkpoint(str(tmp_path / "stage" / "ckpt" / "checkpoint_3.ckpt"),
                               cuda)
    assert next(model.parameters()).is_cuda


def test_gan_steps_on_the_card(cuda, tmp_path):
    """Three GAN steps of a narrow hifigan_v1_16k (80 mels, hop 200, MPD and
    MSD with spectral norm) through train_hifigan on the card; the
    checkpoint's generator loads for serving."""
    with open(os.path.join(ROOT, "kantts_tpu/configs/hifigan_v1_16k.yaml")) as f:
        cfg = yaml.safe_load(f)
    model = cfg["Model"]
    model["Generator"]["params"].update(channels=32)
    model["MultiScaleDiscriminator"]["params"]["discriminator_params"].update(
        channels=16, max_downsample_channels=64)
    model["MultiPeriodDiscriminator"]["params"]["discriminator_params"].update(
        channels=8, max_downsample_channels=64)
    cfg.update(batch_size=4, batch_max_steps=2400, num_workers=0, train_max_steps=3,
               save_interval_steps=3, eval_interval_steps=100, log_interval_steps=3)
    path = str(tmp_path / "model.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    data = str(tmp_path / "data")
    write_voc_corpus(data, 8, (0.5, 0.8), seed=3)
    trainer = train_hifigan(path, data, str(tmp_path / "stage"))
    assert trainer.steps_taken == 3
    logged = trainer.history[-1][2]
    assert all(np.isfinite(v) for v in logged.values()), logged
    model, _ = load_checkpoint(str(tmp_path / "stage" / "ckpt" / "checkpoint_3.ckpt"),
                               cuda)
    assert isinstance(model, Generator) and next(model.parameters()).is_cuda

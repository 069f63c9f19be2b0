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
from kantts_tpu_torch.losses import criterion_builder
from kantts_tpu_torch.models.builder import hifigan_gan_builder, load_checkpoint
from kantts_tpu_torch.models.hifigan.generator import Generator
from kantts_tpu_torch.models.sambert.alignment import b_mas_torch, mas_align
from kantts_tpu_torch.ops.mas import b_mas_cuda
from kantts_tpu_torch.train.steps import make_gan_step
from kantts_tpu_torch.utils.corpus import write_mas_corpus, write_voc_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(5, 24, 16), (3, 130, 1100), (32, 576, 128),
                                   (3, 70, 97), (2, 300, 800), (9, 50, 257)])
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


def _special(case, B, T_mel, T_text, seed=7):
    """NaN, +-inf, zero and negative cells, a map of few values (ties
    everywhere), and lengths of 0, 1 and the full size."""
    rng = np.random.RandomState(seed)
    attn = rng.rand(B, 1, T_mel, T_text).astype(np.float32)
    attn /= attn.sum(-1, keepdims=True)
    in_lens = rng.randint(1, T_text + 1, B).astype(np.int32)
    out_lens = rng.randint(1, T_mel + 1, B).astype(np.int32)
    in_lens[0], out_lens[0] = T_text, T_mel
    if case == "nan":
        attn[0, 0, 5:9, 2:5] = np.nan
        attn[1, 0, 0, 0] = np.nan
        attn[2, 0, T_mel // 3:, 1] = np.nan
    elif case == "inf_zero_negative":
        attn[0, 0, 3:6, :4] = 0.0
        attn[1, 0, 7, 3] = np.inf
        attn[2, 0, 9:11, 2:6] = -0.5
        attn[3, 0, 4, :] = -np.inf
    elif case == "ties":
        attn = np.round(attn * T_text / 2) / (T_text / 2)
    elif case == "edge_lengths":
        in_lens[:5] = [0, 1, T_text, 1, T_text]
        out_lens[:5] = [T_mel, T_mel, 0, 1, 1]
    return attn.astype(np.float32), in_lens, out_lens


@pytest.mark.parametrize("shape,variant", [
    (shape, variant) for shape in ((5, 40, 13), (9, 70, 97), (6, 33, 1000))
    for variant in (0, 1, 2)] + [((5, 30, 1100), 0)])
@pytest.mark.parametrize("case", ["nan", "inf_zero_negative", "ties", "edge_lengths"])
def test_k1_special_maps(cuda, case, shape, variant):
    """Both variants (0: the library's choice, 1: warp, 2: block) bit-equal
    to b_mas_torch on NaN, +-inf, zero, negative, tie and edge-length maps,
    at widths that are not multiples of 32 and odd batches."""
    attn, in_lens, out_lens = (torch.from_numpy(a).to(cuda)
                               for a in _special(case, *shape))
    hard = b_mas_cuda(attn, in_lens, out_lens, variant=variant)
    torch.cuda.synchronize()
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
    MSD with spectral norm) through train_hifigan on the card, the last two
    replayed from the step's CUDA graph; the checkpoint's generator loads
    for serving, and its whole training state, saved after the capture,
    loads on the CPU in the plain format and takes a step there. Resumed
    on the card, the run captures again on its own second step."""
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
    path = str(tmp_path / "stage" / "ckpt" / "checkpoint_3.ckpt")
    model, _ = load_checkpoint(path, cuda)
    assert isinstance(model, Generator) and next(model.parameters()).is_cuda
    assert trainer.step_fn().graph_stats == {"captures": 1, "replays": 2, "eager": 1}
    payload = torch.load(path, map_location="cpu", weights_only=True)
    opts = [payload["optimizer"]["generator"], *payload["optimizer"]["discriminator"].values()]
    for opt in opts:
        assert all(not g["capturable"] and isinstance(g["lr"], float)
                   for g in opt["param_groups"])
        assert all(st["step"].device.type == "cpu" and float(st["step"]) == 3
                   for st in opt["state"].values())
    cpu = hifigan_gan_builder(trainer.config, 1, torch.device("cpu"))
    cpu["generator"].load_state_dict(payload["model"]["generator"])
    cpu["gen_optimizer"].load_state_dict(payload["optimizer"]["generator"])
    cpu["gen_scheduler"].load_state_dict(payload["scheduler"]["generator"])
    for name, disc in cpu["discriminators"].items():
        disc.load_state_dict(payload["model"]["discriminator"][name])
        cpu["disc_optimizers"][name].load_state_dict(payload["optimizer"]["discriminator"][name])
        cpu["disc_schedulers"][name].load_state_dict(payload["scheduler"]["discriminator"][name])
    step = make_gan_step(cpu["generator"], cpu["discriminators"],
                         criterion_builder(trainer.config), cpu["gen_optimizer"],
                         cpu["gen_scheduler"], cpu["disc_optimizers"], cpu["disc_schedulers"],
                         cpu["gen_clip"], cpu["disc_clips"])
    wav, mel = torch.rand(2, 2400, 1) - 0.5, torch.randn(2, 12, 80)
    assert all(torch.isfinite(v) for v in step(wav, mel).values())
    assert step.graph_stats["eager"] == 1
    cfg["train_max_steps"] = 5
    with open(str(tmp_path / "model.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    again = train_hifigan(str(tmp_path / "model.yaml"), data, str(tmp_path / "resumed"),
                          resume_path=path, resume_training_state=True)
    assert again.steps_taken == 2 and again.gen_scheduler.last_epoch == 5
    assert again.step_fn().graph_stats == {"captures": 1, "replays": 1, "eager": 1}
    assert float(again.gen_optimizer.state_dict()["state"][0]["step"]) == 5


def _graph_config(variant: str) -> dict:
    """hifigan_v1_16k at the widths of ``test_gan_steps_on_the_card``, each
    schedule halving the rate after every update; ``pqmf``: four sub-bands
    (5x5x2), MultiSpecDiscriminator and the sub-band STFT loss; ``bf16``:
    ``mixed_precision``."""
    with open(os.path.join(ROOT, "kantts_tpu_torch/resources/configs/hifigan_v1_16k.yaml")) as f:
        cfg = yaml.safe_load(f)
    model = cfg["Model"]
    model["Generator"]["params"].update(channels=32)
    model["MultiScaleDiscriminator"]["params"]["discriminator_params"].update(
        channels=16, max_downsample_channels=64)
    model["MultiPeriodDiscriminator"]["params"]["discriminator_params"].update(
        channels=8, max_downsample_channels=64)
    if variant == "pqmf":
        model["Generator"]["params"].update(out_channels=4, upsample_scales=[5, 5, 2],
                                            upsample_kernal_sizes=[10, 10, 4])
        model["MultiSpecDiscriminator"] = {"params": {},
                                           "optimizer": model["Generator"]["optimizer"]}
        cfg["Loss"]["subband_stft_loss"]["enable"] = True
    if variant == "bf16":
        cfg["mixed_precision"] = True
    for net in model.values():
        net["scheduler"] = {"type": "MultiStepLR",
                            "params": {"gamma": 0.5, "milestones": [1, 2, 3, 4, 5, 6]}}
    return cfg


# Largest relative loss gap and absolute parameter gap over the steps, with
# cuDNN deterministic and TF32 off. Found in three runs on an NVIDIA H100
# 80GB HBM3: float32 losses 8.2e-8-1.2e-7, parameters 6.0e-8-7.3e-7; pqmf
# 9.6e-8-2.0e-7, 8.4e-8-5.6e-7; bf16 0-1.5e-4, 6.0e-8-1.1e-5. float32
# round-off (the graph's Adam computes its step size on the device, and
# ATen's atomic adds sum in no fixed order), which Adam lifts to ~lr on an
# element whose gradient is round-off alone; bf16's round-off is 3.9e-3.
GRAPH_BOUNDS = {
    "float32": {"loss": 1e-6, "param": 5e-6},
    "pqmf": {"loss": 1e-6, "param": 5e-6},
    "bf16": {"loss": 2e-3, "param": 1e-4},
}


@pytest.mark.parametrize("variant", list(GRAPH_BOUNDS))
def test_gan_graph_replays_the_eager_step(cuda, variant):
    """Two copies of one GAN from the same weights: one steps through
    ``step.eager`` (the eager step the graph captures), the other as the
    trainer and the benchmark call it, which warms up, captures on its
    second call and replays. Five steps on the same batches under a rate
    that halves every step, then a batch of another shape (eager) and one
    of the first shape again (a replay). The losses and the parameters
    agree within ``GRAPH_BOUNDS``; the counter reads one warm-up, one
    capture and four replays after five steps; metrics held from step 2
    are unchanged after step 5; every rate followed its schedule."""
    cfg = _graph_config(variant)
    gen = torch.Generator(device=cuda).manual_seed(5)
    batches = [(torch.rand(4, 2400, 1, device=cuda, generator=gen) - 0.5,
                torch.randn(4, 12, 80, device=cuda, generator=gen)) for _ in range(6)]
    batches.insert(5, (batches[0][0][:2], batches[0][1][:2]))
    copies, steps = {}, {}
    for how in ("eager", "graph"):
        b = copies[how] = hifigan_gan_builder(cfg, 0, cuda)
        step = make_gan_step(b["generator"], b["discriminators"], criterion_builder(cfg),
                             b["gen_optimizer"], b["gen_scheduler"], b["disc_optimizers"],
                             b["disc_schedulers"], b["gen_clip"], b["disc_clips"],
                             pqmf=b["pqmf"])
        steps[how] = step.eager if how == "eager" else step
    got = {how: [] for how in steps}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for k, (wav, mel) in enumerate(batches):
            for how, step in steps.items():
                got[how].append(step(wav, mel))
            if k == 1:
                held = {key: v.clone() for key, v in got["graph"][1].items()}
            if k == 4:
                torch.cuda.synchronize()
                assert steps["graph"].graph_stats == {"captures": 1, "replays": 4,
                                                      "eager": 1}
                assert all(torch.equal(got["graph"][1][key], v) for key, v in held.items())
    torch.cuda.synchronize()
    assert steps["graph"].graph_stats == {"captures": 1, "replays": 5, "eager": 2}
    bound = GRAPH_BOUNDS[variant]
    loss_gap = max(float((a[key].float() - b[key].float()).abs() / b[key].float().abs())
                   for a, b in zip(got["graph"], got["eager"]) for key in b)
    nets = {how: [c["generator"], *c["discriminators"].values()]
            for how, c in copies.items()}
    param_gap = max(float((p.detach().float() - q.detach().float()).abs().max())
                    for g, e in zip(nets["graph"], nets["eager"])
                    for p, q in zip(g.parameters(), e.parameters()))
    print(f"[graph_vs_eager] {variant}: loss_gap {loss_gap:.3e} param_gap {param_gap:.3e}")
    assert loss_gap <= bound["loss"] and param_gap <= bound["param"]
    for how, c in copies.items():
        for opt in (c["gen_optimizer"], *c["disc_optimizers"].values()):
            assert opt.param_groups[0]["lr"] == pytest.approx(2e-4 * 0.5 ** 6), how
            assert isinstance(opt.param_groups[0]["lr"], float)


@pytest.mark.parametrize("geom", [
    dict(transposed=False, causal=True, k=7, stride=1, dilation=5, pl=30, pr=0, T=333),
    dict(transposed=False, causal=False, k=11, stride=1, dilation=3, pl=15, pr=15, T=65),
    dict(transposed=False, causal=True, k=3, stride=1, dilation=1, pl=2, pr=0, T=1),
    dict(transposed=True, causal=True, k=20, stride=10, dilation=1, pl=5, pr=5, T=41),
    dict(transposed=True, causal=False, k=4, stride=2, dilation=1, pl=1, pr=1, T=130),
    dict(transposed=True, causal=False, k=7, stride=3, dilation=1, pl=2, pr=2, T=50),
    dict(transposed=False, causal=False, k=3, stride=2, dilation=1, pl=1, pr=1, T=99),
    dict(transposed=False, causal=True, k=11, stride=1, dilation=7, pl=70, pr=0, T=4000,
         c_in=128, c_out=128),
    dict(transposed=False, causal=True, k=7, stride=1, dilation=1, pl=6, pr=0, T=3000,
         c_in=256, c_out=128),
    dict(transposed=True, causal=True, k=20, stride=10, dilation=1, pl=5, pr=5, T=400,
         c_in=256, c_out=128),
    dict(transposed=False, causal=True, k=11, stride=1, dilation=5, pl=50, pr=0,
         T=80000, c_in=16, c_out=16),
    dict(transposed=False, causal=True, k=3, stride=1, dilation=1, pl=2, pr=0, T=40,
         B=70),
])
def test_k2_equals_plain_version(cuda, geom):
    """K2 against ``int8_conv_torch`` on the card, exact: the scales, the
    int32 sums and the float32 outputs, dynamic and static scales, from the
    packed weight; through the function the layers call, which counts one
    launch."""
    from kantts_tpu_torch.ops.int8_conv import (
        int8_conv1d,
        int8_conv_cuda,
        int8_conv_torch,
        int8_sums_torch,
        pack_weight,
        quantize_sym,
        quantize_weight,
        scales,
    )

    rng = np.random.RandomState(geom["k"])
    c_in, c_out, k = geom.get("c_in", 36), geom.get("c_out", 20), geom["k"]
    w_shape = (c_in, c_out, k) if geom["transposed"] else (c_out, c_in, k)
    w_q, s_w = quantize_weight(torch.from_numpy(rng.randn(*w_shape).astype(np.float32))
                               .to(cuda), geom["transposed"])
    w_p = pack_weight(w_q, geom["transposed"], geom["stride"])
    bias = torch.from_numpy(rng.randn(c_out).astype(np.float32)).to(cuda)
    B = geom.get("B", 3)  # 70: past the 64 scales a block holds at a time
    x = torch.from_numpy(rng.randn(B, c_in, geom["T"]).astype(np.float32)).to(cuda)
    args = (geom["stride"], geom["dilation"], geom["pl"], geom["pr"], geom["transposed"],
            geom["causal"])
    for s_static in (None, torch.tensor(0.02, device=cuda)):
        s_x = scales(x, s_static)
        s_got = torch.empty(B, device=cuda)
        sums = int8_conv_cuda(x, w_p, s_w, bias, s_static, k, *args, sums=True,
                              s_out=s_got)
        want = int8_sums_torch(quantize_sym(x, s_x[:, None, None]), w_q, *args)
        assert torch.equal(s_got, s_x)
        assert torch.equal(sums, want)
        before = int8_conv_cuda.launches
        out = int8_conv1d(x, w_p, s_w, bias, s_static, k, *args)
        torch.cuda.synchronize()
        assert int8_conv_cuda.launches == before + 1
        assert torch.equal(out, int8_conv_torch(x, w_q, s_w, bias, s_static, *args))

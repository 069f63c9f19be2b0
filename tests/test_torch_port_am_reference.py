"""The port's SAM-BERT + MAS train step against the benchmark's plain
reference (``h100bench/reference/sambert.py``), at TINY widths on the CPU,
and the step's spans.

Three steps of ``make_sambert_step(with_mas=True)`` on batches of the
benchmark's synthetic MAS corpus, from the NoamLR update the benchmark
resumes at, with dropout live. At each step the reference starts from the
program's weights, replays the masks the program drew (recorded below
autograd, ``paths/am_train.py::Drawn``) and takes its hard path from the
plain Viterbi of the program's soft map; everything continuous it computes
itself. Then its Adam, fed the program's clipped gradients, must land on
the program's new weights. Started from the program's weights, no step
compares two trajectories that drifted apart by round-off: the L1 losses'
kinks (an element of the decoder's output within 1e-7 of its target) would
let round-off pick the sign of that element's gradient. Tolerances: each
loss rtol 1e-5 (float32 sums in other orders: the gate-by-gate LSTMs, CTC
in float64 on the reference's side); each leaf's clipped gradient
max|diff| <= 1e-4 x max|g| of the leaf; the weights after each update
within two float32 roundings (rtol 2.5e-7, atol 1e-7: torch's Adam forms
the update in another order; the update itself is ~3.6e-4 an element).
"""

import os

import pytest
import torch

from h100bench.am_corpus import write_mas_corpus
from h100bench.paths.am_train import Drawn
from h100bench.reference import sambert as ref
from h100bench.tests.tiny_am import tiny_am_cfg
from kantts_tpu_torch.data.dataset import DataLoader, DistributedSampler, get_am_datasets
from kantts_tpu_torch.losses import criterion_builder
from kantts_tpu_torch.models.builder import sambert_model_builder
from kantts_tpu_torch.models.sambert.alignment import b_mas_torch
from kantts_tpu_torch.train.steps import make_sambert_step
from kantts_tpu_torch.train.trainer import batch_to_device
from kantts_tpu_torch.utils import profiling
from test_torch_port_tools import (  # noqa: F401 - torch_one_thread is a fixture
    cpu_profile,
    recorded_spans,
    torch_one_thread,
)

EPOCH, FIRST_UPDATE = 100, 31200  # the benchmark cell's: past the KL ramp


def tiny_config() -> dict:
    """sambert_16k_MAS as the benchmark runs it (every dropout at its
    published rate), at TINY widths and B=4."""
    return dict(tiny_am_cfg()["sambert"], batch_size=4)


def batches(root: str, config: dict, n: int, seed: int):
    write_mas_corpus(root, 16, (5, 9), (30, 50), 80, seed)
    train_set, _ = get_am_datasets([os.path.join(root, "raw_metafile.txt")], [root],
                                   config, input_bucket=4, frame_bucket=12)
    loader = DataLoader(train_set, 4, sampler=DistributedSampler(len(train_set), seed=seed))
    return [b for b, _ in zip(loader, range(n))]


def program(config: dict, seed: int):
    torch.manual_seed(seed)
    built = sambert_model_builder(config, seed)
    sched = built["scheduler"]
    sched.last_epoch = FIRST_UPDATE
    for group, base, factor in zip(built["optimizer"].param_groups, sched.base_lrs,
                                   sched.lr_lambdas):
        group["lr"] = base * factor(FIRST_UPDATE)
    step = make_sambert_step(built["model"], criterion_builder(config), built["optimizer"],
                             sched, built["clip"], with_mas=True)
    return built["model"], step


@pytest.mark.parametrize("seed", [3, 11])
def test_sambert_mas_step_matches_the_reference(tmp_path, torch_one_thread, seed):
    config = tiny_config()
    model, step = program(config, seed)
    params = dict(model.named_parameters())
    seen = {}
    model.register_forward_hook(lambda m, a, res: seen.update(
        soft=res["attn_soft"].detach(), path=res["attn_hard"]))
    reference = ref.SambertReference(config, params, FIRST_UPDATE)
    for k, batch in enumerate(batches(str(tmp_path), config, 3, seed)):
        reference.w = {n: p.detach().clone() for n, p in params.items()}
        with Drawn() as drawn:
            metrics = step(batch_to_device(batch, torch.device("cpu")), EPOCH)
        grads = {n: p.grad.clone() for n, p in params.items() if p.grad is not None}
        b = {key: torch.from_numpy(v) for key, v in batch.items() if v is not None}
        out = reference.gradients(b, EPOCH, ref.Dropout(drawn.masks), path_soft=seen["soft"])
        assert torch.equal(out["path"], seen["path"])
        for key in ref.LOSSES:
            torch.testing.assert_close(metrics[key], out["losses"][key], rtol=1e-5, atol=0)
        assert set(grads) == set(out["grads"]) == set(params)
        for n, g in grads.items():
            want = out["grads"][n]
            assert (g - want).abs().max() <= 1e-4 * want.abs().max(), (k, n)
        reference.opt.step(reference.w, grads)
        for n, p in params.items():
            torch.testing.assert_close(p.detach(), reference.w[n], rtol=2.5e-7, atol=1e-7,
                                       msg=f"step {k + 1}: {n}")


def _tie_maps():
    """(attn, in_lens, out_lens) with ties everywhere (flat and coarsely
    quantized maps), at edge lengths, and plain random ones."""
    gen = torch.Generator().manual_seed(0)
    B, T_mel, T_text = 6, 23, 9
    in_lens = torch.tensor([9, 1, 5, 9, 3, 7])
    out_lens = torch.tensor([23, 4, 5, 9, 23, 17])
    flat = torch.full((B, 1, T_mel, T_text), 1.0 / T_text)
    levels = torch.randint(0, 3, (B, 1, T_mel, T_text), generator=gen).float() / 4 + 0.25
    noisy = torch.rand((B, 1, T_mel, T_text), generator=gen)
    soft = torch.softmax(torch.randn((B, 1, T_mel, T_text), generator=gen) * 1e-3, -1)
    return [(m, in_lens, out_lens) for m in (flat, levels, noisy, soft)]


@pytest.mark.parametrize("case", range(4), ids=["flat", "levels", "random", "near_flat"])
def test_b_mas_torch_is_the_reference_viterbi(case):
    """Exact, ties included: a tie comes from the column before."""
    attn, in_lens, out_lens = _tie_maps()[case]
    got = b_mas_torch(attn, in_lens, out_lens)
    assert torch.equal(got, ref.viterbi(attn, in_lens, out_lens))
    assert torch.equal(got.sum(-1)[:, 0], (torch.arange(attn.shape[2])[None]
                                            < out_lens[:, None]).float())


def test_am_step_opens_its_spans(tmp_path, monkeypatch, torch_one_thread):
    """One train call under a CPU profiler: one ``kantts.am.step``, its five
    phases inside it in order, and the model's parts inside the forward;
    with no profiler, no record-function region is entered."""
    config = tiny_config()
    _, step = program(config, 5)
    batch, = batches(str(tmp_path), config, 1, 5)
    batch = batch_to_device(batch, torch.device("cpu"))
    with monkeypatch.context() as m:
        def refuse(name):
            raise AssertionError(f"record_function({name!r}) entered with no profiler")
        m.setattr(torch.profiler, "record_function", refuse)
        step(batch, EPOCH)
    with cpu_profile() as prof:
        step(batch, EPOCH)
    spans = recorded_spans(prof, "kantts.am.")
    (_, t0, t1), = [s for s in spans if s[0] == profiling.AM_STEP]
    phases = [s for s in spans if s[0] in profiling.AM_PHASES]
    assert [s[0] for s in phases] == list(profiling.AM_PHASES)
    assert all(t0 <= a and b <= t1 for _, a, b in phases)
    (_, f0, f1), = [s for s in phases if s[0] == profiling.AM_FORWARD]
    parts = (profiling.AM_ENCODER, profiling.AM_MAS, profiling.AM_VARIANCE_ADAPTOR,
             profiling.AM_DECODER, profiling.AM_POSTNET)
    inner = [s for s in spans if s[0] in parts]
    assert [s[0] for s in inner] == list(parts)
    assert all(f0 <= a and b <= f1 for _, a, b in inner)

"""The AM training cell, ``voice16k_mas.am_train_b32``, on the CPU at TINY
widths: its files are found by name, the program is correct and each fault
of ``am_faults.py`` is not (the control, the reference in TF32, only
differs on a card: ``test_h100bench_control.py``), a traced run reports
its host-clock metrics; and its readers on synthetic Chrome events, which
read nothing where the program opens no ``kantts.am.*`` span.

The runs hold the program to the card's limits at TINY widths, and any
seed does: over 40 seeds drawn from [2**31, 2**32) its largest readings
were 1.96e-7 (first_loss_gap), 7.9e-7 (grad_gap) and 1.5e-7
(median_change_gap) against 1e-6, 1e-4 and 3e-4, and the CPU's path
(``b_mas_torch``) never differed from the plain Viterbi's. ``leaf_frozen``
leaves the losses as they were: ``grad_gap`` reads 0.39-0.75 (3 seeds).
``tests/test_torch_port_am_reference.py`` compares the step element by
element from the program's own weights."""

import copy
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from h100bench import harness
from h100bench.am_faults import FAULTS
from h100bench.devtrace import CALL_SPAN, Trace, Traced
from test_h100bench_spans import dev, ev, rt
from tiny_am import tiny_am_cfg
from tiny_voices import load

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "voice16k_mas.am_train_b32"
SPAN_METRICS = ("am_step.device_ms_per_step", "am_step.launches_per_step",
                "am_step.host_syncs_per_step", "am_step.mas_device_share")
def tiny_am_mix() -> dict:
    mix = copy.deepcopy(load("traffic", "am_train_b32.json"))
    mix.update(batch=4, input_bucket=4, frame_bucket=12, num_workers=2,
               corpus={"utterances": 12, "symbols": [5, 9], "frames": [30, 50]})
    return mix


def run(prepare=None, trace=False, seed=2 ** 31 + 96):
    return harness.run_cell(CELL, seed, 0.3, trace, torch.device("cpu"), 0.0,
                            cfg=tiny_am_cfg(), mix=tiny_am_mix(), prepare=prepare)


def test_the_cells_files_are_found_by_name():
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = next(w for w in spec["workloads"] if w["name"] == CELL)
    mix = load("traffic", f"{entry['traffic']}.json")
    assert mix["path"] == "am_train" and mix["batch"] == 32
    limits = load("workloads", f"{CELL}.json")["limits"]
    assert set(limits) == {"first_loss_gap", "grad_gap", "median_change_gap",
                           "mas_path_cells"} and limits["mas_path_cells"] == 0
    mine = [m["name"] for m in spec["per_layer"] if CELL in m.get("workloads", ())]
    assert set(mine) == {*SPAN_METRICS, "am_train.mfu", "k1_roofline",
                         "loader_wait_share.am_train", "device_idle_share.am_train"}
    for name in mine:
        harness.reader(name)


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_faults_come_out_not_correct(fault):
    r = run(FAULTS[fault] if fault else None)
    assert r["correct"] is (fault is None), r["checks"]
    assert set(r["checks"]) == set(load("workloads", f"{CELL}.json")["limits"])
    assert set(r["metrics"]) == {"gan_train_audio_s_per_s", "setup_s"}
    if fault == "path_flipped":
        assert r["checks"]["mas_path_cells"]["value"] >= 1


def test_traced_run_reports_its_host_clock_metrics():
    """On the CPU the trace holds no launch: the span and device readers
    read nothing, and the line leaves them out."""
    r = run(trace=True, seed=2 ** 31 + 95)
    assert r["correct"]
    assert set(r["metrics"]) == {"am_train.mfu", "loader_wait_share.am_train"}
    assert 0 < r["metrics"]["am_train.mfu"]["value"] < 100


def read(metric, events, cell=None):
    tr = Trace(events)
    return harness.reader(metric)(SimpleNamespace(trace=Traced(tr, tr), cell=cell))


def am_events():
    """Two AM steps, 0-100 and 200-300 us, inside the harness's call spans;
    in each a MAS span around one K1 call (score and Viterbi kernels);
    step 1 launches on autograd's thread too; step 2 copies a length to
    pageable memory and synchronises."""
    events = [
        ev("user_annotation", CALL_SPAN, 0, 150), ev("user_annotation", CALL_SPAN, 150, 200),
        ev("user_annotation", "kantts.am.step", 0, 100),
        ev("user_annotation", "kantts.am.step", 200, 100),
        ev("user_annotation", "kantts.am.mas", 5, 30),
        ev("user_annotation", "kantts.am.mas", 205, 30),
        rt("cudaLaunchKernel", 10, 1), rt("cudaLaunchKernel", 12, 2),
        rt("cudaLaunchKernel", 50, 3, tid=2),
        rt("cudaLaunchKernel", 210, 4), rt("cudaLaunchKernel", 212, 5),
        rt("cudaMemcpyAsync", 250, 6), rt("cudaStreamSynchronize", 260, 7),
        dev("kernel", "void (anonymous namespace)::mas_score_kernel(..)", 14, 4, 1),
        dev("kernel", "void (anonymous namespace)::mas_warp_kernel<8>(..)", 18, 16, 2),
        dev("kernel", "k_backward", 52, 30, 3),
        dev("kernel", "void (anonymous namespace)::mas_score_kernel(..)", 214, 4, 4),
        dev("kernel", "void (anonymous namespace)::mas_warp_kernel<8>(..)", 218, 16, 5),
        dev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 252, 10, 6),
    ]
    return events


def test_am_step_metrics_average_two_steps():
    ms, launches, syncs, mas = (read(m, am_events()) for m in SPAN_METRICS)
    assert launches == 5 / 2
    assert ms == pytest.approx((20 + 30 + 20 + 10) / 1e3 / 2)
    assert syncs == 2 / 2  # the pageable copy and the synchronise of step 2
    assert mas == pytest.approx(100 * 40 / 80)


def test_k1_roofline_recounts_the_launches():
    cell = SimpleNamespace(k1_launches=[2, 2], k1_shape=(32, 576, 96))
    got = read("k1_roofline", am_events(), cell)
    least = 2 * 4 * 32 * 576 * 96 / 3.35e12
    assert got == pytest.approx(100 * least / 20e-6)
    assert read("k1_roofline", am_events(), SimpleNamespace(k1_launches=[3, 3],
                                                            k1_shape=(32, 576, 96))) is None


def test_no_am_span_or_no_card_reads_nothing():
    """The parent's program opens no ``kantts.am.*`` span; a CPU trace has no
    launch and no kernel; a cell that counted no K1 launch reads no roofline."""
    no_span = [e for e in am_events() if not e["name"].startswith("kantts.am.")]
    cpu = [e for e in am_events() if e["cat"] == "user_annotation"]
    for metric in SPAN_METRICS:
        assert read(metric, no_span) is None and read(metric, cpu) is None
    for metric in ("k1_roofline", "device_idle_share.am_train"):
        assert read(metric, cpu, SimpleNamespace(k1_launches=[2])) is None
    assert read("k1_roofline", am_events(), SimpleNamespace()) is None


def test_am_path_imports_no_jax():
    probe = ("import json, sys; sys.path.insert(0, {root!r}); "
             "from h100bench.paths import am_train; import h100bench.am_faults; "
             "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))")
    out = subprocess.run([sys.executable, "-c", probe.format(root=ROOT)],
                         capture_output=True, text=True, timeout=300, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "kantts_tpu_torch" in tops and not tops & set(harness.FORBIDDEN)

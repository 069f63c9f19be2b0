"""A whole run on the CPU at tiny widths, the look for a card skipped:
sound, it is correct; with the timed path broken underneath, it is not.
And the command itself refuses to run without a card."""

import os
import subprocess
import sys

import pytest
import torch

from h100bench import harness
from h100bench.faults import FAULTS
from tiny_voices import tiny_cfg, tiny_gan_cfg, tiny_gan_mix, tiny_mix

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = [("voice16k_mas.vocode_b16", "voice16k_mas", "vocode_b16"),
         ("voice24k_nsf.vocode_b4", "voice24k_nsf", "vocode_b4")]


def run(cell, config, mix, prepare=None, trace=False):
    return harness.run_cell(cell, 2 ** 31 + 99, 0.5, trace, torch.device("cpu"), 0.0,
                            cfg=tiny_cfg(config), mix=tiny_mix(mix), prepare=prepare)


@pytest.mark.parametrize("cell,config,mix", CELLS)
@pytest.mark.parametrize("fault", [None, *FAULTS["vocode"].values()])
def test_faults_come_out_not_correct(cell, config, mix, fault):
    r = run(cell, config, mix, fault)
    gap = r["checks"]["wav_gap"]
    assert r["correct"] is (fault is None), gap
    assert (r["failed"] == 0) is (fault is None)
    assert list(r)[-1] == "checks" and r["attempted"] > 0


@pytest.mark.parametrize("cell,config,mix", CELLS)
def test_traced_run_reports_the_cells_per_layer_metrics(cell, config, mix):
    r = run(cell, config, mix, trace=True)
    assert r["correct"]
    names = set(r["metrics"])
    assert {"vocode.pad_share", "vocode.mfu"} <= names
    assert 0 < r["metrics"]["vocode.pad_share"]["value"] < 100
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "h100bench/run.py", "--workload",
                        CELLS[0][0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


@pytest.mark.parametrize("fault", [None, *FAULTS["gan_train"].values()])
def test_gan_faults_come_out_not_correct(fault):
    r = harness.run_cell("voice16k_mas.gan_train_b16", 2 ** 31 + 98, 0.5, False,
                         torch.device("cpu"), 0.0, cfg=tiny_gan_cfg(),
                         mix=tiny_gan_mix(), prepare=fault)
    assert r["correct"] is (fault is None), r["checks"]
    limits = harness.load_json(os.path.join(
        ROOT, "h100bench", "workloads", "voice16k_mas.gan_train_b16.json"))["limits"]
    assert set(r["checks"]) == set(limits)
    assert set(r["metrics"]) == {"gan_train_audio_s_per_s", "setup_s"}


def test_traced_gan_run_reports_its_per_layer_metrics():
    r = harness.run_cell("voice16k_mas.gan_train_b16", 2 ** 31 + 97, 0.5, True,
                         torch.device("cpu"), 0.0, cfg=tiny_gan_cfg(), mix=tiny_gan_mix())
    assert r["correct"]
    assert {"gan_train.mfu", "loader_wait_share.gan_train"} <= set(r["metrics"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}

"""The control on the card: the reference in the program's place, in
TF32 (the precision below the configurations' float32 with TF32 off),
at the cell's own size on three seeds, comes out not correct."""

import json
import os
import time

import pytest
import torch

from h100bench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        r = harness.run_cell(cell, seed, 3.0, False, torch.device("cuda", 0),
                             time.perf_counter(), timed="control")
        assert r["correct"] is False, r["checks"]

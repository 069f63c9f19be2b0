"""The reader of the GAN step's graph counter: nothing without a counter
(the parent's step, the control), the share of replays with one."""

from types import SimpleNamespace

import pytest

from h100bench import harness

METRIC = "gan_step.graph_replay_share"


def read(steps):
    return harness.reader(METRIC)(SimpleNamespace(cell=SimpleNamespace(steps=steps)))


def test_no_counter_reads_nothing():
    def step(wav, mel):
        return {}

    assert read(SimpleNamespace(step=step)) is None  # a step with no graph
    assert read(SimpleNamespace()) is None  # the control has no program step
    assert read(None) is None


def test_share_of_replays():
    def step(wav, mel):
        return {}

    step.graph_stats = {"captures": 1, "replays": 249, "eager": 1}
    assert read(SimpleNamespace(step=step)) == pytest.approx(99.6)
    step.graph_stats = {"captures": 0, "replays": 0, "eager": 7}
    assert read(SimpleNamespace(step=step)) == 0.0
    step.graph_stats = {"captures": 0, "replays": 0, "eager": 0}
    assert read(SimpleNamespace(step=step)) is None

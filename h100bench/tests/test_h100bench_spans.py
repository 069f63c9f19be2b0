"""The readers of the program's own spans on synthetic Chrome events: the
GAN step's device ms, launches and host syncs a step, and the NSF source's
share read from the program's span."""

from types import SimpleNamespace

import pytest

from h100bench import harness
from h100bench.devtrace import CALL_SPAN, Trace, Traced
from h100bench.stepspan import GAN_STEP

GAN_METRICS = ("gan_step.device_ms_per_step", "gan_step.launches_per_step",
               "gan_step.host_syncs_per_step")
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy", "cudaFree", "cudaFreeHost")


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def rt(name, ts, corr, tid=1):
    return ev("cuda_runtime", name, ts, 1, tid=tid, corr=corr)


def dev(cat, name, ts, dur, corr):
    return ev(cat, name, ts, dur, tid=7, corr=corr)


def gan_events(blocking=BLOCKING):
    """Two steps, 0-100 and 200-300 us, inside the harness's call spans.
    Step 1: a launch on the main thread and two on autograd's thread (tid
    2), the second's kernel running beside the first's on another stream,
    a pinned copy, a memset; step 2: a launch, a pageable copy, the
    blocking calls. Between the steps, a launch and a synchronise of the
    harness's own."""
    events = [
        ev("user_annotation", CALL_SPAN, 0, 150), ev("user_annotation", CALL_SPAN, 150, 200),
        ev("user_annotation", GAN_STEP, 0, 100), ev("user_annotation", GAN_STEP, 200, 100),
        rt("cudaLaunchKernel", 10, 1), rt("cudaLaunchKernel", 50, 2, tid=2),
        rt("cudaLaunchKernel", 55, 8, tid=2),
        rt("cudaMemcpyAsync", 60, 5), rt("cudaMemsetAsync", 70, 6),
        rt("cudaLaunchKernel", 150, 3), rt("cudaStreamSynchronize", 160, 9),
        rt("cudaLaunchKernel", 210, 4), rt("cudaMemcpyAsync", 220, 7),
        dev("kernel", "k1", 12, 20, 1), dev("kernel", "k2", 52, 30, 2),
        dict(dev("kernel", "k2_side", 60, 20, 8), tid=9),
        dev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 82, 4, 5),
        dev("gpu_memset", "Memset (Device)", 86, 2, 6),
        dev("kernel", "k3", 152, 40, 3),
        dev("kernel", "k4", 212, 50, 4),
        dev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 262, 10, 7),
    ]
    events += [rt(name, 230 + i, 20 + i) for i, name in enumerate(blocking)]
    return events


def read(metric, events):
    tr = Trace(events)
    return harness.reader(metric)(SimpleNamespace(trace=Traced(tr, tr)))


def test_gan_step_metrics_average_two_steps():
    """Launches on autograd's thread count; the launch and the synchronise
    between the steps do not; copies and memsets count as device time, and
    two kernels side by side count once."""
    ms, launches, syncs = (read(m, gan_events()) for m in GAN_METRICS)
    assert launches == 4 / 2
    assert ms == pytest.approx((20 + 30 + 4 + 2 + 50 + 10) / 1e3 / 2)
    assert syncs == (len(BLOCKING) + 1) / 2  # and the pageable copy


@pytest.mark.parametrize("name", BLOCKING)
def test_each_blocking_call_counts(name):
    assert read("gan_step.host_syncs_per_step", gan_events((name,))) == 2 / 2


def test_no_sync_reads_zero_and_a_pinned_copy_does_not_block():
    events = [e for e in gan_events(()) if e.get("args", {}).get("correlation") != 7]
    assert read("gan_step.host_syncs_per_step", events) == 0.0


def test_no_step_span_or_no_card_reads_nothing():
    """The parent's program opens no step span; a CPU trace has no launch."""
    no_span = [e for e in gan_events() if e["name"] != GAN_STEP]
    cpu = [e for e in gan_events() if e["cat"] == "user_annotation"]
    for metric in GAN_METRICS:
        assert read(metric, no_span) is None and read(metric, cpu) is None


def test_nsf_source_read_from_the_program_span_as_from_the_hooks():
    events = [ev("user_annotation", CALL_SPAN, 0, 100),
              ev("user_annotation", "kantts.hifigan.nsf_source", 9, 22),
              ev("user_annotation", "h100bench.nsf_source", 10, 20),
              rt("cudaLaunchKernel", 12, 1), rt("cudaLaunchKernel", 42, 2),
              dev("kernel", "k_source", 15, 10, 1), dev("kernel", "k_conv", 45, 30, 2)]
    got = read("nsf_source.span_device_share", events)
    assert got == read("nsf_source.device_share", events) == pytest.approx(25.0)
    assert read("nsf_source.span_device_share",
                [e for e in events if not e["name"].startswith("kantts.")]) is None

"""Reading a Chrome trace: busy and idle time, device time under a span,
dropped records, and idle gaps named by the host."""

from h100bench.devtrace import CALL_SPAN, Trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    ev("user_annotation", CALL_SPAN, 0, 100),
    ev("user_annotation", "h100bench.nsf_source", 10, 20),
    ev("cpu_op", "aten::conv1d", 40, 30),
    ev("cuda_runtime", "cudaLaunchKernel", 12, 2, corr=1),
    ev("cuda_runtime", "cudaLaunchKernel", 42, 2, corr=2),
    ev("cuda_runtime", "cudaLaunchKernel", 44, 2, corr=3),
    ev("kernel", "k_source", 15, 10, tid=7, corr=1),
    ev("kernel", "k_conv", 45, 30, tid=7, corr=2),
    ev("kernel", "k_conv", 75, 5, tid=7, corr=3),
    ev("gpu_memcpy", "Memcpy DtoH", 90, 10, tid=7),
]


def test_busy_idle_and_spans():
    t = Trace(EVENTS)
    assert t.window_s == 100e-6
    assert abs(t.busy_s - 55e-6) < 1e-12          # 15-25, 45-80, 90-100
    assert abs(t.device_s_under("h100bench.nsf_source") - 10e-6) < 1e-12
    assert t.dropped_share() == 0.0
    ops = dict(t.top_device_ops())
    assert abs(ops["k_conv"] - 35e-6) < 1e-12
    gaps = dict(t.idle_gaps())
    # 0-15 and 25-45 (the call and the span), 80-90 (no op inside the call)
    assert abs(gaps[CALL_SPAN] - (15e-6 + 10e-6 + 10e-6)) < 1e-12 or \
        abs(sum(gaps.values()) - 45e-6) < 1e-12


def test_dropped_records():
    t = Trace([e for e in EVENTS if e.get("name") != "k_source"])
    assert abs(t.dropped_share() - 1 / 3) < 1e-12


def test_device_only_window():
    """Traced with the device's activity alone: no host spans; the window
    runs from the first launch to the device's last end."""
    t = Trace([e for e in EVENTS if e["cat"] in ("cuda_runtime", "kernel", "gpu_memcpy")])
    assert t.t0 == 12 and t.t1 == 100
    assert abs(t.window_s - 88e-6) < 1e-12 and abs(t.busy_s - 55e-6) < 1e-12
    assert Trace([e for e in EVENTS if e["cat"] == "kernel"]).dropped_share() == 0.0
    assert Trace([e for e in EVENTS if e["cat"] != "kernel"]).dropped_share() == 1.0


def test_device_window_profiled_again_on_missing_kernels(monkeypatch):
    """A device-only window holds no launches to check its kernel records
    against, so it is held to the kernel count of the host window that it
    repeats, and profiled again when it has fewer."""
    import contextlib

    import torch

    from h100bench import devtrace

    full = [e for e in EVENTS if e["cat"] in ("kernel", "gpu_memcpy")]
    windows = iter([full[1:], full])  # the first window lost a kernel record
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda **kw: contextlib.nullcontext())
    monkeypatch.setattr(devtrace, "_load", lambda prof: next(windows))
    calls = []
    t = devtrace.profile(lambda: calls.append(1), lambda: None, host=False, kernels=3)
    assert len(calls) == 2 and len(t.kernels) == 3
    windows = iter([full[1:]] * devtrace.WINDOWS)
    monkeypatch.setattr(devtrace, "_load", lambda prof: next(windows))
    try:
        devtrace.profile(lambda: None, lambda: None, host=False, kernels=3)
    except RuntimeError as e:
        assert "dropped" in str(e)
    else:
        raise AssertionError("a window short of kernel records was kept")

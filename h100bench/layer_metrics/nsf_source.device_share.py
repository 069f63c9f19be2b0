"""Share of the traced window's device time spent in kernels launched by
the NSF source: ``SourceModule`` and each ``source_downs`` conv, inside
the ``h100bench.nsf_source`` spans that forward hooks put around them."""


def read(run):
    tr = run.trace and run.trace.host
    if tr is None or tr.busy_s == 0:
        return None
    source = tr.device_s_under("h100bench.nsf_source")
    if source == 0:
        return None
    return 100.0 * source / tr.busy_s

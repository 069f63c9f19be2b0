"""Share of the traced window's device time spent in kernels launched by
the NSF source, inside the program's own ``kantts.hifigan.nsf_source``
spans around ``SourceModule`` and each ``source_downs`` conv
(``models/hifigan/generator.py``): ``nsf_source.device_share`` read from
the program's spans in place of the harness's forward hooks."""


def read(run):
    tr = run.trace and run.trace.host
    if tr is None or tr.busy_s == 0:
        return None
    source = tr.device_s_under("kantts.hifigan.nsf_source")
    if source == 0:
        return None
    return 100.0 * source / tr.busy_s

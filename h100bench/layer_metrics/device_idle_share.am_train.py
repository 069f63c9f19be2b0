"""Share of the traced window in which no kernel, copy or memset ran on
the card. The window is traced with the device's activity alone, from the
first launch to the end of the device's last operation. The profiler's
cost for each launch still holds the host back, and the AM step waits on
the host in its syncs, so this reads idler than an untraced window
would."""


def read(run):
    tr = run.trace and run.trace.device
    if tr is None or tr.window_s == 0 or tr.busy_s == 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)

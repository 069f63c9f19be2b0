"""Share of the AM step's device time spent in kernels launched inside the
program's ``kantts.am.mas`` spans (the alignment attention with its prior,
and kernel K1's hard path), from the host-traced window: their summed
kernel time over the union of the step records' intervals
(``am_step.device_ms_per_step`` times the steps). None where the program
opens no such span."""

from h100bench import stepspan


def read(run):
    s = stepspan.steps(run, "kantts.am.step")
    if s is None:
        return None
    mas = run.trace.host.device_s_under("kantts.am.mas")
    if mas == 0:
        return None
    return 100.0 * mas / (s.device_ms() * s.n / 1e3)

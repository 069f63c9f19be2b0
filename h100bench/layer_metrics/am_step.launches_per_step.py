"""Kernel launches an AM step: the runtime's launch calls that start inside
the program's ``kantts.am.step`` spans (on any thread), over the steps,
from the host-traced window. None where the program opens no such span."""

from h100bench import stepspan


def read(run):
    s = stepspan.steps(run, "kantts.am.step")
    return None if s is None else s.launches()

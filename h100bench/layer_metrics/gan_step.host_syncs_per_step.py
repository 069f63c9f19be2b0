"""Host-blocking runtime calls a GAN step (``stepspan.py`` names them)
that start inside the program's ``kantts.gan.step`` spans, over the steps,
from the host-traced window. None a step reads 0, a value."""

from h100bench import stepspan


def read(run):
    s = stepspan.steps(run)
    return None if s is None else len(s.blocking()) / s.n

"""Kernel launches a GAN step: the runtime's launch calls that start
inside the program's ``kantts.gan.step`` spans (on any thread), over the
steps, from the host-traced window. The train step's work count, which a
CUDA graph or a fused optimizer would move."""

from h100bench import stepspan


def read(run):
    s = stepspan.steps(run)
    return None if s is None else s.launches()

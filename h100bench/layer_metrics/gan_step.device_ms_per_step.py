"""Device ms a GAN step: the time in which a kernel, copy or memset
launched inside the program's ``kantts.gan.step`` spans (on any thread)
ran, over the steps, from the host-traced window. The train step's busy
time: the union of the records' intervals, since cuDNN runs a grouped
conv's kernels side by side on streams of its own."""

from h100bench import stepspan


def read(run):
    s = stepspan.steps(run)
    return None if s is None else s.device_ms()

"""Device ms an AM step: the time in which a kernel, copy or memset
launched inside the program's ``kantts.am.step`` spans (on any thread)
ran, over the steps, from the host-traced window; the union of the
records' intervals, as ``gan_step.device_ms_per_step`` reads the GAN
step's. None where the program opens no such span."""

from h100bench import stepspan


def read(run):
    s = stepspan.steps(run, "kantts.am.step")
    return None if s is None else s.device_ms()

"""The GAN step's operations in the measured window over the window's time
and the peak of the configuration's compute dtype. A step's operations
are the reference step's at the batch's shape (``paths/gan_train.py::
Cell.step_flops``; FFTs not counted), counted here, after the window."""

from h100bench import flops


def read(run):
    cell = run.cell
    if not getattr(cell, "n_steps", 0):
        return None
    step = cell.step_flops()
    return 100.0 * step * cell.n_steps / cell.window_s / flops.peak_flops(run.cfg)

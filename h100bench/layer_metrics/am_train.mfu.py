"""The AM step's operations in the measured window over the window's time
and the peak of the configuration's compute dtype. A step's operations
are the reference step's at the checked batches' padded shape (32 x 96 x
576 in ``voice16k_mas.am_train_b32``; ``paths/am_train.py::
Cell.step_flops``, counted on the meta device; CTC and the Viterbi are
not counted), counted here, after the window."""

from h100bench import flops


def read(run):
    cell = run.cell
    if not getattr(cell, "n_steps", 0):
        return None
    step = cell.step_flops()
    return 100.0 * step * cell.n_steps / cell.window_s / flops.peak_flops(run.cfg)

"""Share of the measured window the host spent waiting in ``next()`` on
the port's loader for the AM step's next batch."""


def read(run):
    cell = run.cell
    if not getattr(cell, "n_steps", 0):
        return None
    return 100.0 * cell.wait_s / cell.window_s

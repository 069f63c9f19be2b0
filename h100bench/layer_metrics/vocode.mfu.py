"""The vocoder's useful operations in the measured window over the
window's time and the peak of the configuration's compute dtype.

A call's operations are the reference generator's at its padded shape
(``flops.generator_flop_table``, counted here, after the window), scaled
to the utterances' own frames: padding is not useful work."""

from h100bench import flops


def read(run):
    cell = run.cell
    if not getattr(cell, "calls", None):
        return None
    table = flops.generator_flop_table(cell.params, cell.batch,
                                       [c["L"] for c in cell.calls])
    useful = sum(table[c["L"]] * sum(c["frames"]) / (cell.batch * c["L"])
                 for c in cell.calls)
    return 100.0 * useful / cell.window_s / flops.peak_flops(run.cfg)

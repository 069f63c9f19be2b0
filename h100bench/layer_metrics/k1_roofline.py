"""Kernel K1's share of its roofline: the least time of one MAS alignment
at the checked batches' shape (``flops.k1_least_seconds``: the float32
map read once and the path written once, at the card's HBM rate) over
K1's mean device time a launch (its score and Viterbi kernels, the
``mas_`` records). K1's launches are recounted in a traced window and held
to its own counter (``MasKernel.launches``, taken around each traced
window): the host window is read, or the device window where the host
window lost records; None where neither holds every launch's record."""

from h100bench import flops

VITERBI = ("mas_warp_kernel", "mas_block_kernel")  # one of them a launch


def read(run):
    cell, tr = run.cell, run.trace
    counts = set(getattr(cell, "k1_launches", ()))
    if tr is None or len(counts) != 1 or 0 in counts:
        return None
    launches, = counts
    for trace in (tr.host, tr.device):
        records = [e for e in trace.kernels if "mas_" in e["name"]]
        if sum(any(k in e["name"] for k in VITERBI) for e in records) == launches:
            mean_s = sum(e["dur"] for e in records) / 1e6 / launches
            return 100.0 * flops.k1_least_seconds(*cell.k1_shape) / mean_s
    return None

"""Share of the frames the vocoder computed in the measured window that
are padding: ``bucket_pad``'s rounding up to the frame bucket, and the
zero mels that fill a short batch."""


def read(run):
    calls = getattr(run.cell, "calls", None)
    if not calls or "L" not in calls[0]:
        return None
    real = sum(sum(c["frames"]) for c in calls)
    computed = sum(run.cell.batch * c["L"] for c in calls)
    return 100.0 * (1.0 - real / computed)

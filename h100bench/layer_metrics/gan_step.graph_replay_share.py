"""Share of the GAN step's calls that replayed its CUDA graph: replays over
replays and eager calls, from the program's own counter (``graph_stats`` of
the step function ``make_gan_step`` returns), over the whole run, the
checked steps of the set-up included. None where the step keeps no such
counter: the control, or a program whose step has no graph."""


def read(run):
    stats = getattr(getattr(getattr(run.cell, "steps", None), "step", None),
                    "graph_stats", None)
    if stats is None:
        return None
    calls = stats["replays"] + stats["eager"]
    return 100.0 * stats["replays"] / calls if calls else None

"""Host-blocking runtime calls an AM step (``stepspan.py`` names them:
synchronises, blocking copies and frees, pageable async copies) that start
inside the program's ``kantts.am.step`` spans, over the steps, from the
host-traced window: ``F.ctc_loss``'s and the packed BiLSTMs' copies of the
lengths to the host among them. None where the program opens no such
span."""

from h100bench import stepspan


def read(run):
    s = stepspan.steps(run, "kantts.am.step")
    return None if s is None else len(s.blocking()) / s.n

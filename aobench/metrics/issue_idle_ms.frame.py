"""``issue_idle_ms.frame``: device idle ms a frame at whose middle a span
of the program was open: the idle that the program's host path causes,
read in the program-traced phase of a traced run, from its pass under
torch.profiler (``aobench/spans.py``).  The idle under the benchmark's
loop and synchronise (``outside``) is not counted."""

from aobench import spans


def read(rec):
    pt = spans.program_trace(rec)
    if pt is None or not pt["busy_ms"] > 0:
        return None
    return sum(ms for label, ms in pt["idle_ms"].items()
               if label != spans.OUTSIDE)

"""``prepare_host_ms.frame``: host ms a frame in the program's
``ao_prepare`` (pad, linearise, pyramid) and ``ao_slopes`` (the normals
prologue) spans, read in the program-traced phase of a traced run, from
its pass without the profiler (``aobench/spans.py``)."""

from aobench import spans


def read(rec):
    pt = spans.program_trace(rec)
    if pt is None or pt["host"] is None:
        return None
    return sum(total for name, (_, total, _) in pt["host"]["spans"].items()
               if name in spans.PROLOGUE)

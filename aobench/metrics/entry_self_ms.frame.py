"""``entry_self_ms.frame``: the entry's own Python a frame, in ms: the
self time of the program's ``ao_entry.*`` spans (argument handling, the
checks and the calls between its stages), read in the program-traced
phase of a traced run, from its pass without the profiler
(``aobench/spans.py``)."""

from aobench import spans


def read(rec):
    pt = spans.program_trace(rec)
    if pt is None or pt["host"] is None:
        return None
    return sum(own for name, (_, _, own) in pt["host"]["spans"].items()
               if name.startswith(spans.ENTRY_PREFIX))

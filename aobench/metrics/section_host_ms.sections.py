"""``section_host_ms.sections``: host ms a frame in the program's sections
layer's own code: the self time of its ``ao_section`` spans (each
section's slicing and its frame program's Python outside the stage spans)
plus the total of its ``ao_section_keep`` spans (the composite, quantise
and copy of the kept rows), read in the program-traced phase of a traced
run, from its pass without the profiler (``aobench/spans.py``).  A program
without these spans has nothing to read."""

from aobench import spans


def read(rec):
    pt = spans.program_trace(rec)
    if pt is None or pt["host"] is None:
        return None
    table = pt["host"]["spans"]
    if "ao_section" not in table:
        return None
    keep = table.get("ao_section_keep", [0, 0.0, 0.0])
    return table["ao_section"][2] + keep[1]

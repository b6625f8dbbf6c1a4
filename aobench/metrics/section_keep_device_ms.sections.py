"""``section_keep_device_ms.sections``: device ms a frame issued from the
program's ``ao_section_keep`` spans: the composite, quantise and copy of
each section's kept rows into the output, labelled by the innermost
program span open when its runtime call was issued, in the program
trace's pass under torch.profiler (``aobench/spans.join``).  At least
0.317 ms at 16K: the copy reads and writes 1.06 GB at 3.35 TB/s.  A
program without the span has nothing to read."""

from aobench import spans

KEEP = "ao_section_keep"


def read(rec):
    pt = spans.program_trace(rec)
    if pt is None or KEEP not in pt["spans"]:
        return None
    return pt["device_ms"].get(KEEP, 0.0)

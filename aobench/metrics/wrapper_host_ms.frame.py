"""``wrapper_host_ms.frame``: host ms a frame in the program's stage spans
(``ao_render_l*``, ``ao_upsample_l*``, ``ao_fused_l*``: the launch
wrappers, their ``ao_launch`` children included), read in the
program-traced phase of a traced run, from its pass without the profiler
(``aobench/spans.py``)."""

from aobench import spans


def read(rec):
    pt = spans.program_trace(rec)
    if pt is None or pt["host"] is None:
        return None
    return sum(total for name, (_, total, _) in pt["host"]["spans"].items()
               if spans.STAGE.match(name))

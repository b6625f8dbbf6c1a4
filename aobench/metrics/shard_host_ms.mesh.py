"""``shard_host_ms.mesh``: host ms a frame in the program's sharding
layer: the totals of its ``ao_scatter`` spans (each card's shard copies)
and its ``ao_gather`` span (the gather on the first card and the crop),
read in the program-traced phase of a traced run, from its pass without
the profiler (``aobench/spans.py``).  A program without these spans has
nothing to read."""

from aobench import spans

SHARDING = ("ao_scatter", "ao_gather")


def read(rec):
    pt = spans.program_trace(rec)
    if pt is None or pt["host"] is None:
        return None
    table = pt["host"]["spans"]
    if not any(name in table for name in SHARDING):
        return None
    return sum(table[name][1] for name in SHARDING if name in table)

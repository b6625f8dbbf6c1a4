"""``shard_device_ms.mesh``: device ms a frame issued from the program's
sharding layer: the device operations that the program trace's pass
under torch.profiler labels ``ao_scatter`` (the copies of the shards to
their cards) or ``ao_gather`` (the copies back to the first card and the
concatenation there), each labelled by the innermost program span open
when its runtime call was issued (``aobench/spans.join``).  A program
without these spans has nothing to read."""

from aobench import spans

SHARDING = ("ao_scatter", "ao_gather")


def read(rec):
    pt = spans.program_trace(rec)
    if pt is None or not any(name in pt["spans"] for name in SHARDING):
        return None
    return sum(pt["device_ms"].get(name, 0.0) for name in SHARDING)

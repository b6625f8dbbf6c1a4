"""Traffic ``stream``: one frame a call through ``engine.render``, a
closed loop with one caller, synchronised after each call, cycling a pool
of ``pool`` distinct dolly frames made on the device from the seed.

Parameters (``workloads/<cell>.json``): ``pool``, ``n_spheres``,
``dolly_step``, ``warmup_calls``, ``samples`` (outputs checked, at times
drawn from the seed), ``trace_calls`` (calls profiled in a traced run).
"""

from aobench import frameloop


def run(ctx) -> dict:
    return frameloop.run(ctx, views=0)

"""Traffic ``rig``: ``views`` frames a call as one batch through
``engine.render_views``, spread over the configuration's ``cards``, a
closed loop with one caller, synchronised after each call; the views are
taken ``views`` at a time from a pool of ``pool`` dolly frames made on the
device from the seed.

Parameters (``workloads/<cell>.json``): ``views``, and those of
``stream``.
"""

from aobench import frameloop


def run(ctx) -> dict:
    return frameloop.run(ctx, views=ctx.workload["views"])

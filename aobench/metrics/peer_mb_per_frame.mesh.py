"""``peer_mb_per_frame.mesh``: the bytes the program copied between two
distinct cards a frame, in 1e6 bytes: ``mesh_counts()["peer_bytes"]``
over ``mesh_counts()["frames"]`` of
``tpuao_torch.parallel.sharding`` when the run's metrics are read (every
call of the run, warm-up included).  A run off the card, and a program
without the counter, have nothing to read."""

import importlib


def read(rec):
    if rec.get("device", {}).get("platform") != "gpu":
        return None
    sharding = importlib.import_module("tpuao_torch.parallel.sharding")
    counts = getattr(sharding, "mesh_counts", None)
    if counts is None:
        return None
    c = counts()
    if not c["frames"]:
        return None
    return c["peer_bytes"] / c["frames"] / 1e6

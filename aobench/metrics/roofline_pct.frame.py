"""``roofline_pct.frame``: the whole frame's bound (``work.frame_bound_ms``,
the larger of its operations at 67 TFLOP/s and its bytes at 3.35 TB/s)
over the device's busy ms per frame in the profiled sub-window, in %."""

from aobench.reference.params import from_config
from aobench.work import frame_bound_ms


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof.get("frames") or not prof["busy_s"] > 0:
        return None
    params, _ = from_config(rec["config"])
    bound_ms, _ = frame_bound_ms(*rec["frame_shape"], params)
    return 100.0 * bound_ms * prof["frames"] / (prof["busy_s"] * 1e3)

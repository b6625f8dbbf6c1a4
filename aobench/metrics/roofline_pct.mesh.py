"""``roofline_pct.mesh``: the whole frame's bound (``work.frame_bound_ms``,
the larger of its operations at 67 TFLOP/s and its bytes at 3.35 TB/s)
times the profiled frames, over the card-seconds the cards were busy in
the profiled sub-window (the sum over the cards of ``busy_s_by_card``),
in %.  It stays at most 100 % however far the cards overlap, where the
union of their busy time that ``roofline_pct.frame`` reads would not."""

from aobench.reference.params import from_config
from aobench.work import frame_bound_ms


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof.get("frames") or not prof.get("busy_s_by_card"):
        return None
    busy_s = sum(prof["busy_s_by_card"].values())
    if not busy_s > 0:
        return None
    params, _ = from_config(rec["config"])
    bound_ms, _ = frame_bound_ms(*rec["frame_shape"], params)
    return 100.0 * bound_ms * prof["frames"] / (busy_s * 1e3)

"""``launches_per_frame.frame``: kernels launched per frame in the
profiled sub-window (copies and fills apart).  A count that is not a whole
number of a call's launches means the profiler lost records."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof.get("frames") or not prof["busy_s"] > 0:
        return None
    return sum(n for n, _ in prof["kernels"].values()) / prof["frames"]

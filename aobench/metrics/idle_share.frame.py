"""``idle_share.frame``: 1 - device busy / wall time over the profiled
sub-window of a frame cell, in %."""


def read(rec):
    prof = rec.get("profile")
    if not prof or "frames" not in prof or not prof["busy_s"] > 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])

"""``frame_ms``: the whole window over the frames completed in it (a rig
call counts its views), host clock."""


def read(rec):
    if "call_latencies_s" not in rec or not rec.get("frames"):
        return None
    return rec["window_s"] * 1e3 / rec["frames"]

"""``frame_ms_p95``: the 95th percentile (nearest rank) of every call's
latency in the window, from the call to its synchronised result, host
clock."""

from aobench.stats import percentile


def read(rec):
    lat = rec.get("call_latencies_s")
    return percentile(lat, 95) * 1e3 if lat else None

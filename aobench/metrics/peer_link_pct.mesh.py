"""``peer_link_pct.mesh``: the copies between cards' share of their
roofline, in %: the frozen bytes that the profiled calls copy between
cards (``aobench/mesh_work.peer_bytes_per_call``) at 450 GB/s, over the
summed device time of the trace's copies between cards (the copies whose
name holds ``PtoP``).  450 GB/s is one direction of an H100 SXM's NVLink
4 (data sheet: 900 GB/s both ways).  The durations are summed, not
joined, so copies that run at once cannot read above 100 %.  A trace
without such a copy has nothing to read."""

from aobench.mesh_work import peer_bytes_per_call

LINK_BYTES_S = 450e9
PEER = "PtoP"


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof.get("frames") or not rec.get("calls"):
        return None
    seconds = sum(t for name, (_, t) in prof["copies"].items()
                  if PEER in name)
    if not seconds > 0:
        return None
    views = rec["frames"] // rec["calls"]
    cfg = rec["config"]
    per_call = peer_bytes_per_call(*rec["frame_shape"], views,
                                   cfg.get("cards", 1),
                                   cfg["ao"]["use_normals"])
    nbytes = per_call * prof["frames"] / views
    return 100.0 * nbytes / LINK_BYTES_S / seconds

"""``graph_bound_pct.frame``: the share of the program's graph replays of
``render_frame`` that ran on the call's own buffers, in %: the replays
that bound both the call's depth and normals (read in place by the
captured prologue) and its output (written by the captured last chain
step), over every replay, from the program's counters when the run's
metrics are read (``tpuao_torch.models.frame_graph.graph_counts``: its
``bound`` over its ``replays``).  A run off the card, a program without
these counters and a run that replayed nothing have nothing to read."""

import importlib.util


def read(rec):
    if rec.get("device", {}).get("platform") != "gpu":
        return None
    if importlib.util.find_spec("tpuao_torch.models.frame_graph") is None:
        return None
    from tpuao_torch.models import frame_graph

    counts = frame_graph.graph_counts()
    if "bound" not in counts or not counts.get("replays"):
        return None
    return 100.0 * counts["bound"] / counts["replays"]

"""``graph_pool_mb``: the device memory held in the pools of the
program's CUDA graphs of ``render_frame`` when the run's metrics are
read, in 1e6 bytes: the sum over the cached graphs of the bytes the card
reserved around each one's capture
(``tpuao_torch.models.frame_graph.pool_bytes``).  ``peak_mem_mb`` does not
see them: a cell captures its graphs in warm-up, before the window, and
a replay allocates in its graph's pool.  A run off the card, and a
program without graphs (no ``tpuao_torch.models.frame_graph``), have
nothing to read."""

import importlib.util


def read(rec):
    if rec.get("device", {}).get("platform") != "gpu":
        return None
    if importlib.util.find_spec("tpuao_torch.models.frame_graph") is None:
        return None
    from tpuao_torch.models import frame_graph

    return frame_graph.pool_bytes() / 1e6

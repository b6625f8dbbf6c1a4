"""``graph_replay_pct.frame``: the share of the program's ``render_frame``
calls that replayed the frame's launches from a CUDA graph, in %: the
count of its ``ao_graph_replay`` spans over the count of its
``ao_entry.render_frame`` spans, read in the program-traced phase of a
traced run, from its pass without the profiler (``aobench/spans.py``).
A program without graphs (no ``tpuao_torch.models.frame_graph``) has
nothing to read."""

import importlib.util

from aobench import spans

REPLAY = "ao_graph_replay"
FRAME_ENTRY = spans.ENTRY_PREFIX + "render_frame"


def read(rec):
    if importlib.util.find_spec("tpuao_torch.models.frame_graph") is None:
        return None
    pt = spans.program_trace(rec)
    if pt is None or pt["host"] is None:
        return None
    table = pt["host"]["spans"]
    calls = table.get(FRAME_ENTRY, [0])[0]
    if not calls:
        return None
    return 100.0 * table.get(REPLAY, [0])[0] / calls

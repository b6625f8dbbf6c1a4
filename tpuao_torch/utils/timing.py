"""Device timing with CUDA events.

Counterpart of the timing half of ``tpuao/utils/profiling.py``: warm up,
then time each run between a pair of ``torch.cuda.Event`` records on the
current stream and report the median.  There is no CPU fallback: a host
clock without a synchronise measures only the enqueue.
"""

from __future__ import annotations

import statistics

import torch


def cuda_time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median device milliseconds of one ``fn()`` call, by CUDA events.

    Every run's start and end events are recorded first and read after one
    synchronise, so the reading adds no host round trip between runs.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def cuda_graph_ms(fn, reps: int = 10, iters: int = 10) -> float:
    """Median device milliseconds of one ``fn()`` call with the host's
    launch path out of the way: ``reps`` calls captured once in a CUDA
    graph, the graph replayed ``iters`` times between pairs of events.
    For a call whose launches are cheaper to run than to issue (a small
    kernel behind a Python wrapper) this is the device's own time, which
    ``cuda_time_ms`` cannot see.  ``fn`` must only launch work on the
    current stream (no synchronise, no host copy)."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_graph_ms needs a CUDA device")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as it needs
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in pairs) / reps
    del graph
    return ms

"""The host cost of the port's tracing (``tpuao_torch.utils.trace``) on.

    python3 scripts/trace_cost.py [--cells high_1080p.stream,...]
        [--pairs 30] [--calls 200]
    python3 scripts/trace_cost.py --cells high_1080p_x4.rig8   # four cards

For each benchmark cell named (``aobench/``, its engine, pool and mesh
made as its runs make them, seed 1), in one process on the card(s) (a
cell of four cards needs four; every card of the mesh is synchronised
after each call): blocks of
``--calls`` calls with the program's tracing off and on, alternated (off
first in even pairs, on first in odd ones), no profiler.  A call's host
issue time runs from the call to its return, before the synchronise, as
``host_ms_per_call`` reads it.  Prints one JSON line a cell: each block's
median in ms, the median and quartiles of each side's blocks, each pair's
difference on - off, and the span sites a call.  A first line gives the
cost of one span site, off and on, on this host: the median over
``--site-reps`` loops of 10,000 sites less the same loop with a bare body.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _cell_call(name: str):
    """The cell's call ``k -> output`` as its runs send it
    (``aobench.frameloop.Cell``: its engine, pool and mesh), warmed up."""
    from aobench import device as D
    from aobench import frameloop, harness

    _, wl, cfg = harness.load_cell(name)
    ctx = harness.Context(cell=name, workload=wl, config=cfg, seed=1,
                          seconds=0.0, trace=False, device="cuda",
                          t0=time.perf_counter())
    call = frameloop.Cell(ctx, wl.get("views", 0))
    for k in range(max(wl["warmup_calls"], call.n_inputs)):
        call(k)
    D.sync(call.mesh)
    return call


def _site_us(traced: bool, n: int = 10_000) -> float:
    """µs of one span site over a loop of ``n``, less the bare loop."""
    from tpuao_torch.utils import trace

    if traced:
        trace.enable()
    try:
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with trace.span("ao_launch") if trace.ON else trace.OFF:
                pass
        t1 = time.perf_counter_ns()
        for _ in range(n):
            pass
        t2 = time.perf_counter_ns()
    finally:
        trace.disable()
        trace.take()
    return ((t1 - t0) - (t2 - t1)) / n / 1e3


def _block(call, calls: int, traced: bool) -> tuple[float, int]:
    """Median host issue ms a call over one block, and the spans a call
    (0 untraced)."""
    from aobench import device as D
    from tpuao_torch.utils import trace

    if traced:
        trace.enable()
    issue = []
    try:
        for k in range(calls):
            t0 = time.perf_counter()
            out = call(k)
            issue.append(time.perf_counter() - t0)
            D.sync(call.mesh)
            del out
    finally:
        trace.disable()
        rec = trace.take()
    if traced and (rec["dropped"] or not rec["spans"]):
        raise RuntimeError(f"trace dropped {rec['dropped']} records")
    return statistics.median(issue) * 1e3, len(rec["spans"]) // calls


def _summary(xs: list[float]) -> dict:
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return {"median": statistics.median(xs), "q1": q1, "q3": q3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default="high_1080p.stream,high_1080p.rig8,"
                    "ultra_4k.stream")
    ap.add_argument("--pairs", type=int, default=30)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--site-reps", type=int, default=50)
    a = ap.parse_args(argv)
    import torch

    from aobench import device as D

    if not torch.cuda.is_available():
        print("trace_cost: no CUDA device", file=sys.stderr)
        return 2
    sites = {"off": [], "on": []}
    for r in range(a.site_reps):
        for traced in ((False, True) if r % 2 == 0 else (True, False)):
            sites["on" if traced else "off"].append(_site_us(traced))
    print(json.dumps({"site_us": {k: _summary(v) for k, v in sites.items()},
                      "reps": a.site_reps}), flush=True)
    for name in a.cells.split(","):
        call = _cell_call(name)
        off, on, n_spans = [], [], 0
        for p in range(a.pairs):
            for traced in ((False, True) if p % 2 == 0 else (True, False)):
                ms, n = _block(call, a.calls, traced)
                (on if traced else off).append(ms)
                n_spans = max(n_spans, n)
        print(json.dumps({
            "cell": name, "device": torch.cuda.get_device_name(),
            "cards": len(D.cards(call.mesh)),
            "calls_a_block": a.calls, "off_ms": off, "on_ms": on,
            "off": _summary(off), "on": _summary(on),
            "on_minus_off_ms": [y - x for x, y in zip(off, on)],
            "sites_a_call": n_spans}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

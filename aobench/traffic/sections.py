"""Traffic ``sections``: one (H, W) frame a call through
``engine.render_sections(depth, n_sections=sections)``, a closed loop with
one caller, synchronised after each call, cycling a pool of ``pool``
distinct dolly frames made on the device from the seed.

Parameters (``workloads/<cell>.json``): ``sections``, and those of
``stream``.

The loop is ``frameloop.run``'s for one frame a call on one card, with
the sections call in place of ``engine.render``: set-up makes the pool and
the engine (``frameloop.Cell``) and warms up every pool entry, the window
records each call's latency to its synchronised result and samples the
outputs due at times drawn from the seed, and a traced run profiles
``trace_calls`` more calls (``frameloop.profile_calls``), then runs as
many with the program's tracing on (``spans.trace_program``).  The record
holds the keys ``frameloop.run``'s does.
"""

from __future__ import annotations

import gc
import json
import time

from aobench import device as D
from aobench import frameloop, spans, stats


class Sections(frameloop.Cell):
    """The stream's call on its pool, each frame rendered in ``n``
    sections."""

    def __init__(self, ctx):
        super().__init__(ctx, views=0)  # raises on more than one card
        self.n = ctx.workload["sections"]

    def __call__(self, k):
        _, d, nrm = self.inputs(k)
        return self.engine.render_sections(d, n_sections=self.n,
                                           normals=nrm)


def run(ctx) -> dict:
    import torch

    wl = ctx.workload
    call = Sections(ctx)
    mesh = call.mesh

    for k in range(max(wl["warmup_calls"], call.n_inputs)):
        out = call(k)
    D.sync(mesh)
    del out
    setup_peak = D.peak(mesh)
    setup_s = time.perf_counter() - ctx.t0

    gc.collect()
    due = stats.sample_times(ctx.seconds, wl["samples"], ctx.seed)
    lat, issue, samples = [], [], []
    base = D.allocated(mesh)[0]
    D.reset_peak(mesh)
    start = time.perf_counter()
    k = 0
    while True:
        t0 = time.perf_counter()
        out = call(k)
        t1 = time.perf_counter()
        D.sync(mesh)
        t2 = time.perf_counter()
        lat.append(t2 - t0)
        issue.append(t1 - t0)
        if due and t2 - start >= due[0]:
            due.pop(0)
            samples.append((call.inputs(k)[0], out.cpu()))
        del out
        k += 1
        if t2 - start >= ctx.seconds:
            break
    window_s = time.perf_counter() - start
    peak = D.peak(mesh)
    ctx.notes.append("frame_ms by thirds of the window " + " ".join(
        repr(x) for x in frameloop._thirds(lat, 1)))
    rec = {"setup_s": setup_s, "window_s": window_s, "calls": k,
           "frames": k, "call_latencies_s": lat, "attempted": k,
           "failed": 0, "peak_window_bytes": peak[0] - base,
           "peak_bytes_by_card": peak}
    if ctx.trace:
        n = wl["trace_calls"]
        rec["host_issue_s"] = issue
        rec["profile"] = frameloop.profile_calls(call, n, k, mesh)
        rec["profile"]["frames"] = n
        t0 = time.perf_counter()
        pt = spans.trace_program(call, n, k + n, mesh)
        if pt is not None:
            pt["seconds"] = time.perf_counter() - t0
            ctx.notes.append("program_trace " + json.dumps(pt,
                                                           sort_keys=True))
        rec["program_trace"] = pt
    rec["device"] = D.entry(mesh, max(max(setup_peak), max(peak)),
                            rec.get("profile"))
    rec["pool"] = (call.depth, call.normals)
    del call
    if D.cards(mesh):
        torch.cuda.empty_cache()
    rec["samples"] = samples
    return rec

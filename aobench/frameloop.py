"""A closed loop of frames through the engine: one caller, each call
synchronised before the next (``traffic/stream.py``, ``traffic/rig.py``).

Set-up makes the pool on the device from the seed, builds the engine and
warms it on every pool entry the window will send.  A configuration's
``cards`` (1 or 4) sets the mesh a call's views are spread over
(``device.mesh_of``): with more than one card each call goes through
``engine.render_views(..., mesh=mesh)``, the pool sits on the mesh's first
card, the engine's device, and the program gathers the outputs there.  The
window calls until ``seconds`` have passed, recording each call's latency
on the host clock from the call to its result synchronised on every card,
and copies the outputs due at sample times drawn from the seed to the host
after the call's latency is taken.  Peak memory is read on every card over
the window, beyond what each held at its start (the pool); the fullest
card's counts.  A traced run records the benchmark's own span around each
entry call (ended before the synchronise) over the window, then profiles
``trace_calls`` more calls, then runs as many with the program's own
tracing on (``spans.trace_program``), all on the window's engine and pool.
"""

from __future__ import annotations

import gc
import json
import time

from aobench import device as D
from aobench import spans, stats
from aobench.scenes import dolly_pool


class Cell:
    """A frame cell's call ``k -> output`` (``cell(k)``) on its pool, as
    the loop sends it: ``views`` 0 sends one (H, W) frame a call through
    ``engine.render``, V > 0 sends (V, H, W) through
    ``engine.render_views``, over the configuration's mesh where it has
    more than one card."""

    def __init__(self, ctx, views: int):
        wl, cfg, dev = ctx.workload, ctx.config, ctx.device
        self.mesh = D.mesh_of(cfg, dev)
        if len(self.mesh) > 1 and views == 0:
            raise ValueError(
                f"{ctx.cell}: a mesh of {len(self.mesh)} cards spreads "
                f"views, and the traffic sends one frame a call")
        self.views = views
        self.per_call = max(views, 1)
        self.n_inputs = wl["pool"] // self.per_call
        self.depth, self.normals = dolly_pool(
            *ctx.frame_shape, wl["pool"], ctx.seed, cfg["camera"], dev,
            n_spheres=wl["n_spheres"], dolly_step=wl["dolly_step"],
            with_normals=cfg["ao"]["use_normals"])
        self.engine = D.engine_of(cfg, dev)

    def inputs(self, k):
        """``(pool index or slice, depth, normals or None)`` of call
        ``k``."""
        i = k % self.n_inputs
        n = self.normals
        if self.views == 0:
            return i, self.depth[i], None if n is None else n[i]
        sl = slice(i * self.views, (i + 1) * self.views)
        return sl, self.depth[sl], None if n is None else n[sl]

    def __call__(self, k):
        _, d, n = self.inputs(k)
        if self.views == 0:
            return self.engine.render(d, normals=n)
        if len(self.mesh) > 1:
            return self.engine.render_views(d, normals=n, mesh=self.mesh)
        return self.engine.render_views(d, normals=n)


def run(ctx, views: int) -> dict:
    """The loop with ``views`` frames a call (``Cell``); raises where the
    configuration has more than one card and ``views`` is 0."""
    import torch

    wl = ctx.workload
    call = Cell(ctx, views)
    mesh, per_call = call.mesh, call.per_call

    for k in range(max(wl["warmup_calls"], call.n_inputs)):
        out = call(k)
    D.sync(mesh)
    del out
    setup_peak = D.peak(mesh)
    setup_s = time.perf_counter() - ctx.t0

    gc.collect()
    due = stats.sample_times(ctx.seconds, wl["samples"], ctx.seed)
    lat, issue, samples = [], [], []
    base = D.allocated(mesh)
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
            idx = call.inputs(k)[0]
            host = out.cpu()
            if views == 0:
                samples.append((idx, host))
            else:
                samples.extend((j, host[j - idx.start])
                               for j in range(idx.start, idx.stop))
        del out
        k += 1
        if t2 - start >= ctx.seconds:
            break
    window_s = time.perf_counter() - start
    peak = D.peak(mesh)
    fullest = max(range(len(peak)), key=peak.__getitem__)
    ctx.notes.append("frame_ms by thirds of the window " + " ".join(
        repr(x) for x in _thirds(lat, per_call)))
    rec = {"setup_s": setup_s, "window_s": window_s, "calls": k,
           "frames": k * per_call, "call_latencies_s": lat,
           "attempted": k * per_call, "failed": 0,
           "peak_window_bytes": peak[fullest] - base[fullest],
           "peak_bytes_by_card": peak}
    if len(peak) > 1:
        ctx.notes.append(f"window peak bytes by card {peak} at start {base}")
    if ctx.trace:
        n = wl["trace_calls"]
        rec["host_issue_s"] = issue
        rec["profile"] = profile_calls(call, n, k, mesh)
        rec["profile"]["frames"] = n * per_call
        if len(peak) > 1:
            ctx.notes.append("busy s by card " + json.dumps(
                rec["profile"]["busy_s_by_card"], sort_keys=True))
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


def _thirds(lat, per_call: int) -> list[float]:
    """ms a frame over each third of the calls, to tell drift within a
    run from spread between runs."""
    n = len(lat) // 3 or 1
    parts = [lat[:n], lat[n:2 * n], lat[2 * n:]]
    return [sum(p) * 1e3 / (len(p) * per_call) for p in parts if p]


def profile_calls(call, n: int, k0: int, mesh) -> dict:
    """``profiling.summarize`` of ``n`` calls under torch.profiler, each
    call a span ``aobench.call`` holding ``aobench.entry`` and
    ``aobench.sync`` (every card of ``mesh``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from aobench.profiling import summarize

    acts = [ProfilerActivity.CPU]
    if D.cards(mesh):
        acts.append(ProfilerActivity.CUDA)
    D.sync(mesh)
    with profile(activities=acts) as prof:
        for k in range(k0, k0 + n):
            with record_function("aobench.call"):
                with record_function("aobench.entry"):
                    out = call(k)
                with record_function("aobench.sync"):
                    D.sync(mesh)
                del out
    return summarize(prof, "aobench.call")

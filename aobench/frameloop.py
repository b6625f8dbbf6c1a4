"""A closed loop of frames through the engine: one caller, each call
synchronised before the next (``traffic/stream.py``, ``traffic/rig.py``).

Set-up makes the pool on the device from the seed, builds the engine and
warms it on every pool entry the window will send.  The window calls until
``seconds`` have passed, recording each call's latency on the host clock
from the call to its synchronised result, and copies the outputs due at
sample times drawn from the seed to the host after the call's latency is
taken.  Peak memory is read over the window, beyond what was allocated at
its start (the pool).  A traced run records the benchmark's own span around
each entry call (ended before the synchronise) over the window, then
profiles ``trace_calls`` more calls.
"""

from __future__ import annotations

import gc
import time

from aobench import device as D
from aobench import stats
from aobench.scenes import dolly_pool


def run(ctx, views: int) -> dict:
    """The loop with ``views`` frames a call: 0 sends one (H, W) frame a
    call through ``engine.render``, V > 0 sends (V, H, W) through
    ``engine.render_views``."""
    import torch

    wl, cfg, dev = ctx.workload, ctx.config, ctx.device
    h, w = ctx.frame_shape
    n_pool = wl["pool"]
    depth, normals = dolly_pool(
        h, w, n_pool, ctx.seed, cfg["camera"], dev,
        n_spheres=wl["n_spheres"], dolly_step=wl["dolly_step"],
        with_normals=cfg["ao"]["use_normals"])
    engine = D.engine_of(cfg, dev)
    per_call = max(views, 1)
    n_inputs = n_pool // per_call

    def inputs(k):
        i = k % n_inputs
        if views == 0:
            return i, depth[i], None if normals is None else normals[i]
        sl = slice(i * views, (i + 1) * views)
        return sl, depth[sl], None if normals is None else normals[sl]

    def call(k):
        _, d, n = inputs(k)
        if views == 0:
            return engine.render(d, normals=n)
        return engine.render_views(d, normals=n)

    for k in range(max(wl["warmup_calls"], n_inputs)):
        out = call(k)
    D.sync(dev)
    del out
    setup_peak = D.peak(dev)
    setup_s = time.perf_counter() - ctx.t0

    gc.collect()
    due = stats.sample_times(ctx.seconds, wl["samples"], ctx.seed)
    lat, issue, samples = [], [], []
    base = D.allocated(dev)
    D.reset_peak(dev)
    start = time.perf_counter()
    k = 0
    while True:
        t0 = time.perf_counter()
        out = call(k)
        t1 = time.perf_counter()
        D.sync(dev)
        t2 = time.perf_counter()
        lat.append(t2 - t0)
        issue.append(t1 - t0)
        if due and t2 - start >= due[0]:
            due.pop(0)
            idx = inputs(k)[0]
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
    peak = D.peak(dev)
    ctx.notes.append("frame_ms by thirds of the window " + " ".join(
        repr(x) for x in _thirds(lat, per_call)))
    rec = {"setup_s": setup_s, "window_s": window_s, "calls": k,
           "frames": k * per_call, "call_latencies_s": lat,
           "attempted": k * per_call, "failed": 0,
           "peak_window_bytes": peak - base}
    if ctx.trace:
        rec["host_issue_s"] = issue
        rec["profile"] = profile_calls(call, wl["trace_calls"], k, dev)
        rec["profile"]["frames"] = wl["trace_calls"] * per_call
    rec["device"] = D.entry(dev, max(setup_peak, peak), rec.get("profile"))
    del engine
    if dev.startswith("cuda"):
        torch.cuda.empty_cache()
    rec["samples"] = samples
    rec["pool"] = (depth, normals)
    return rec


def _thirds(lat, per_call: int) -> list[float]:
    """ms a frame over each third of the calls, to tell drift within a
    run from spread between runs."""
    n = len(lat) // 3 or 1
    parts = [lat[:n], lat[n:2 * n], lat[2 * n:]]
    return [sum(p) * 1e3 / (len(p) * per_call) for p in parts if p]


def profile_calls(call, n: int, k0: int, dev: str) -> dict:
    """``profiling.summarize`` of ``n`` calls under torch.profiler, each
    call a span ``aobench.call`` holding ``aobench.entry`` and
    ``aobench.sync``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from aobench.profiling import summarize

    acts = [ProfilerActivity.CPU]
    if dev.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    D.sync(dev)
    with profile(activities=acts) as prof:
        for k in range(k0, k0 + n):
            with record_function("aobench.call"):
                with record_function("aobench.entry"):
                    out = call(k)
                with record_function("aobench.sync"):
                    D.sync(dev)
                del out
    return summarize(prof, "aobench.call")

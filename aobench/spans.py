"""The program's own spans, on the host and on the device trace's clock.

The port records spans and counters inside its frame path when its tracing
is on (``tpuao_torch.utils.trace``: ``ao_entry.*``, ``ao_prepare``,
``ao_slopes``, the stages ``ao_render_l*``, ``ao_upsample_l*``,
``ao_fused_l*``, and ``ao_launch`` under each stage).  ``trace_program``
runs calls with it on twice: without the profiler, for the host times
(``host``), and under torch.profiler, where ``join`` puts the spans on the
profiler's clock by the trace's anchor.  Both read, per frame:

* ``spans``: each span name's ``[count, total ms, self ms]`` (self: less
  what its child spans cover);
* ``launches``: the ``ao_launch`` spans by the stage they sit in;
* ``entry_host_ms``: the benchmark's ``aobench.entry`` span, for the share
  the program's spans name.

The profiled pass reads besides:

* ``device_ms``: device time by the innermost stage or prologue span open
  when its launch was issued (the runtime event joined to the kernel by
  correlation id), ``outside`` where none was open, ``unjoined`` where the
  trace holds no runtime event for it;
* ``idle_ms``: the device's idle gaps inside the ``aobench.call`` window,
  each by the innermost program span open at its middle, or ``outside``
  (the benchmark's loop and synchronise).

The profiler slows the host and adds records of its own to every aten op,
so the host times of the readers (``entry_self_ms``) come from the pass
without it; ``issue_idle_ms`` comes from the profiled one.

The frame loop of a traced run (``frameloop.run``) makes this phase once,
after the window and its profiled calls, on the window's own call (its
engine, pool and mesh), keeps it in the record and prints it as the
``program_trace`` line on standard error; ``program_trace(rec)`` is what
the readers of these metrics call.  Off the card, and with a program
without ``tpuao_torch.utils.trace``, there are no spans to read: nothing
is run and every reader finds nothing.
"""

from __future__ import annotations

import re
import time

from aobench import device as D
from aobench.profiling import SPAN_PREFIX, _label_gaps, _merge

OUTSIDE = "outside"
UNJOINED = "unjoined"
LAUNCH = "ao_launch"
ENTRY_PREFIX = "ao_entry."
# the CUDA API calls (cudaLaunchKernel, cuLaunchKernel, ...):
# their correlation ids are the device records'; a torch op's are its own
RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def events(prof):
    """``(kind, name, start ns, end ns, correlation id)`` of every record
    of a torch.profiler run: ``"device"`` (kernels, copies, fills; the
    device's copies of annotations left out), ``"runtime"`` (the CUDA API
    calls that issue them) or ``"host"``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if e.is_user_annotation() or name.startswith(SPAN_PREFIX):
                continue
            kind = "device"
        elif RUNTIME.match(name):
            kind = "runtime"
        else:
            kind = "host"
        yield kind, name, e.start_ns(), e.end_ns(), e.correlation_id()


def _frames(spans) -> int:
    """Frames of the top-level entry spans."""
    return sum(r.frames for r in spans
               if r.parent < 0 and r.name.startswith(ENTRY_PREFIX))


def _table(spans, frames: int) -> tuple[dict, dict]:
    """``(spans, launches)`` of ``join``'s reading, per frame."""
    from tpuao_torch.utils.trace import self_ns

    ms = 1e-6 / frames
    table: dict[str, list] = {}
    launches: dict[str, int] = {}
    for r, own in zip(spans, self_ns(spans)):
        row = table.setdefault(r.name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (r.end_ns - r.start_ns) * ms
        row[2] += own * ms
        if r.name == LAUNCH and r.parent >= 0:
            stage = spans[r.parent].name
            launches[stage] = launches.get(stage, 0) + 1
    return table, {k: v / frames for k, v in launches.items()}


def host(spans, entry_ns: int, calls: int, dropped: int = 0) -> dict | None:
    """The per-frame host readings of ``spans`` recorded without the
    profiler over ``calls`` calls whose entry took ``entry_ns`` in all;
    None without a frame."""
    frames = _frames(spans)
    if not frames:
        return None
    table, launches = _table(spans, frames)
    return {"frames": frames, "calls": calls, "dropped": dropped,
            "spans": table, "launches": launches,
            "entry_host_ms": entry_ns * 1e-6 / frames}


def join(spans, anchor, evs, dropped: int = 0) -> dict | None:
    """The per-frame readings of ``spans`` (``tpuao_torch.utils.trace``
    records, on ``time.perf_counter_ns()``) against ``evs`` (``events``),
    with ``anchor`` ``(epoch ns, perf ns)``; None without a frame."""
    frames = _frames(spans)
    if not frames:
        return None
    evs = list(evs)
    # one base for both clocks keeps the times small (exact as floats)
    base = min([s for _, _, s, _, _ in evs] + [anchor[0]])
    shift = anchor[0] - anchor[1] - base
    sp = [(r.start_ns + shift, r.end_ns + shift, r.name) for r in spans]
    ms = 1e-6 / frames
    table, launches = _table(spans, frames)

    runtime = {c: s - base for k, _, s, _, c in evs if k == "runtime"}
    device = sorted((runtime.get(c), e - s) for k, _, s, e, c in evs
                    if k == "device" and c in runtime)
    device_ms = {UNJOINED: sum((e - s) * ms for k, _, s, e, c in evs
                               if k == "device" and c not in runtime)}
    # a launch's own span is not a stage: label by the spans around it
    stages = [x for x in sp if x[2] != LAUNCH]
    for (t, dur), label in zip(device, _label_gaps(
            [(t, t) for t, _ in device], stages)):
        label = OUTSIDE if label == "host" else label
        device_ms[label] = device_ms.get(label, 0.0) + dur * ms
    if not device_ms[UNJOINED]:
        del device_ms[UNJOINED]

    win = [(s - base, e - base) for k, n, s, e, _ in evs
           if k == "host" and n == "aobench.call"]
    entry = sum(e - s for k, n, s, e, _ in evs
                if k == "host" and n == "aobench.entry")
    idle_ms: dict[str, float] = {}
    busy_ns = window_ns = 0
    if win:
        w0, w1 = min(s for s, _ in win), max(e for _, e in win)
        busy = _merge([(max(s - base, w0), min(e - base, w1))
                       for k, _, s, e, _ in evs
                       if k == "device" and e - base > w0 and s - base < w1])
        busy_ns = sum(e - s for s, e in busy)
        window_ns = w1 - w0
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        gaps = sorted(((edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]),
                      key=lambda g: (g[0] + g[1]) / 2)
        for (s, e), label in zip(gaps, _label_gaps(gaps, sp)):
            label = OUTSIDE if label == "host" else label
            idle_ms[label] = idle_ms.get(label, 0.0) + (e - s) * ms
    return {"frames": frames, "calls": len(win), "dropped": dropped,
            "spans": table, "launches": launches,
            "device_ms": device_ms, "idle_ms": idle_ms,
            "entry_host_ms": entry * ms, "window_ms": window_ns * ms,
            "busy_ms": busy_ns * ms}


def trace_program(call, n: int, k0: int, mesh) -> dict | None:
    """Calls ``k0 .. k0 + n - 1`` run twice with the program's tracing on:
    first without the profiler, timing each call to its return on the
    host clock and synchronising every card of ``mesh`` after it
    (``host``), then under torch.profiler, each call a span
    ``aobench.call`` holding ``aobench.entry`` and ``aobench.sync`` (as
    ``frameloop.profile_calls`` runs them), read by ``join``.  ``join``'s
    reading with ``host`` in it; None off the card, or where the program
    has no spans."""
    if not D.cards(mesh):
        return None
    try:
        from tpuao_torch.utils import trace
    except ImportError:
        return None
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    D.sync(mesh)
    entry_ns = 0
    trace.enable()
    try:
        for k in range(k0, k0 + n):
            t0 = time.perf_counter_ns()
            out = call(k)
            entry_ns += time.perf_counter_ns() - t0
            D.sync(mesh)
            del out
    finally:
        trace.disable()
        plain = trace.take()
    trace.enable()
    try:
        with profile(activities=acts) as prof:
            for k in range(k0, k0 + n):
                with record_function("aobench.call"):
                    with record_function("aobench.entry"):
                        out = call(k)
                    with record_function("aobench.sync"):
                        D.sync(mesh)
                    del out
    finally:
        trace.disable()
        rec = trace.take()
    res = join(rec["spans"], rec["anchor"], events(prof), rec["dropped"])
    if res is not None:
        res["host"] = host(plain["spans"], entry_ns, n, plain["dropped"])
    return res


def program_trace(rec: dict) -> dict | None:
    """The record's program trace, which the frame loop of a traced run
    made (``frameloop.run``); None without one."""
    return rec.get("program_trace")

"""Reading a torch.profiler sub-window: device busy time, kernels by name,
and the device's idle gaps named by what the host was doing.

The benchmark marks its own spans with ``record_function("aobench.<x>")``
around its calls into the program; the profiler records them beside the
program's own host operations and every device operation (kernels, copies,
fills) on one clock.
"""

from __future__ import annotations

import re

SPAN_PREFIX = "aobench."
COPY_RE = re.compile(r"^(Memcpy|Memset)")


def short_name(name: str) -> str:
    """A kernel's name without ``void``, its argument list and
    ``(anonymous namespace)::``, at most 80 characters."""
    name = name.replace("(anonymous namespace)::", "")
    return re.sub(r"^void |\(.*$", "", name)[:80]


def _merge(intervals):
    """The union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _label_gaps(gaps, host_events):
    """For each gap (start, end), the innermost benchmark span and the
    innermost host operation open at its middle:
    ``"<span> > <op>"``, ``"<span>"`` or ``"host"``."""
    events = sorted(host_events, key=lambda e: e[0])
    labels, active, i = [], [], 0
    for s, e in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        t = (s + e) / 2
        while i < len(events) and events[i][0] <= t:
            active.append(events[i])
            i += 1
        active = [ev for ev in active if ev[1] >= t]
        spans = [ev for ev in active if ev[2].startswith(SPAN_PREFIX)]
        ops = [ev for ev in active if not ev[2].startswith(SPAN_PREFIX)]
        span = min(spans, key=lambda ev: ev[1] - ev[0])[2] if spans else None
        op = min(ops, key=lambda ev: ev[1] - ev[0])[2] if ops else None
        if span and op:
            labels.append(f"{span} > {op}")
        else:
            labels.append(span or op or "host")
    return labels


def _events(prof):
    """``(name, start s, end s, card)`` of every recorded event, ``card``
    the device's index for an operation on a card and None on the host,
    read from the profiler's raw records (building its event tree takes
    minutes for a few thousand calls); the device's copies of the
    benchmark's spans are left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_device = e.device_type() == cuda
        if on_device and (e.is_user_annotation()
                          or name.startswith(SPAN_PREFIX)):
            continue
        yield (name, e.start_ns() / 1e9, e.end_ns() / 1e9,
               e.device_index() if on_device else None)


def summarize(prof, window_span: str) -> dict:
    """What a sub-window's trace says.

    ``window_s``: from the first start to the last end of the spans named
    ``window_span`` (e.g. ``aobench.call``); ``busy_s``: the seconds in that
    window in which any operation ran on the device (the union of the
    device intervals, every card's together); ``busy_s_by_card``:
    ``{card index: seconds}``, the same union taken for each card alone;
    ``kernels``: ``{name: [launches, seconds]}`` of the
    kernels, ``copies`` the same of the copies and fills; ``idle``: ``{label: seconds}`` of the device's idle
    gaps inside the window, each named by ``_label_gaps``.  Times are in
    seconds."""
    dev_iv, host, kernels, copies, win = [], [], {}, {}, []
    for name, s, en, card in _events(prof):
        if card is not None:
            dev_iv.append((s, en, card))
            table = copies if COPY_RE.match(name) else kernels
            n, t = table.get(short_name(name), (0, 0.0))
            table[short_name(name)] = (n + 1, t + (en - s))
        else:
            host.append((s, en, name))
            if name == window_span:
                win.append((s, en))
    if not win:
        raise RuntimeError(f"no {window_span} span in the trace")
    w0, w1 = min(s for s, _ in win), max(e for _, e in win)
    inside = [(max(s, w0), min(e, w1), c) for s, e, c in dev_iv
              if e > w0 and s < w1]
    busy = _merge([(s, e) for s, e, _ in inside])
    busy_s = sum(e - s for s, e in busy)
    busy_s_by_card = {
        c: sum(e - s for s, e in _merge([(s, e) for s, e, d in inside
                                         if d == c]))
        for c in sorted({c for _, _, c in inside})}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle: dict[str, float] = {}
    for (s, e), label in zip(sorted(gaps, key=lambda g: (g[0] + g[1]) / 2),
                             _label_gaps(gaps, host)):
        idle[label] = idle.get(label, 0.0) + (e - s)
    return {"window_s": w1 - w0, "busy_s": busy_s,
            "busy_s_by_card": busy_s_by_card,
            "kernels": {k: [n, t] for k, (n, t) in kernels.items()},
            "copies": {k: [n, t] for k, (n, t) in copies.items()},
            "idle": idle}


def breakdown(summary: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the idle gaps by what the host was doing, at most
    ``top`` each, in seconds as measured."""
    ops = {**summary["kernels"], **summary["copies"]}
    dev = sorted(((k, t) for k, (_, t) in ops.items()), key=lambda kv: -kv[1])
    idle = sorted(summary["idle"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k, t] for k, t in dev[:top]],
            "idle_gaps": [[k, t] for k, t in idle[:top]]}

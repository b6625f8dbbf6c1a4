"""Spans and counters of the frame path, off by default.

The port's one span system.  A span site reads the module flag ``ON`` and
opens nothing while it is off::

    with trace.span(f"ao_render_l{l}") if trace.ON else trace.OFF:
        ...

so that tracing off costs one flag read and a no-op context: no clock
read, no record, no string formatted.  ``enable()`` turns it on; each span
is then one ``Record`` in an in-memory list of at most ``cap`` records
(records past the cap are counted as ``dropped``), and ``take()`` returns
and clears them.

The spans of the frame path (names as the JAX package's named scopes,
where it has the stage):

* ``ao_entry.render_frame``, ``ao_entry.render_views``,
  ``ao_entry.render_sections``: the entry points
  (``models/pipeline.render_frame``, ``parallel/sharding.
  render_views_sharded``, ``parallel/sections.render_frame_sections`` and
  its fused form), counting the call's ``frames``;
* ``ao_prepare`` (the prologue, ``ops/kernels.prepare_levels``: pad,
  linearise, pyramid and the slope levels, one launch on the card) and
  ``ao_slopes`` (the rest of the normals branch: the raw-normals pyramid
  under ``"pallas"``) in ``models/pipeline.ao_pipeline``;
* ``ao_render_l{l}``, ``ao_upsample_l{l}``, ``ao_fused_l{l}``: each level's
  render and each chain step (``l`` the level read);
* ``ao_launch``: one call into the kernel library (``ops/kernels._launch``).
  The launches of a stage are its ``ao_launch`` children;
* ``ao_graph_capture`` and ``ao_graph_replay`` under
  ``ao_entry.render_frame`` (``models/frame_graph``): a frame's capture
  in a CUDA graph, which holds the stages above, and its replay, which
  holds none (copy-in, replay, the output);
* ``ao_scatter`` and ``ao_gather`` under ``ao_entry.render_views``
  (``parallel/sharding.render_views_sharded`` over a mesh of more than
  one device): one device's shard copies (one a device a call, before
  that device's ``ao_entry.render_frame``), and the gather of the shards'
  results on the mesh's first device with the crop of the padding;
* ``ao_section`` and ``ao_section_keep`` under ``ao_entry.render_sections``
  (``parallel/sections``): one section's frame program (which holds the
  prologue and stage spans above; the sections call ``ao_pipeline``
  directly, never a graph), and inside it the composite, quantise and
  copy of that section's kept rows into the output.

Times are ``time.perf_counter_ns()``.  ``enable()`` takes one anchor pair
``(time.time_ns(), time.perf_counter_ns())``: torch.profiler's events are
on the epoch clock (``time.time_ns()``), so a span's start plus
``anchor[0] - anchor[1]`` is its start on the profiler's clock.

Each thread keeps its own stack of open spans, so a span's parent is the
span open around it in its own thread.  A span still open when ``take()``
or ``enable()`` clears the list is left out of the next one: its end is
not written, and the spans opened inside it after the clear have no
parent.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

ON = False
CAP = 1_000_000


class Record(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    parent: int  # index of the enclosing span in the same take(), -1 none
    frames: int  # frames of the call (the entry spans), else 0


_records: list = []  # [name, start, end, parent, frames], end 0 if open
_dropped = 0
_cap = CAP
_gen = 0  # bumped by every clear of _records
_anchor: tuple[int, int] | None = None
_local = threading.local()


class _Off:
    """The shared no-op context of a span site while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


class span:
    """A span named ``name`` (of a call of ``frames`` frames, for an entry
    span), recorded from ``__enter__`` to ``__exit__`` (call it only while
    ``ON``)."""

    __slots__ = ("_name", "_frames", "_index", "_gen", "_stack")

    def __init__(self, name: str, frames: int = 0):
        self._name = name
        self._frames = frames

    def __enter__(self):
        global _dropped
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        parent = up._index if up is not None and up._gen == _gen else -1
        self._gen = _gen
        if len(_records) < _cap:
            self._index = len(_records)
            _records.append([self._name, time.perf_counter_ns(), 0, parent,
                             self._frames])
        else:
            _dropped += 1
            self._index = -1
        stack.append(self)
        self._stack = stack
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._stack.pop()
        if self._index >= 0 and self._gen == _gen:  # not dropped nor taken
            _records[self._index][2] = end
        return False


def _clear() -> None:
    global _dropped, _gen
    _records.clear()
    _dropped = 0
    _gen += 1


def enable(cap: int = CAP) -> None:
    """Turn tracing on with an empty list of at most ``cap`` records, and
    take the clock anchor."""
    global ON, _cap, _anchor
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    _clear()
    _cap = int(cap)
    _anchor = (time.time_ns(), time.perf_counter_ns())
    ON = True


def disable() -> None:
    """Turn tracing off; what was recorded stays for ``take()``."""
    global ON
    ON = False


def take() -> dict:
    """``{"spans": [Record], "dropped": n, "anchor": (epoch ns, perf
    ns)}`` of what was recorded since ``enable()`` or the last ``take()``,
    which is cleared.  Take between top-level calls: a span still open has
    ``end_ns`` 0."""
    out = {"spans": [Record(*r) for r in _records], "dropped": _dropped,
           "anchor": _anchor}
    _clear()
    return out


def self_ns(spans) -> list[int]:
    """Each span's self time: its duration less the part of it that its
    child spans cover, in ns."""
    children: dict[int, list] = {}
    for r in spans:
        if r.parent >= 0:
            children.setdefault(r.parent, []).append((r.start_ns, r.end_ns))
    out = []
    for i, r in enumerate(spans):
        covered, reach = 0, r.start_ns
        for s, e in sorted(children.get(i, ())):
            s, e = max(s, reach), min(e, r.end_ns)
            if e > s:
                covered += e - s
                reach = e
        out.append(r.end_ns - r.start_ns - covered)
    return out

"""``render_frame``'s launches, replayed from a CUDA graph.

A 1080p frame's 6 launches (the prologue and 5 render and chain kernels
of ``ops/kernels.py``) run on the card in under 0.1 ms, while issuing them
one by one from Python takes several times that.  So ``models/pipeline.render_frame``
asks ``replay`` first: it captures the frame program (``ao_pipeline``'s
primary output) once per key in a CUDA graph and replays it.  The graph
runs the same launches with the same arguments as the eager path, so its
output is bit-equal to it.

When it engages is read from the call, with no switch:

* a CUDA depth tensor, no tensor that requires grad under autograd, no
  ``debug_outputs``, no stream capture running on the current stream (a
  caller's own capture, as in ``utils/timing.cuda_graph_ms``) and no
  tensor tunable;
* a key's first call runs eager (it builds the library, fills the tile
  table's caches and the allocator, and a one-off frame pays no capture);
  its second captures and replays; later ones replay.

Every other call runs the eager path, counted by its reason in
``graph_counts()``: ``cpu``, ``grad``, ``debug``, ``capturing``,
``tensor_params``, ``first_sight``; ``evicted`` for a key whose graph the
cache let go (it runs eager from then on, so keys that outnumber the
cache cost the eager path and not a capture a call); ``budget`` for a
second call while the captures beyond the first ``MAX_ENTRIES`` outrun
one per ``PAYBACK`` replays (so fresh keys, each seen twice, cannot make
every other call a capture); and ``uncapturable`` for a key whose capture
raised (with a warning, once).

The key is everything the host reads to decide a launch: the device, the
depth's and the normals' shape, dtype and strides, the values of
``camera`` and ``params``, ``impl`` and the tile table's generation
(``utils/launch_opts.generation``).  Each entry holds its graph, its own
memory pool, its static inputs and output, a lock and an event: a call
copies its depth and normals into the static inputs on the current
stream, replays, hands back a fresh output (the composite or quantise
makes one, else a clone) and records the event, which the next call
waits on, so two threads on two streams never share the buffers at once.
The cache is an LRU of at most ``MAX_ENTRIES`` entries, whose pools on
each card hold at most an eighth of that card's memory (``pool_bytes()``
sums them over every card); an evicted graph is freed when its last
replay lets go of it.

A capture launches nothing, so the wrappers count its launches into the
capturing thread's tally (``ops/kernels.tally_launches``), and each
replay adds them to ``ops/kernels.launch_counts()``: the counts keep
meaning kernels the card ran, whatever other threads launch meanwhile.
"""

from __future__ import annotations

import threading
import warnings
from collections import OrderedDict

import numpy as np
import torch

from tpuao_torch.ops import kernels as K
from tpuao_torch.utils import launch_opts as L
from tpuao_torch.utils import trace

MAX_ENTRIES = 32
POOL_SHARE = 8  # the pools may hold 1 / POOL_SHARE of the card's memory
# replays that pay for a capture beyond the first MAX_ENTRIES: a capture
# costs 8-43 ms, a replay saves 0.3-0.5 ms of the eager issue
PAYBACK = 64
REASONS = ("cpu", "grad", "debug", "capturing", "tensor_params",
           "first_sight", "evicted", "budget", "uncapturable")


class _Entry:
    """One captured frame program and its static buffers."""

    __slots__ = ("graph", "depth", "normals", "ao", "launches", "nbytes",
                 "lock", "done", "device")

    def __init__(self, graph, depth, normals, ao, launches, nbytes):
        self.graph = graph
        self.depth = depth
        self.normals = normals
        self.ao = ao
        self.launches = launches  # the capture's kernels.tally_launches
        self.nbytes = nbytes
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()


_entries: OrderedDict = OrderedDict()  # key -> _Entry, least recent first
# key -> True (seen once), "evicted" or "uncapturable", least recent first
_seen: OrderedDict = OrderedDict()
_lock = threading.Lock()  # guards both dicts and serialises captures
_tally = threading.Lock()  # guards the counts
_counts = {"captures": 0, "replays": 0}
_eager = dict.fromkeys(REASONS, 0)


def graph_counts() -> dict:
    """``{"captures": n, "replays": n, "eager": {reason: n}}`` since the
    last ``_clear()``; a capturing call counts as a capture and a
    replay."""
    return {**_counts, "eager": dict(_eager)}


def pool_bytes() -> int:
    """The device bytes that the cached entries' pools reserved."""
    with _lock:
        return sum(e.nbytes for e in _entries.values())


def _clear() -> None:
    """Drop every entry and every key seen, and zero the counts (tests
    that must see the eager path)."""
    with _lock:
        _entries.clear()
        _seen.clear()
        _counts.update(captures=0, replays=0)
        _eager.update(dict.fromkeys(REASONS, 0))


# the field types of a camera or params whose values a key can hold
_PLAIN = {float, int, bool, str, type(None), np.float32, np.float64,
          np.int32, np.int64, np.bool_}


def _tensor_valued(*objs) -> bool:
    """Whether a field of ``objs`` holds other than a plain value (a
    tensor or an array): a capture would read its value once."""
    for o in objs:
        for v in vars(o).values():
            if type(v) not in _PLAIN:
                return True
    return False


def _on_card(depth) -> bool:
    return depth.device.type == "cuda"


def _why_eager(depth, normals, camera, params, debug: bool) -> str | None:
    if not _on_card(depth):
        return "cpu"
    if K.needs_grad((depth, normals), params):
        return "grad"
    if debug:
        return "debug"
    if torch.cuda.is_current_stream_capturing():
        return "capturing"
    if _tensor_valued(camera, params):
        return "tensor_params"
    return None


def _layout(x):
    return None if x is None else (tuple(x.shape), x.dtype, x.stride())


def _key(depth, normals, camera, params, impl: str) -> tuple:
    """What the host reads to decide the frame's launches."""
    return (depth.device, _layout(depth), _layout(normals), camera, params,
            impl, L.generation())


def _capture(depth, normals, program) -> _Entry:
    """Capture ``program(depth_static, normals_static)`` on a stream of
    its own, in a new memory pool on the depth's device; the wrappers'
    launches go to the entry's tally."""
    dev = depth.device
    reserved = torch.cuda.memory_reserved(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(dev), K.tally_launches() as launches:
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                d = torch.empty_like(depth)
                n = None if normals is None else torch.empty_like(normals)
                ao = program(d, n)
            finally:
                graph.capture_end()
    return _Entry(graph, d, n, ao, dict(launches),
                  torch.cuda.memory_reserved(dev) - reserved)


def _bound(device) -> int:
    return torch.cuda.get_device_properties(device).total_memory // POOL_SHARE


def _mark(key, state) -> None:
    """Note ``key`` as the most recent key seen, in ``state``; the least
    recent beyond ``4 * MAX_ENTRIES`` are forgotten."""
    _seen[key] = state
    _seen.move_to_end(key)
    while len(_seen) > 4 * MAX_ENTRIES:
        _seen.popitem(last=False)


def _insert(key, entry: _Entry, device) -> None:
    """Add ``entry``, captured on ``device``, as the most recent, then
    evict the least recent entries while the cache holds more than
    ``MAX_ENTRIES``, and the least recent entries on ``device`` while
    their pools hold more than its share of that card: one card's pools
    never evict another card's graphs (the newest always stays).  An
    evicted key runs eager from then on."""
    entry.device = device
    _entries[key] = entry
    while len(_entries) > MAX_ENTRIES:
        _mark(_entries.popitem(last=False)[0], "evicted")
    mine = [k for k, e in _entries.items() if e.device == device]
    held = sum(_entries[k].nbytes for k in mine)
    bound = _bound(device)
    for k in mine[:-1]:
        if held <= bound:
            break
        held -= _entries.pop(k).nbytes
        _mark(k, "evicted")


def _entry_for(key, depth, normals, program):
    """``(entry, reason)``: the key's entry, captured now on its second
    call, or None and why the call runs eager."""
    with _lock:
        entry = _entries.get(key)
        if entry is not None:
            _entries.move_to_end(key)
            return entry, None
        state = _seen.get(key)
        _mark(key, True if state is None else state)
        if state is None:
            return None, "first_sight"
        if state is not True:  # evicted or uncapturable
            return None, state
        if _counts["captures"] >= MAX_ENTRIES + _counts["replays"] // PAYBACK:
            return None, "budget"
        try:
            with trace.span("ao_graph_capture") if trace.ON else trace.OFF:
                entry = _capture(depth, normals, program)
        except RuntimeError as exc:  # a CUDA error of the capture
            _mark(key, "uncapturable")
            warnings.warn(f"render_frame: capturing the frame of "
                          f"{tuple(depth.shape)} failed ({exc}); it runs "
                          "eager", RuntimeWarning, stacklevel=4)
            return None, "uncapturable"
        with _tally:
            _counts["captures"] += 1
        _insert(key, entry, depth.device)
        return entry, None


def replay(depth, normals, camera, params, impl: str, debug: bool, program,
           finish):
    """The frame's output from its graph, or None where the call runs the
    eager path (counted under its reason).

    ``program(depth, normals)`` is the frame program's primary output
    (captured on the key's second call); ``finish(ao)`` makes the output
    from it (composite, quantise).  ``normals`` are the call's, placed on
    the depth's device where ``params.use_normals`` reads them."""
    reason = _why_eager(depth, normals, camera, params, debug)
    if reason is None:
        normals = normals if params.use_normals else None
        entry, reason = _entry_for(
            _key(depth, normals, camera, params, impl), depth, normals,
            program)
    if reason is not None:
        with _tally:
            _eager[reason] += 1
        return None
    with trace.span("ao_graph_replay") if trace.ON else trace.OFF:
        with entry.lock:
            stream = torch.cuda.current_stream(depth.device)
            stream.wait_event(entry.done)  # the last user's stream is done
            entry.depth.copy_(depth)
            if normals is not None:
                entry.normals.copy_(normals)
            if depth.device.index == torch.cuda.current_device():
                entry.graph.replay()
            else:
                with torch.cuda.device(depth.device):
                    entry.graph.replay()
            out = finish(entry.ao)
            if out is entry.ao:
                out = out.clone()
            entry.done.record(stream)
    with _tally:
        _counts["replays"] += 1
        K.add_launches(entry.launches)
    return out

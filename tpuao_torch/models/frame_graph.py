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
raised, or whose graph could not be bound to a call's buffers (with a
warning, once).

The key is everything the host reads to decide a launch: the device, the
depth's and the normals' shape, dtype, strides and 16-byte alignment (the
prologue picks its 16-byte loads by it), the values of ``camera`` and
``params``, ``impl`` and the tile table's generation
(``utils/launch_opts.generation``).  Each entry holds its graph, its own
memory pool, its output as captured, a lock and an event.

A replay runs on the call's own buffers where the graph lets it
(``_sides``, then ``_find`` on the captured nodes): the prologue, the
one launch that reads the depth and the normals, is pointed at the
call's, and the last chain step, the one launch that writes the output,
at a fresh output tensor (``csrc/graph_bind.cu``, one call before each
replay).  Where it does not -- a depth that the prologue casts or
copies, normals that ``"pallas"`` reads with PyTorch ops, an output made
by PyTorch ops (no blur) -- that side keeps static buffers: the call
copies its depth and normals into the entry's static inputs, and the
graph's output is cloned (unless the composite or quantise makes a new
tensor of it).  ``graph_counts()`` counts each side of each replay.  A
call waits on the entry's event and records it after its replay, so two
threads on two streams never share the graph's buffers at once.
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

import ctypes
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
# a replay's sides: "bound" where it bound both its inputs and its output
SIDES = ("bound", "inputs_bound", "inputs_copied", "output_bound",
         "output_cloned")
BINDING_BYTES = 1024  # room for csrc/graph_bind.cu's GraphBinding


class _Entry:
    """One captured frame program: its graph, its output as captured, the
    static inputs a replay copies into (None where it binds the call's),
    and the call that binds the graph to a call's buffers (None where it
    binds neither side)."""

    __slots__ = ("graph", "depth", "normals", "ao", "launches", "nbytes",
                 "bind", "binds", "lock", "done", "device")

    def __init__(self, graph, depth, normals, ao, launches, nbytes,
                 bind=None, binds=(False, False)):
        self.graph = graph
        self.depth = depth
        self.normals = normals
        self.ao = ao
        self.launches = launches  # the capture's kernels.tally_launches
        self.nbytes = nbytes
        self.bind = bind  # bind(depth, normals, out) -> cudaError_t
        self.binds = binds  # (inputs, output) bound at each replay
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()


_entries: OrderedDict = OrderedDict()  # key -> _Entry, least recent first
# key -> True (seen once), "evicted" or "uncapturable", least recent first
_seen: OrderedDict = OrderedDict()
_lock = threading.Lock()  # guards both dicts and serialises captures
_tally = threading.Lock()  # guards the counts
_counts = {"captures": 0, "replays": 0, **dict.fromkeys(SIDES, 0)}
_eager = dict.fromkeys(REASONS, 0)


def graph_counts() -> dict:
    """``{"captures": n, "replays": n, <side>: n, "eager": {reason: n}}``
    since the last ``_clear()``; a capturing call counts as a capture and
    a replay.  Each replay counts once under ``inputs_bound`` or
    ``inputs_copied``, once under ``output_bound`` or ``output_cloned``
    (the graph wrote its own output), and under ``bound`` where it bound
    both."""
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
        _counts.update(dict.fromkeys(_counts, 0))
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
    return None if x is None else (tuple(x.shape), x.dtype, x.stride(),
                                   x.data_ptr() % 16 == 0)


def _key(depth, normals, camera, params, impl: str) -> tuple:
    """What the host reads to decide the frame's launches."""
    return (depth.device, _layout(depth), _layout(normals), camera, params,
            impl, L.generation())


def _sides(depth, normals, params, impl: str) -> tuple[bool, bool]:
    """``(inputs, output)``: whether a replay may read the call's depth
    and normals in place, and write the call's own output.

    The inputs where the prologue kernel reads them as they come and
    nothing else reads them: a float32 depth with unit column stride
    (``kernels.prepare_levels`` casts or copies any other), float32
    normals, and not ``"jnp"`` (the plain ops) nor ``"pallas"`` with
    normals (its raw-normals pyramid reads them with PyTorch ops).  The
    output where a chain step writes it: with blur, and not ``"jnp"``.
    The captured nodes have the last word (``_find``)."""
    inputs = (impl != "jnp" and depth.dtype == torch.float32
              and depth.stride(-1) == 1
              and (normals is None or (normals.dtype == torch.float32
                                       and impl != "pallas")))
    return inputs, impl != "jnp" and bool(params.enable_blur)


def _ptr(x):
    return None if x is None else x.data_ptr()


def _find(graph, depth, normals, ao):
    """``(found, bind)``: which of the captured ``graph``'s nodes that
    touch the caller's buffers ``csrc/graph_bind.cu`` found -- 1, the
    prologue reading ``depth`` and ``normals`` (None: bind no input), plus
    2, the last chain step writing ``ao`` (None: bind no output) -- and
    ``bind(depth, normals, out)``, which points them at a call's buffers
    and returns the cudaError_t (None where it found neither)."""
    from tpuao_torch.ops import _build

    lib = _build.load()
    binding = ctypes.create_string_buffer(BINDING_BYTES)
    out = ao if ao is not None and ao.dtype == torch.float32 \
        and ao.is_contiguous() else None
    found = lib.tpuao_graph_find(
        graph.raw_cuda_graph(), _ptr(depth), _ptr(normals), _ptr(out),
        0 if out is None else out.numel(), binding, BINDING_BYTES)
    if found < 0:
        raise RuntimeError(f"tpuao_graph_find: {BINDING_BYTES} bytes are "
                           "too few for its binding")
    if not found:
        return 0, None
    fn, exec_ = lib.tpuao_graph_bind, graph.raw_cuda_graph_exec()

    def bind(depth, normals, out):
        return fn(exec_, binding, depth.data_ptr(), _ptr(normals), _ptr(out))

    return found, bind


def _record(depth, normals, program, in_place: bool):
    """``(graph, depth, normals, ao, launches, nbytes)``: ``program(depth,
    normals)`` captured on a stream of its own, in a new memory pool on
    the depth's device, and instantiated; the inputs it read (the call's
    own where ``in_place``: a capture runs nothing; else static buffers of
    their layout), its output, the wrappers' launches (the capture's
    tally) and the bytes its pool reserved."""
    dev = depth.device
    reserved = torch.cuda.memory_reserved(dev)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.device(dev), K.tally_launches() as launches:
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                d, n = depth, normals
                if not in_place:
                    d = torch.empty_like(depth)
                    n = None if normals is None else torch.empty_like(normals)
                ao = program(d, n)
            finally:
                graph.capture_end()
        graph.instantiate()
    return (graph, d, n, ao, dict(launches),
            torch.cuda.memory_reserved(dev) - reserved)


def _capture(depth, normals, program, sides) -> _Entry:
    """The entry of ``program`` captured for a call whose ``_sides`` are
    ``sides``: on the call's own inputs where they may be read in place,
    else -- also where the captured prologue turns out not to read them
    (a copy of an odd batch layout), by a second capture -- on static
    buffers."""
    in_place, output = sides
    graph, d, n, ao, launches, nbytes = _record(depth, normals, program,
                                                in_place)
    found, bind = _find(graph, d if in_place else None, n,
                        ao if output else None)
    if in_place and not found & 1:
        return _capture(depth, normals, program, (False, output))
    return _Entry(graph, None if in_place else d, None if in_place else n,
                  ao, launches, nbytes, bind,
                  (bool(found & 1), bool(found & 2)))


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


def _entry_for(key, depth, normals, program, sides=(False, False)):
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
                entry = _capture(depth, normals, program, sides)
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
        key = _key(depth, normals, camera, params, impl)
        entry, reason = _entry_for(key, depth, normals, program,
                                   _sides(depth, normals, params, impl))
    if reason is not None:
        with _tally:
            _eager[reason] += 1
        return None
    inputs, output = entry.binds
    with trace.span("ao_graph_replay") if trace.ON else trace.OFF:
        with entry.lock:
            stream = torch.cuda.current_stream(depth.device)
            stream.wait_event(entry.done)  # the last user's stream is done
            if not inputs:
                entry.depth.copy_(depth)
                if normals is not None:
                    entry.normals.copy_(normals)
            ao = entry.ao
            if output:
                ao = torch.empty(ao.shape, dtype=ao.dtype, device=ao.device)
            err = 0 if entry.bind is None else entry.bind(depth, normals, ao)
            if not err:
                if depth.device.index == torch.cuda.current_device():
                    entry.graph.replay()
                else:
                    with torch.cuda.device(depth.device):
                        entry.graph.replay()
                out = finish(ao)
                if out is entry.ao:
                    out = out.clone()
                entry.done.record(stream)
    if err:  # the key runs eager from then on, as an uncapturable one
        with _lock:
            _entries.pop(key, None)
            _mark(key, "uncapturable")
        warnings.warn(f"render_frame: binding the graph of the frame of "
                      f"{tuple(depth.shape)} to the call's buffers failed "
                      f"(CUDA error {err}); it runs eager", RuntimeWarning,
                      stacklevel=3)
        with _tally:
            _eager["uncapturable"] += 1
        return None
    with _tally:
        _counts["replays"] += 1
        _counts["inputs_bound" if inputs else "inputs_copied"] += 1
        _counts["output_bound" if output else "output_cloned"] += 1
        _counts["bound"] += inputs and output
        K.add_launches(entry.launches)
    return out

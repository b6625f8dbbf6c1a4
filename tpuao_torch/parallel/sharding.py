"""Multi-view rendering over a list of devices.

Counterpart of ``tpuao/parallel/sharding.py``.  AO is embarrassingly
parallel across views, and every kernel of the port takes a leading batch
as its grid's ``blockIdx.z``, so the views a device holds are that batch:
``render_views`` is one pass of the frame pipeline over all of them, the
same launches as one view.

The JAX package's mesh is a ``jax.sharding.Mesh`` that one process
``shard_map``s the frame program over.  Here a mesh is a tuple of
``torch.device`` (``make_mesh``), driven by one process with no
collective: ``render_views_sharded`` and the temporal fleet
``render_sequences_temporal_sharded`` split the views into one slice per
device, render each slice on its device and gather the results on the
first by device copies.  A mesh may name a device more than once (a CPU
four times in the tests, one card twice), which runs the same split, pad
and gather on fewer physical devices.

The kernels take the tunables as scalar arguments and the per-level pair
tables as launch parameters, so one launch set serves every view that
shares them: a camera rig renders one batch per distinct set of its eight
per-view values on each device.

The mesh path records spans when the port's tracing is on
(``utils/trace``): ``ao_scatter`` around each device's shard copies and
``ao_gather`` around the gather and the crop, both under
``ao_entry.render_views``.  ``mesh_counts()`` counts, always, the calls,
frames and shards of ``render_views_sharded`` and the bytes that
``_to`` copied between two distinct devices.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from tpuao_torch.models.pipeline import (_as_tensor, _check_resolve_level,
                                         _frames, ao_pipeline, render_frame,
                                         render_frame_temporal)
from tpuao_torch.params import AOParams, CameraParams, TemporalParams
from tpuao_torch.utils import trace

VIEW_AXIS = "views"

# The traced leaves of the JAX package's camera and params: one value per
# view under per_view=True.  The other fields are frame structure, global.
RIG_CAMERA_FIELDS = ("near", "far", "tan_half_fov_h")
RIG_PARAM_FIELDS = ("noise_filter_tolerance", "blur_tolerance",
                    "upsample_tolerance", "rejection_falloff", "strength")

_tally = threading.Lock()  # guards the counts
_counts = dict.fromkeys(("calls", "frames", "shards", "peer_bytes"), 0)


def mesh_counts() -> dict:
    """``{"calls", "frames", "shards", "peer_bytes"}`` since the last
    ``_clear()``: ``render_views_sharded``'s calls, their views (before
    padding) and the shards they rendered (one a device of the mesh), and
    the bytes that ``_to`` copied between two distinct devices, inputs and
    outputs alike (the spatial, grid and temporal fleet modes' copies
    too).  A mesh that names one device several times copies none."""
    with _tally:
        return dict(_counts)


def _clear() -> None:
    """Zero the counts (tests)."""
    with _tally:
        _counts.update(dict.fromkeys(_counts, 0))


def _count(**by) -> None:
    with _tally:
        for k, v in by.items():
            _counts[k] += v


def pad_leading(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad a leading axis by replicating the last entry ``pad`` times (the
    uneven-view-count alignment of the JAX package's sharded modes)."""
    if pad < 0:
        raise ValueError(f"pad must be >= 0, got {pad}")
    reps = (pad,) + (1,) * (x.ndim - 1)
    return torch.cat([x, x[-1:].repeat(reps)], dim=0)


def _views(depths, device) -> torch.Tensor:
    depths = _as_tensor(depths, device)
    if depths.ndim != 3:
        raise ValueError(f"depths must be (V, H, W), got "
                         f"{tuple(depths.shape)}")
    return depths


def render_views(depths, camera=None, params=None, normals=None,
                 impl: str = "auto", device=None) -> torch.Tensor:
    """The frame pipeline over a leading views axis: ``depths`` (V, H, W)
    [+ ``normals`` (V, H, W, 3) or (V, 3, H, W)] -> AO (V, H, W) float32.

    Tensors are computed on the device they are on; NumPy input goes to
    ``device`` (default the card; ``device="cpu"`` for the CPU).  For
    colour, ``out_dtype``, debug outputs or camera rigs use
    ``render_views_sharded``.
    """
    camera = camera or CameraParams()
    params = params or AOParams()
    return ao_pipeline(_views(depths, device), camera, params, normals,
                       impl=impl)[0]


def make_1d_mesh(axis: str, n_devices: int | None = None,
                 devices=None) -> tuple[torch.device, ...]:
    """A 1-D device mesh: a tuple of ``torch.device`` (the counterpart of
    the JAX package's ``Mesh`` over ``axis``; a tuple has one axis, so the
    name is kept for the signature only).

    By default every card, ``cuda:0 .. cuda:{count - 1}``.  ``devices``
    may name a device more than once -- ``["cpu"] * 4`` on a CPU, or
    ``["cuda:0"] * 2`` on one card -- the port's stand-in for the JAX
    package's fake CPU devices: the same split, pad, per-shard render and
    gather run, on fewer physical devices.  Raises when ``n_devices``
    exceeds the devices there are, or when the mesh would be empty."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"mesh of {n_devices} devices requested, "
                             f"have {len(devices)}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError(f"mesh over {axis!r} holds no device")
    return tuple(devices)


def make_mesh(n_devices: int | None = None,
              devices=None) -> tuple[torch.device, ...]:
    """1-D device mesh over the view axis (``make_1d_mesh``)."""
    return make_1d_mesh(VIEW_AXIS, n_devices, devices)


def _mesh_devices(mesh, device) -> tuple:
    """The mesh as a tuple of devices: ``(device,)`` for ``mesh=None``
    (one batch on ``device``, by default the card), else the mesh's, whose
    first must be ``device`` where both are given."""
    if mesh is None:
        return (device,)
    devices = tuple(torch.device(d) for d in mesh)
    if not devices:
        raise ValueError("mesh holds no device")
    if device is not None:
        a, b = torch.device(device), devices[0]
        # an index left out ("cuda") is the current card: it names any one
        indices = {a.index, b.index} - {None}
        if a.type != b.type or len(indices) > 1:
            raise ValueError(f"mesh names {b} but device={a}")
    return devices


def _on_device(dev):
    """``dev`` current for the block on a CUDA device (the kernels launch
    on their inputs' card whatever is current; allocations without a
    device follow it); nothing on the CPU."""
    if dev is not None and torch.device(dev).type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _pad_views(x, pad: int):
    """``pad_leading`` of a tensor or an array (None stays)."""
    if x is None or not pad:
        return x
    if isinstance(x, torch.Tensor):
        return pad_leading(x, pad)
    x = np.asarray(x)
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])


def _to(x: torch.Tensor, dev) -> torch.Tensor:
    """``x`` on ``dev``, without a host synchronisation where the copy
    lands on a card (a copy to the host waits for its data)."""
    dev = torch.device(dev)
    y = x.to(dev, non_blocking=dev.type == "cuda")
    if y.device != x.device:
        _count(peer_bytes=x.numel() * x.element_size())
    return y


def _shard(x, sl: slice, dev):
    """Views ``sl`` of ``x`` on ``dev`` (an array slice stays an array:
    the functions below place NumPy input themselves)."""
    if x is None or not isinstance(x, torch.Tensor):
        return None if x is None else x[sl]
    return _to(x[sl], dev)


def _gather(parts: list, dev, dim: int = 0):
    """The shards' results concatenated on ``dev`` along ``dim`` (the view
    axis by default; the row axis for the spatial modes' bands), leaf by
    leaf through tuples and dicts."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _gather([p[k] for p in parts], dev, dim) for k in first}
    if isinstance(first, tuple):
        return tuple(_gather(list(z), dev, dim) for z in zip(*parts))
    return torch.cat([_to(p, dev) for p in parts], dim=dim)


def _rig(camera, params, n: int) -> np.ndarray:
    """(V, 8) float64: each view's near, far, tan_half_fov_h and five
    tunables.  Every one must be shaped (V,)."""
    cols = []
    for obj, fields in ((camera, RIG_CAMERA_FIELDS),
                        (params, RIG_PARAM_FIELDS)):
        for f in fields:
            v = np.asarray(getattr(obj, f), np.float64)
            if v.shape != (n,):
                raise ValueError(
                    f"per_view=True needs every camera/params leaf shaped "
                    f"({n},), got {f} {v.shape}")
            cols.append(v)
    return np.stack(cols, axis=1)


def _take(x, idx: torch.Tensor):
    """Entries ``idx`` of a tensor's leading axis (None stays)."""
    return None if x is None else x.index_select(0, idx.to(x.device))


def _put(dst, idx: torch.Tensor, src, n: int):
    """Write ``src``'s leading entries into rows ``idx`` of ``dst`` (made,
    n rows, on the first write), a debug dict's leaves alike."""
    if isinstance(src, dict):
        dst = {} if dst is None else dst
        for k, v in src.items():
            dst[k] = _put(dst.get(k), idx, v, n)
        return dst
    if dst is None:
        dst = src.new_empty((n,) + tuple(src.shape[1:]))
    return dst.index_copy_(0, idx.to(src.device), src)


def _rig_scalars(camera, params, vals):
    """``camera`` and ``params`` with one rig row's eight values."""
    return (camera.replace(**dict(zip(RIG_CAMERA_FIELDS, vals[:3]))),
            params.replace(**dict(zip(RIG_PARAM_FIELDS, vals[3:]))))


def _index(members: list[int], device) -> torch.Tensor:
    """An index tensor on ``device``, copied from pinned memory on a card
    so that making it waits for nothing queued there."""
    idx = torch.tensor(members)
    if device.type == "cuda":
        return idx.pin_memory().to(device, non_blocking=True)
    return idx


def _render_local(depths, camera, params, normals, color, rig, kw):
    """One device's views: one ``render_frame`` batch, or under a rig
    (``rig`` its (V, 8) rows) one batch per distinct row, written back in
    view order."""
    if rig is None:
        return render_frame(depths, camera, params, normals, color, **kw)
    n = depths.shape[0]
    groups: dict[tuple, list[int]] = {}
    for i, row in enumerate(rig):
        groups.setdefault(tuple(row.tolist()), []).append(i)
    if len(groups) == 1:  # a uniform rig: the whole batch, in order
        return render_frame(depths, *_rig_scalars(camera, params,
                                                  next(iter(groups))),
                            normals, color, **kw)
    normals = None if normals is None else _as_tensor(normals, depths.device)
    color = None if color is None else _as_tensor(color, depths.device)
    idxs = {vals: _index(members, depths.device)
            for vals, members in groups.items()}
    acc = None
    for vals, idx in idxs.items():
        res = render_frame(depths.index_select(0, idx),
                           *_rig_scalars(camera, params, vals),
                           _take(normals, idx), _take(color, idx), **kw)
        out, dbg = res if kw["debug_outputs"] else (res, {})
        acc = _put(acc, idx, {"out": out, "dbg": dbg}, n)
    return (acc["out"], acc["dbg"]) if kw["debug_outputs"] else acc["out"]


def render_views_sharded(depths, camera=None, params=None, normals=None,
                         mesh=None, impl: str = "auto", color=None,
                         out_dtype: str = "float32",
                         debug_outputs: bool = False,
                         per_view: bool = False, device=None):
    """[BJ] config 5: ``depths`` (V, H, W) -> (V, H, W) AO (or (V, H, W, C)
    composited ``color``), with the debug dict when ``debug_outputs``,
    every leaf carrying the leading view axis.

    ``color``, ``out_dtype`` and ``debug_outputs`` are ``render_frame``'s,
    per view.  ``mesh`` is None -- one batch on ``device`` (NumPy input
    goes there, by default the card) -- or a sequence of devices
    (``make_mesh``), whose first must be ``device`` where both are given.
    Over a mesh of N devices shard i renders views [i k, (i + 1) k) on
    ``mesh[i]`` (k = V / N) as one batch, every shard's work issued before
    any host synchronisation, and no collective: AO is embarrassingly
    parallel across views.  A view count that does not divide the mesh is
    padded by replicating the last view (and, under ``per_view``, its rig
    values); the primary output is cropped back to V, the debug leaves
    keep the padded count, as in the JAX package.  The JAX package's
    result stays sharded as one global array; a process of PyTorch has no
    such tensor, so the shards are gathered on ``mesh[0]`` by device
    copies -- the counterpart of the caller's ``device_get``.

    ``per_view=True`` renders a camera rig: ``camera.near``, ``far``,
    ``tan_half_fov_h`` and the five ``PARAM_RANGES`` tunables of
    ``params`` are each shaped (V,), one value per view (any other shape
    raises ``ValueError``); the structure fields stay global.  Within a
    shard, views that share all eight values render as one batch, so a
    uniform rig costs the launches of one batch a shard and a rig of G
    distinct views G times that.

    Each batch is a ``render_frame`` call, on the card replayed from its
    CUDA graph from the second call of its key on (``models/frame_graph``).
    """
    with (trace.span("ao_entry.render_views", frames=_frames(depths))
          if trace.ON else trace.OFF):
        camera = camera or CameraParams()
        params = params or AOParams()
        devices = _mesh_devices(mesh, device)
        depths = _views(depths, devices[0])
        n = depths.shape[0]
        rig = _rig(camera, params, n) if per_view else None
        kw = dict(impl=impl, out_dtype=out_dtype,
                  debug_outputs=debug_outputs)
        n_dev = len(devices)
        _count(calls=1, frames=n, shards=n_dev)
        if n_dev == 1:
            return _render_local(depths, camera, params, normals, color, rig,
                                 kw)
        normals = (None if normals is None
                   else _as_tensor(normals, depths.device))
        color = None if color is None else _as_tensor(color, depths.device)
        pad = -(-n // n_dev) * n_dev - n
        depths, normals, color, rig = (_pad_views(x, pad)
                                       for x in (depths, normals, color, rig))
        k = (n + pad) // n_dev
        parts = []
        for i, dev in enumerate(devices):
            sl = slice(i * k, (i + 1) * k)
            with _on_device(dev):
                with trace.span("ao_scatter") if trace.ON else trace.OFF:
                    d, nrm, col = (_shard(x, sl, dev)
                                   for x in (depths, normals, color))
                parts.append(_render_local(
                    d, camera, params, nrm, col,
                    None if rig is None else rig[sl], kw))
        with trace.span("ao_gather") if trace.ON else trace.OFF:
            res = _gather(parts, devices[0])
            out, dbg = res if debug_outputs else (res, None)
            out = out[:n] if pad else out
        return (out, dbg) if debug_outputs else out


# ---------------------------------------------------------------------------
# Fleet temporal accumulation: V independent sequences over the view axis
# ---------------------------------------------------------------------------


def render_sequences_temporal_sharded(depths, camera=None, params=None,
                                      tparams=None, motions=None,
                                      normals=None, mesh=None,
                                      impl: str = "auto",
                                      out_dtype: str = "float32",
                                      resolve_level: int = 0, device=None):
    """V independent temporal sequences over a device mesh: ``depths``
    (V, T, H, W) -> the (V, T, H, W) resolved stack.

    The fleet-serving shape of the temporal mode: V cameras each streaming
    a T-frame sequence.  Shard i holds sequences [i k, (i + 1) k) on
    ``mesh[i]`` (``mesh`` and ``device`` as in ``render_views_sharded``)
    and runs ``render_sequence_temporal``'s frame step for each of them,
    the history of each sequence staying on its device.  The loop is over
    frames outside and shards inside, so every device gets its frame t
    before any gets frame t + 1.  ``motions`` is None (static cameras),
    (V, T, 4, 4) per-view eye transforms (``motions[v, t]`` maps view v's
    frame t to its frame t - 1), or per-pixel motion-vector buffers
    (V, T, H, W, 2) / (V, T, 2, H, W); ``normals`` is optional, (V, T, ...)
    per frame.  An uneven view count pads by replicating the last
    sequence and crops after; the result is gathered on ``mesh[0]``.
    ``resolve_level``: see ``render_frame_temporal``.
    """
    camera = camera or CameraParams()
    params = params or AOParams()
    tparams = tparams or TemporalParams()
    _check_resolve_level(resolve_level)
    devices = _mesh_devices(mesh, device)
    depths = _as_tensor(depths, devices[0])
    if mesh is None:  # one device: where the depths are
        devices = (depths.device,)
    if depths.ndim != 4:
        raise ValueError(f"depths must be (V, T, H, W), got "
                         f"{tuple(depths.shape)}")
    v, t_n, h_n, w_n = depths.shape
    if motions is not None:
        ok = tuple(np.shape(motions)) in ((v, t_n, 4, 4),
                                          (v, t_n, h_n, w_n, 2),
                                          (v, t_n, 2, h_n, w_n))
        if not ok:
            raise ValueError(
                f"motions must be ({v}, {t_n}, 4, 4) eye transforms or "
                f"({v}, {t_n}, {h_n}, {w_n}, 2) / ({v}, {t_n}, 2, {h_n}, "
                f"{w_n}) motion-vector buffers, got "
                f"{tuple(np.shape(motions))}")
    n_dev = len(devices)
    pad = -(-v // n_dev) * n_dev - v
    depths, motions, normals = (_pad_views(x, pad)
                                for x in (depths, motions, normals))
    k = (v + pad) // n_dev
    shards = [(dev, *(_shard(x, slice(i * k, (i + 1) * k), dev)
                      for x in (depths, motions, normals)))
              for i, dev in enumerate(devices)]
    states = [[None] * k for _ in devices]
    outs = [[[] for _ in range(k)] for _ in devices]
    for t in range(t_n):
        for i, (dev, d, m, nrm) in enumerate(shards):
            with _on_device(dev):
                for j in range(k):
                    out, states[i][j] = render_frame_temporal(
                        d[j, t], states[i][j], camera, params, tparams,
                        motion=None if m is None or t == 0 else m[j][t],
                        normals=None if nrm is None else nrm[j][t],
                        impl=impl, out_dtype=out_dtype,
                        resolve_level=resolve_level)
                    outs[i][j].append(out)
    seqs = [_to(torch.stack(seq), devices[0])
            for shard in outs for seq in shard]
    return torch.stack(seqs[:v])

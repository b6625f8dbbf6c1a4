"""Multi-view rendering on one card.

Counterpart of the one-card part of ``tpuao/parallel/sharding.py``.  AO is
embarrassingly parallel across views, and every kernel of the port takes a
leading batch as its grid's ``blockIdx.z``, so the views of a call are
that batch: ``render_views`` is one pass of the frame pipeline over all of
them, the same launches as one view.

``render_views_sharded`` is the JAX package's entry with its contract
(colour, ``out_dtype``, debug outputs, per-view camera rigs) on one card.
The kernels take the tunables as scalar arguments and the per-level pair
tables as launch parameters, so one launch set serves every view that
shares them: a rig renders one batch per distinct set of its eight
per-view values.  The multi-card modes (a mesh of several cards, the
temporal fleet, ``make_server(mesh=...)``) wait for the multi-GPU work
(ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuao_torch.models.pipeline import _as_tensor, ao_pipeline, render_frame
from tpuao_torch.params import AOParams, CameraParams

# The traced leaves of the JAX package's camera and params: one value per
# view under per_view=True.  The other fields are frame structure, global.
RIG_CAMERA_FIELDS = ("near", "far", "tan_half_fov_h")
RIG_PARAM_FIELDS = ("noise_filter_tolerance", "blur_tolerance",
                    "upsample_tolerance", "rejection_falloff", "strength")


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


def _mesh_device(mesh, device):
    """The views' card: ``mesh`` is None or a sequence of one device, which
    must be ``device`` where both are given."""
    if mesh is None:
        return device
    devices = list(mesh)
    if len(devices) > 1:
        raise NotImplementedError(
            f"a mesh of {len(devices)} devices: multi-card view sharding is "
            "not ported yet (ROADMAP queue 1 item 5); pass mesh=None or "
            "one device")
    if not devices:
        raise ValueError("mesh holds no device")
    if device is not None:
        a, b = torch.device(device), torch.device(devices[0])
        # an index left out ("cuda") is the current card: it names any one
        indices = {a.index, b.index} - {None}
        if a.type != b.type or len(indices) > 1:
            raise ValueError(f"mesh names {b} but device={a}")
    return devices[0]


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


def render_views_sharded(depths, camera=None, params=None, normals=None,
                         mesh=None, impl: str = "auto", color=None,
                         out_dtype: str = "float32",
                         debug_outputs: bool = False,
                         per_view: bool = False, device=None):
    """[BJ] config 5 on one card: ``depths`` (V, H, W) -> (V, H, W) AO (or
    (V, H, W, C) composited ``color``), with the debug dict when
    ``debug_outputs``, every leaf carrying the leading view axis.

    ``color``, ``out_dtype`` and ``debug_outputs`` are ``render_frame``'s,
    per view.  ``mesh`` is None or a sequence of exactly one device, the
    views' card (else ``device``; NumPy input goes there, by default the
    card); more devices raise ``NotImplementedError``.

    ``per_view=True`` renders a camera rig: ``camera.near``, ``far``,
    ``tan_half_fov_h`` and the five ``PARAM_RANGES`` tunables of
    ``params`` are each shaped (V,), one value per view (any other shape
    raises ``ValueError``); the structure fields stay global.  Views that
    share all eight values render as one batch, so a uniform rig costs
    the launches of one batch and a rig of G distinct views G times that.
    """
    camera = camera or CameraParams()
    params = params or AOParams()
    depths = _views(depths, _mesh_device(mesh, device))
    kw = dict(impl=impl, out_dtype=out_dtype, debug_outputs=debug_outputs)
    if not per_view:
        return render_frame(depths, camera, params, normals, color, **kw)
    n = depths.shape[0]
    rig = _rig(camera, params, n)
    groups: dict[tuple, list[int]] = {}
    for i, row in enumerate(rig):
        groups.setdefault(tuple(row.tolist()), []).append(i)

    def scalars(vals):
        return (camera.replace(**dict(zip(RIG_CAMERA_FIELDS, vals[:3]))),
                params.replace(**dict(zip(RIG_PARAM_FIELDS, vals[3:]))))

    if len(groups) == 1:  # a uniform rig: the whole batch, in order
        return render_frame(depths, *scalars(next(iter(groups))), normals,
                            color, **kw)
    normals = None if normals is None else _as_tensor(normals, depths.device)
    color = None if color is None else _as_tensor(color, depths.device)
    acc = None
    for vals, members in groups.items():
        idx = torch.tensor(members, device=depths.device)
        res = render_frame(depths.index_select(0, idx), *scalars(vals),
                           _take(normals, idx), _take(color, idx), **kw)
        out, dbg = res if debug_outputs else (res, {})
        acc = _put(acc, idx, {"out": out, "dbg": dbg}, n)
    return (acc["out"], acc["dbg"]) if debug_outputs else acc["out"]

"""Views x row bands on one 2-D device grid.

Counterpart of ``tpuao/parallel/grid.py``: the two 1-D modes composed --
views over the first axis (``sharding.py``, no exchange) and row bands over
the second (``spatial.py``, a halo from each neighbour band).  A grid is a
tuple of ``n_views`` tuples of ``n_bands`` devices (``make_grid_mesh``);
entry ``[i][j]`` renders view block i, band j.  As in the 1-D modes one
process drives it with no collective, a device may appear more than once,
and the result is gathered on ``grid[0][0]``.

Each device renders its whole view block as one batch (``_render_local``:
one launch set per distinct rig row, the counterpart of the JAX package's
``scan_optional``, since every kernel takes the batch as ``blockIdx.z``),
and the halo exchange moves a device's whole view block at once: one
exchange a device block, not one a view.
"""

from __future__ import annotations

import torch

from tpuao_torch.models.pipeline import _as_tensor, _quantize, resolve_device
from tpuao_torch.ops import composite as C
from tpuao_torch.ops.render import normals_channel_last
from tpuao_torch.params import AOParams, CameraParams
from tpuao_torch.parallel.sharding import (_gather, _mesh_devices,
                                           _on_device, _render_local, _rig,
                                           _to, _views)
from tpuao_torch.parallel.spatial import (_check_bands, crop_debug_rows,
                                          halo_extend_rows, pad_rows_aligned,
                                          stencil_halo_rows)


def make_grid_mesh(n_views: int, n_bands: int,
                   devices=None) -> tuple[tuple[torch.device, ...], ...]:
    """A (views, rows) grid over the first ``n_views * n_bands`` devices
    (by default every card; ``devices`` may name one several times):
    ``n_views`` tuples of ``n_bands`` devices."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    need = n_views * n_bands
    if len(devices) < need:
        raise ValueError(f"grid {n_views}x{n_bands} needs {need} devices, "
                         f"have {len(devices)}")
    return tuple(tuple(devices[i * n_bands:(i + 1) * n_bands])
                 for i in range(n_views))


def _grid(mesh, device, v: int) -> tuple[tuple[torch.device, ...], ...]:
    """The grid as tuples of devices.  With no mesh: a 1x1 grid on
    ``device`` where it is given, else every card, preferring view
    parallelism -- the largest count of view blocks that divides both the
    card count and ``v``, the rest of the cards as row bands."""
    if mesh is None and device is not None:
        return ((torch.device(device),),)
    if mesh is None:
        resolve_device("cuda")  # raises where there is no card
        nd = torch.cuda.device_count()
        nv0 = max(d for d in range(1, nd + 1) if nd % d == 0 and v % d == 0)
        return make_grid_mesh(nv0, nd // nv0)
    grid = tuple(tuple(torch.device(d) for d in row) for row in mesh)
    if not grid or any(len(row) != len(grid[0]) or not row for row in grid):
        raise ValueError("a grid is n_views rows of n_bands devices each")
    _mesh_devices([d for row in grid for d in row], device)
    return grid


def render_views_spatial(depths, camera=None, params=None, mesh=None,
                         impl: str = "auto", halo_rows: int | None = None,
                         auto_pad: bool = True, normals=None, color=None,
                         out_dtype: str = "float32",
                         debug_outputs: bool = False,
                         per_view: bool = False, device=None):
    """(V, H, W) depths -> (V, H, W) AO (or (V, H, W, C) composited
    ``color``) on a views x row-bands grid.

    ``mesh`` is a grid (``make_grid_mesh``); with none, ``device`` alone is
    a 1x1 grid, and with neither the grid spans every card, views first
    (raising where there is no card).  NumPy input goes to
    ``mesh[0][0]``, where the result is gathered.

    The constraints are the 1-D modes': V a multiple of the view blocks
    (no view padding here, as in the JAX package), H a multiple of 64 *
    the bands (``auto_pad`` edge-pads a frame that is not and crops back),
    bands at least ``halo_rows`` tall; any other raises ``ValueError``.
    Per view the result is ``render_frame_spatial``'s: the frame program
    on the frame edge-replicated by the halo, cropped.

    ``normals`` (V, H, W, 3) or (V, 3, H, W) are banded and halo-extended
    like depth; ``color`` (V, H, W[, C]) is banded with no halo;
    ``out_dtype`` quantises each block; ``debug_outputs`` returns the
    debug dict too, each leaf (V, rows, W) at the padded height under
    ``auto_pad``.  ``per_view=True`` renders a camera rig as
    ``render_views_sharded`` does: the eight rig fields are each (V,), and
    each block renders one batch per distinct set of its views' values.
    ``impl`` defaults to the kernels (see ``spatial.py``).
    """
    camera = camera or CameraParams()
    params = params or AOParams()
    if halo_rows is None:
        halo_rows = stencil_halo_rows(params)
    grid = _grid(mesh, device, len(depths))
    depths = _views(depths, grid[0][0])
    v, h, w = depths.shape
    nv, nr = len(grid), len(grid[0])
    if normals is not None:
        # channel-last before any row padding: a channel-first (V, 3, H, W)
        # buffer would be padded along its channel axis
        normals = normals_channel_last(
            _as_tensor(normals, depths.device).to(torch.float32))
    if color is not None:
        color = _as_tensor(color, depths.device)
    rig = _rig(camera, params, v) if per_view else None
    if auto_pad and h % (64 * nr):
        pad = lambda x: None if x is None else pad_rows_aligned(x, nr, 1)
        res = render_views_spatial(
            pad(depths), camera, params, mesh=grid, impl=impl,
            halo_rows=halo_rows, auto_pad=False, normals=pad(normals),
            color=pad(color), out_dtype=out_dtype,
            debug_outputs=debug_outputs, per_view=per_view)
        out, dbg = res if debug_outputs else (res, None)
        out = out[:, :h].contiguous()
        return (out, dbg) if debug_outputs else out
    if v % nv:
        raise ValueError(f"views {v} not divisible by view mesh {nv}")
    _check_bands(h, nr, halo_rows, "row-mesh", "use fewer row bands")
    k, band = v // nv, h // nr
    kw = dict(impl=impl, out_dtype="float32", debug_outputs=debug_outputs)
    blocks = []
    for i, row in enumerate(grid):
        views = slice(i * k, (i + 1) * k)
        rows = [slice(j * band, (j + 1) * band) for j in range(nr)]
        ext = halo_extend_rows([_to(depths[views, r], d)
                                for r, d in zip(rows, row)], halo_rows, 1)
        nrm_ext = ([None] * nr if normals is None else halo_extend_rows(
            [_to(normals[views, r], d) for r, d in zip(rows, row)],
            halo_rows, 1))
        parts = []
        for j, dev in enumerate(row):
            with _on_device(dev):
                res = _render_local(ext[j], camera, params, nrm_ext[j], None,
                                    None if rig is None else rig[views], kw)
                ao, dbg = res if debug_outputs else (res, None)
                out = ao[:, halo_rows: halo_rows + band]
                if color is not None:
                    out = C.composite(_to(color[views, rows[j]], dev), out)
                out = _quantize(out, out_dtype)
                parts.append((out, crop_debug_rows(dbg, halo_rows, band))
                             if debug_outputs else out)
        blocks.append(_gather(parts, grid[0][0], dim=1))
    return _gather(blocks, grid[0][0], dim=0)

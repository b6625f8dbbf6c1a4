"""Spatial (row-band) rendering of ONE large frame over a device mesh.

Counterpart of ``tpuao/parallel/spatial.py``.  The frame is split into
horizontal bands, one a device, and each band is extended by ``halo`` rows
from the bands above and below it: the AO stencils are local (at most ~300
full-res rows through the 4-level hierarchy), so a fixed halo from each
neighbour is all a band needs, and no band ever sees the whole frame.

The JAX package ``shard_map``s the frame program over a ``Mesh`` and
exchanges the halos by ``lax.ppermute``.  Here, as in ``sharding.py``, a
mesh is a tuple of ``torch.device`` driven by one process with no
collective: ``halo_extend_rows`` moves each band's boundary rows to its
neighbours' devices by device copies, each device runs the unchanged frame
program (``ao_pipeline``, every kernel of the main path) on its extended
band, and the cropped bands are gathered on ``mesh[0]``.  The JAX
package's result stays one row-sharded array, and its
``crop_rows_sharded`` crops it without gathering; a process of PyTorch has
no such array, so the gathered result is one tensor and the crop back to
the frame's height is a slice: ``crop_rows_sharded`` has no counterpart.

Edge semantics: the frame is treated as edge-replicated by ``halo`` rows at
the top and the bottom (bands 0 and n-1 make their outer halo by
replicating their boundary row), so the result is the single-device frame
program on the halo-padded frame, cropped -- even on a mesh of one.  It
differs from ``render_frame`` of the frame itself only within stencil reach
of the top and bottom edges.

The JAX package's spatial modes default to ``impl="jnp"``, its XLA fast
path.  The port's ``"jnp"`` is the plain oracle, so the port's default is
``impl="auto"``: the kernels, as in ``render_views_sharded``.
"""

from __future__ import annotations

import torch

from tpuao_torch.models.pipeline import (_as_tensor, _quantize, ao_pipeline,
                                         resolve_device)
from tpuao_torch.ops import composite as C
from tpuao_torch.ops.render import normals_channel_last
from tpuao_torch.params import AOParams, CameraParams
from tpuao_torch.parallel.sharding import (_gather, _mesh_devices,
                                           _on_device, _to, make_1d_mesh)

ROW_AXIS = "rows"

# Halo rows exchanged with each neighbour at the default hierarchy_depth=4
# (== stencil_halo_rows(AOParams())); the halo in use is derived per params.
HALO_ROWS = 320


def stencil_halo_rows(params) -> int:
    """The pipeline's stencil reach in full-res rows, rounded up to 64.

    * the render disc at the coarsest level d: 4 slice texels at stride 4,
      16 level-d texels, ``16 * 2^d`` rows;
    * with blur, each chain step at level l: the 3x3 noise filter and the
      corner-aligned bilateral tap, 2 level-l texels, ``2 * 2^l`` rows,
      summed over l = 1..d.

    The multiple of 64 keeps every band start 64-aligned, so each pyramid
    level's pick-one grid and the parity-4 layout match the whole frame's.
    d = 4 gives 256 + 60 -> 320, ``HALO_ROWS``.
    """
    d = params.hierarchy_depth
    reach = 16 * (1 << d)
    if params.enable_blur:
        reach += sum(2 * (1 << l) for l in range(1, d + 1))
    return -(-reach // 64) * 64


def make_row_mesh(n_devices: int | None = None,
                  devices=None) -> tuple[torch.device, ...]:
    """1-D device mesh over the row axis (``make_1d_mesh``): by default
    every card."""
    return make_1d_mesh(ROW_AXIS, n_devices, devices)


def edge_pad_rows(x, target_h: int, axis: int):
    """``x`` edge-padded along ``axis`` to ``target_h`` rows by replicating
    its last row (the auto_pad rule of the spatial and grid modes).  Keeps
    the dtype (colour may be uint8); an aligned ``x`` passes through."""
    h = x.shape[axis]
    if h == target_h:
        return x
    last = x.narrow(axis, h - 1, 1)
    shape = list(x.shape)
    shape[axis] = target_h - h
    return torch.cat([x, last.expand(shape)], dim=axis)


def pad_rows_aligned(x, n_bands: int, axis: int):
    """Edge-pad rows to the next multiple of ``64 * n_bands`` (the
    row-band alignment rule of the spatial and grid modes)."""
    mult = 64 * n_bands
    ha = -(-x.shape[axis] // mult) * mult
    return edge_pad_rows(x, ha, axis)


def halo_extend_rows(bands: list, halo: int, axis: int) -> list:
    """Each band extended by ``halo`` rows of its neighbours along ``axis``.

    ``bands`` are the per-device band tensors, top to bottom.  Band i gets
    the last ``halo`` rows of band i-1 above it and the first ``halo`` rows
    of band i+1 below it, each moved to its device by a non-blocking
    device copy (the exchange between neighbours, the counterpart of the
    JAX package's two ``ppermute``s); bands 0 and n-1 make their outer halo
    by replicating their boundary row.  ``axis`` is the row axis: 0 for
    (rows, W[, 3]) bands, 1 for (views, rows, W[, 3]) view blocks, whose
    whole block moves in one copy.  Returns the extended bands, each on its
    own band's device.
    """
    out = []
    n = len(bands)
    for i, b in enumerate(bands):
        ax = axis % b.ndim
        rows = b.shape[ax]
        edge = list(b.shape)
        edge[ax] = halo
        if i == 0:
            top = b.narrow(ax, 0, 1).expand(edge)
        else:
            above = bands[i - 1]
            top = _to(above.narrow(ax, above.shape[ax] - halo, halo),
                      b.device)
        if i == n - 1:
            bot = b.narrow(ax, rows - 1, 1).expand(edge)
        else:
            bot = _to(bands[i + 1].narrow(ax, 0, halo), b.device)
        out.append(torch.cat([top, b, bot], dim=ax))
    return out


def crop_debug_rows(dbg, halo: int, band: int, row_axis: int = -2):
    """Every debug leaf cropped to its band, halo rows removed, through
    nested dicts.

    A leaf lives at level scale 1/2^l of the halo-extended band; the scale
    is its row count's, ``ext // rows`` (ext, halo and band are multiples
    of 64, so every division is exact)."""
    ext = band + 2 * halo
    if isinstance(dbg, dict):
        return {k: crop_debug_rows(v, halo, band, row_axis)
                for k, v in dbg.items()}
    scale = ext // dbg.shape[row_axis]
    start = halo // scale
    return dbg.narrow(row_axis, start, (halo + band) // scale - start)


def _default_devices(mesh, device) -> tuple:
    """The mesh as a tuple of devices: ``mesh`` (whose first must be
    ``device`` where both are given), ``(device,)`` when only ``device``
    is, else every card -- which raises where there is none."""
    if mesh is None and device is None:
        resolve_device("cuda")
        return make_row_mesh()
    return tuple(torch.device(d) for d in _mesh_devices(mesh, device))


def _check_bands(h: int, nr: int, halo: int, mesh_name: str,
                 remedy: str) -> None:
    """The row-band constraints of the spatial and grid modes, raised with
    the JAX package's messages."""
    if halo % 64:
        raise ValueError(f"halo_rows={halo} must be a multiple of 64")
    if h % (64 * nr):
        raise ValueError(f"H={h} must be a multiple of 64*{mesh_name} "
                         f"({64 * nr}); pad the frame")
    if h // nr < halo:
        raise ValueError(f"band height {h // nr} < halo {halo}: {remedy}")


def render_frame_spatial(depth, camera=None, params=None, mesh=None,
                         impl: str = "auto", halo_rows: int | None = None,
                         auto_pad: bool = True, normals=None, color=None,
                         out_dtype: str = "float32",
                         debug_outputs: bool = False, device=None):
    """Render one (H, W) frame in row bands across ``mesh``.

    ``mesh`` is a sequence of devices (``make_row_mesh``; it may name one
    device more than once); band i of H / n rows renders on ``mesh[i]``.
    With no mesh, ``device`` alone is a mesh of one, and with neither the
    mesh is every card (``make_row_mesh()``), which raises where there is
    none.  NumPy input goes to ``mesh[0]``.

    H must be a multiple of 64 * n; with ``auto_pad`` (default) a frame
    that is not is edge-padded at the bottom to the next such height and
    the result cropped back (real 8K, 4320 rows, becomes 4352 on 2 or 4
    bands).  Bands must be at least ``halo_rows`` tall; ``halo_rows``
    defaults to ``stencil_halo_rows(params)``, the exact reach.  A
    constraint that does not hold raises ``ValueError``.

    ``normals`` (H, W, 3) or (3, H, W) are banded and halo-extended like
    depth; ``color`` (H, W[, C]) is banded with no halo (the composite is
    per pixel); ``out_dtype`` quantises each band.  With
    ``debug_outputs`` the debug dict comes back too, each leaf cropped to
    its band and gathered (under ``auto_pad`` the leaves keep the padded
    height; only the primary output is cropped).  ``impl`` as in
    ``render_frame``, default the kernels (see the module docstring).
    Returns the result on ``mesh[0]``.
    """
    camera = camera or CameraParams()
    params = params or AOParams()
    if halo_rows is None:
        halo_rows = stencil_halo_rows(params)
    devices = _default_devices(mesh, device)
    n = len(devices)
    depth = _as_tensor(depth, devices[0])
    if depth.ndim != 2:
        raise ValueError(f"depth must be one (H, W) frame, got "
                         f"{tuple(depth.shape)}")
    h, w = depth.shape
    if normals is not None:
        # channel-last before any row padding: a channel-first (3, H, W)
        # buffer would be padded along its channel axis
        normals = normals_channel_last(
            _as_tensor(normals, depth.device).to(torch.float32))
    if color is not None:
        color = _as_tensor(color, depth.device)
    if auto_pad and h % (64 * n):
        pad = lambda x: None if x is None else pad_rows_aligned(x, n, 0)
        res = render_frame_spatial(
            pad(depth), camera, params, mesh=devices, impl=impl,
            halo_rows=halo_rows, auto_pad=False, normals=pad(normals),
            color=pad(color), out_dtype=out_dtype,
            debug_outputs=debug_outputs)
        out, dbg = res if debug_outputs else (res, None)
        return (out[:h], dbg) if debug_outputs else out[:h]
    _check_bands(h, n, halo_rows, "mesh",
                 "the single-neighbor exchange needs bands at least one "
                 "halo tall (use fewer chips)")
    band = h // n
    rows = [slice(i * band, (i + 1) * band) for i in range(n)]
    ext = halo_extend_rows([_to(depth[r], d) for r, d in zip(rows, devices)],
                           halo_rows, axis=0)
    nrm_ext = ([None] * n if normals is None else halo_extend_rows(
        [_to(normals[r], d) for r, d in zip(rows, devices)], halo_rows,
        axis=0))
    parts = []
    for i, dev in enumerate(devices):
        with _on_device(dev):
            ao_ext, dbg = ao_pipeline(ext[i], camera, params, nrm_ext[i],
                                      impl=impl, all_levels=debug_outputs)
            out = ao_ext[halo_rows: halo_rows + band]
            if color is not None:
                out = C.composite(_to(color[rows[i]], dev), out)
            out = _quantize(out, out_dtype)
            parts.append((out, crop_debug_rows(dbg, halo_rows, band))
                         if debug_outputs else out)
    return _gather(parts, devices[0])

"""The frame path's CUDA kernels: wrappers, plain versions, launch counts.

Counterpart of ``tpuao/ops/pallas_kernels.py``.  Each kernel has

* a wrapper (``render_ao_level``, ``render_ao_level_normals``,
  ``blur_upsample_step``, ``fused_render_upsample_step``,
  ``windowed_resolve``, and the two variants that no ``impl`` of the
  pipeline reaches, as in the JAX package: ``render_ao_level_dma`` and
  ``fused_render_upsample_step_zc``): on a CPU tensor it runs the plain
  version; on a CUDA tensor it launches the kernel (``csrc/``, built by
  ``ops/_build.py`` at first use) or raises.  It never falls back;
* a plain PyTorch version (``*_plain``), the CPU path and the reference the
  kernel is held against on the card;
* a launch count, ``wrapper.launches``, a plain integer that the wrapper
  adds one to where it launches its kernel and nowhere else.

The render, upsample and fused wrappers pass each launch's texels a thread
from ``utils/launch_opts.tile_rows`` (0: the launcher's own rule), and
``record_launches`` lists the launches a program makes, with a call that
repeats each one on its inputs (``utils/autotune.tune_frame`` sweeps them).

The wrappers take float32, C-contiguous tensors whose leading dimensions
(a batch) agree; the batch becomes the kernels' ``blockIdx.z``.  The
windowed resolve takes single (h, w) planes: the temporal path is one
sequence per call.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from tpuao_torch.ops import render as R
from tpuao_torch.ops import temporal as T
from tpuao_torch.ops import upsample as U
from tpuao_torch.params import (PARAM_RANGES, AOParams, sphere_radius_coef,
                                upsample_constants)
from tpuao_torch.utils import launch_opts as L

# One tap pair as the kernels read it (tpuao::Pair in csrc/common.cuh).
_PAIR_DTYPE = np.dtype([("dx", np.int32), ("dy", np.int32),
                        ("inv_r", np.float32), ("half_w", np.float32)])
_MAX_BATCH = 65535  # gridDim.z


@functools.lru_cache(maxsize=64)
def pair_table(exhaustive: bool, radius_coef: float) -> np.ndarray:
    """The kernels' pair table of one level: 34 pairs (or 10 sparse) with
    ``inv_r = 1 / (radius_coef * t)`` and half the weight, formed in
    float64 and rounded once to float32, as the plain version rounds them.
    Cached: one array serves every call at the level."""
    pairs = R._pair_constants(AOParams(exhaustive=exhaustive))
    table = np.zeros(len(pairs), _PAIR_DTYPE)
    for k, (dx, dy, t, w) in enumerate(pairs):
        table[k] = (dx, dy, 1.0 / (radius_coef * t), 0.5 * w)
    table.setflags(write=False)
    return table


def _level_table(params, level: int, full_width: int, camera) -> np.ndarray:
    return pair_table(bool(params.exhaustive),
                      _radius_coef(level, full_width, camera, params))


def _check(name: str, x: torch.Tensor) -> None:
    """What every wrapper takes: float32 (..., H, W) on the CPU or a GPU."""
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: float32 required, got {x.dtype}")
    if x.ndim < 2:
        raise ValueError(f"{name}: needs (..., H, W), got shape "
                         f"{tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def needs_grad(tensors, params=None) -> bool:
    """Whether autograd is on and a tensor of ``tensors`` or a tunable of
    ``params`` (a tensor among the five ``PARAM_RANGES`` fields) requires
    grad."""
    if not torch.is_grad_enabled():
        return False
    leaves = list(tensors)
    if params is not None:
        leaves += [getattr(params, f) for f in PARAM_RANGES]
    return any(isinstance(x, torch.Tensor) and x.requires_grad
               for x in leaves)


def _check_no_grad(name: str, tensors, params=None) -> None:
    """Refuse what would lose a gradient (``needs_grad``): the kernels
    have no backward, so their output would carry none."""
    if needs_grad(tensors, params):
        raise ValueError(
            f"{name}: an input or tunable requires grad, and the CUDA "
            "kernels have no backward; use impl=\"jnp\" (the plain PyTorch "
            "ops, models.autodiff's \"auto\") for gradients")


def _check_kernel_input(name: str, x: torch.Tensor, device: torch.device,
                        lead: tuple) -> None:
    """What a kernel takes: on ``device``, dense, with batch dims ``lead``."""
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous (a strided view's "
                         "data_ptr is not a dense array); call .contiguous()")
    if tuple(x.shape[:-2]) != lead:
        raise ValueError(f"{name}: batch dims {tuple(x.shape[:-2])} != "
                         f"{lead}")


def _batch(lead: tuple) -> int:
    n = int(np.prod(lead, dtype=np.int64)) if lead else 1
    if not 1 <= n <= _MAX_BATCH:
        raise ValueError(f"batch of {n} frames is outside [1, {_MAX_BATCH}]")
    return n


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def _launch(entry: str, *args) -> None:
    """Call one C entry point (building the library at first use); raise
    if the launch returned a CUDA error (an ``nt`` with no instance
    among them)."""
    from tpuao_torch.ops import _build

    lib = _build.load()
    if entry in _build.NT_ENTRIES and not lib.takes_nt:
        # an older tree's kernels, timed beside these: their rule only
        if args[-3]:
            raise RuntimeError(f"{entry}: this library's launches take no "
                               "tile rows")
        args = args[:-3] + args[-2:]
    _build.check(lib, getattr(lib, entry)(*args), entry)


class Launch(NamedTuple):
    """One launch of a tiled kernel, as ``record_launches`` lists it."""
    kernel: str  # its wrapper's name, launch_opts' kernel key
    batch: int
    h: int  # the level the kernel reads (the lo level of a chain step)
    w: int
    rule: int  # the launcher's own texels a thread (launch_opts.rule_nt)
    call: Callable[[], object]  # the wrapper call again, on the same inputs

    @property
    def key(self) -> tuple[str, int, int, int]:
        return self.kernel, self.batch, self.h, self.w


_RECORD: list | None = None


@contextlib.contextmanager
def record_launches():
    """Within the block, every call of the render, upsample and fused
    wrappers appends its ``Launch`` to the list this yields -- on a CPU
    tensor too, where the wrapper runs its plain version: the launch the
    card would make.  The launch counts are untouched."""
    global _RECORD
    prior, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prior


def _tiles(kernel: str, x: torch.Tensor, h: int, w: int, call,
           h0: int | None = None, w0: int | None = None) -> int:
    """Texels a thread for this launch of ``kernel`` over ``x``'s batch of
    (h, w) levels (``launch_opts.tile_rows``; 0 is the launcher's rule),
    noted for ``record_launches`` with ``call``, which repeats it."""
    batch = math.prod(x.shape[:-2])
    if _RECORD is not None:
        _RECORD.append(Launch(kernel, batch, h, w,
                              L.rule_nt(kernel, batch, h, w, h0, w0), call))
    return L.tile_rows(kernel, batch, h, w)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _crop(crop_hw, hh: int, hw: int) -> tuple[int, int]:
    h0, w0 = (hh, hw) if crop_hw is None else (int(crop_hw[0]),
                                               int(crop_hw[1]))
    if not (1 <= h0 <= hh and 1 <= w0 <= hw):
        raise ValueError(f"crop_hw {crop_hw} outside the ({hh}, {hw}) output")
    return h0, w0


# ---------------------------------------------------------------------------
# 1. Per-level AO estimator (replaces pallas_kernels.render_ao_level)
# ---------------------------------------------------------------------------

render_ao_level_plain = R.render_ao_level


def render_ao_level(ds: torch.Tensor, level: int, full_width: int, camera,
                    params, normals_ds=None, slopes_ds=None) -> torch.Tensor:
    """AO of one (..., h, w) pyramid level; kernel ``csrc/render.cu``.
    With ``params.use_normals`` and normals given, this is
    ``render_ao_level_normals`` (its own kernel mode and launch count)."""
    if params.use_normals and (normals_ds is not None
                               or slopes_ds is not None):
        return render_ao_level_normals(ds, level, full_width, camera, params,
                                       normals_ds=normals_ds,
                                       slopes_ds=slopes_ds)
    _check("ds", ds)
    h, w = ds.shape[-2:]
    nt = _tiles("render_ao_level", ds, h, w, lambda: render_ao_level(
        ds, level, full_width, camera, params))
    if ds.device.type == "cpu":
        return render_ao_level_plain(ds, level, full_width, camera, params)
    _check_no_grad("render_ao_level", (ds,), params)
    lead = tuple(ds.shape[:-2])
    _check_kernel_input("ds", ds, ds.device, lead)
    _check_level(h, w)
    table = _level_table(params, level, full_width, camera)
    out = torch.empty_like(ds)
    _launch("tpuao_render_ao_level", ds.data_ptr(), out.data_ptr(),
            _batch(lead), h, w, table.ctypes.data, len(table),
            float(params.rejection_falloff), float(params.strength), nt,
            ds.device.index, _stream(ds.device))
    render_ao_level.launches += 1
    return out


render_ao_level.launches = 0


def _check_level(h: int, w: int) -> None:
    if h < 4 or w < 4:
        raise ValueError(f"render kernel needs a level of at least 4x4, "
                         f"got {(h, w)}")


def _row_tile(row_tile) -> int:
    row_tile = int(row_tile)
    if row_tile < 1:
        raise ValueError(f"row_tile must be >= 1, got {row_tile}")
    return row_tile


def _radius_coef(level: int, full_width: int, camera, params) -> float:
    return float(sphere_radius_coef(level, full_width, camera.tan_half_fov_h,
                                    params.screenspace_diameter))


# ---------------------------------------------------------------------------
# 1d. Per-level AO estimator walking the level in row windows (replaces
#     pallas_kernels.render_ao_level_dma)
# ---------------------------------------------------------------------------


_SMS = 132  # H100 SXM
DMA_MAX_ROWS = 160  # a segment's window in shared memory: (160 + 32) x 96


def dma_nt(seg: int) -> int:
    """Texels a thread of ``csrc/render_dma.cu`` for a segment of ``seg``
    rows: the largest of 4, 2, 1 whose step (8 rows a texel) divides it,
    so no step renders rows past its segment.  The kernel's launcher takes
    it by the same rule."""
    return 4 if seg % 32 == 0 else 2 if seg % 16 == 0 else 1


@functools.lru_cache(maxsize=256)
def dma_rows(row_tile: int, batch: int, h: int, w: int) -> int:
    """Rows a block of ``csrc/render_dma.cu`` walks: at most ``row_tile``
    (and 160, its shared memory).

    Of the multiples of 8 up to that bound (and up to the first one that
    covers ``h``), the segment whose busiest SM renders the fewest rows:
    the grid's ``ceil(w / 64)`` strips x ``ceil(h / seg)`` segments x
    ``batch`` blocks spread over the 132 SMs as the blocks finish, so the
    busiest takes ``ceil(blocks / 132)`` of them, each ``seg + 2`` rows
    (the 2 for a block's start: its barriers and its first window's
    latency).  On a tie the larger segment.  A ``row_tile`` below 8 is
    the segment itself."""
    row_tile = _row_tile(row_tile)
    if row_tile < 8:
        return row_tile
    strips = -(-w // 64)
    best = (None, 0)
    top = min(row_tile, DMA_MAX_ROWS, -(-h // 8) * 8)
    for seg in range(8, top + 1, 8):
        rounds = -(-strips * -(-h // seg) * batch // _SMS)
        cost = rounds * (seg + 2)
        if best[0] is None or cost <= best[0]:
            best = (cost, seg)
    return best[1]


def render_ao_level_dma(ds: torch.Tensor, level: int, full_width: int,
                        camera, params, row_tile: int = 128) -> torch.Tensor:
    """Depth-only AO of one (..., h, w) level, each block walking a strip
    of the level in row windows, the later windows' rows landing in
    shared memory while the earlier ones render; kernel
    ``csrc/render_dma.cu``, whose blocks walk ``dma_rows(row_tile, ...)``
    rows each.  ``row_tile`` does not change the result; normals are not
    taken (as in the JAX package).  Its plain version is
    ``render_ao_level_plain``."""
    _check("ds", ds)
    row_tile = _row_tile(row_tile)
    if ds.device.type == "cpu":
        return render_ao_level_plain(ds, level, full_width, camera, params)
    _check_no_grad("render_ao_level_dma", (ds,), params)
    lead = tuple(ds.shape[:-2])
    _check_kernel_input("ds", ds, ds.device, lead)
    h, w = ds.shape[-2:]
    _check_level(h, w)
    table = _level_table(params, level, full_width, camera)
    batch = _batch(lead)
    out = torch.empty_like(ds)
    _launch("tpuao_render_ao_level_dma", ds.data_ptr(), out.data_ptr(),
            batch, h, w, dma_rows(row_tile, batch, h, w), table.ctypes.data,
            len(table), float(params.rejection_falloff),
            float(params.strength), ds.device.index, _stream(ds.device))
    render_ao_level_dma.launches += 1
    return out


render_ao_level_dma.launches = 0


# ---------------------------------------------------------------------------
# 1n. Per-level AO estimator with normals (replaces the use_normals branch
#     of pallas_kernels.render_ao_level)
# ---------------------------------------------------------------------------


def render_ao_level_normals_plain(ds, level: int, full_width: int, camera,
                                  params, normals_ds=None, slopes_ds=None):
    """The normals path of the plain estimator (``ops/render.py``)."""
    return R.render_ao_level(ds, level, full_width, camera, params,
                             normals_ds=normals_ds, slopes_ds=slopes_ds)


def tangent_m2(params, level: int, full_width: int, camera) -> np.ndarray:
    """The kernel's per-pair soft-clamp scale ``(0.5 * radius_coef * t)^2``
    at ``level``, computed in float64 and rounded once, as the plain
    version rounds it."""
    return _m2_table(bool(params.exhaustive),
                     _radius_coef(level, full_width, camera, params))


@functools.lru_cache(maxsize=64)
def _m2_table(exhaustive: bool, radius_coef: float) -> np.ndarray:
    # cached: rebuilding the table on every call costs more host time than
    # the launch itself
    pairs = R._pair_constants(AOParams(exhaustive=exhaustive))
    m2 = np.array([(0.5 * radius_coef * t) ** 2 for _, _, t, _ in pairs],
                  np.float32)
    m2.setflags(write=False)  # one array serves every caller
    return m2


def render_ao_level_normals(ds: torch.Tensor, level: int, full_width: int,
                            camera, params, normals_ds=None,
                            slopes_ds=None) -> torch.Tensor:
    """AO of one (..., h, w) level with the tangent-plane offset; kernel
    ``csrc/render.cu`` in one of two modes:

    * ``slopes_ds=(g_x, g_y)``, each (..., h, w), at level-0 texel scale
      (``ops/render.slope_pyramid``): the ``impl="auto"`` path;
    * ``normals_ds``, the level's raw normals, (..., 3, h, w) channel-first
      or (..., h, w, 3): the ``impl="pallas"`` path (a channel-last tensor
      is copied to channel-first first).

    ``launches`` counts both modes, ``raw_launches`` the raw-normals one.
    """
    if (normals_ds is None) == (slopes_ds is None):
        raise ValueError("pass exactly one of normals_ds and slopes_ds")
    if not params.use_normals:
        raise ValueError("render_ao_level_normals needs params.use_normals")
    _check("ds", ds)
    h, w = ds.shape[-2:]
    nt = _tiles("render_ao_level_normals", ds, h, w,
                lambda: render_ao_level_normals(
                    ds, level, full_width, camera, params,
                    normals_ds=normals_ds, slopes_ds=slopes_ds))
    if ds.device.type == "cpu":
        return render_ao_level_normals_plain(
            ds, level, full_width, camera, params, normals_ds=normals_ds,
            slopes_ds=slopes_ds)
    _check_no_grad("render_ao_level_normals",
                   (ds, normals_ds, *(slopes_ds or ())), params)
    lead = tuple(ds.shape[:-2])
    _check_kernel_input("ds", ds, ds.device, lead)
    _check_level(h, w)
    if slopes_ds is not None:
        a, b = slopes_ds
        for name, x in (("g_x", a), ("g_y", b)):
            _check(name, x)
            _check_kernel_input(name, x, ds.device, lead)
            if tuple(x.shape[-2:]) != (h, w):
                raise ValueError(f"{name}: spatial shape "
                                 f"{tuple(x.shape[-2:])}, expected {(h, w)}")
        mode, scale = 1, float(1 << level)
    else:
        _check("normals_ds", normals_ds)
        a = R.normals_channel_first(normals_ds)
        if a.device != ds.device:
            raise ValueError(f"normals_ds: on {a.device}, expected "
                             f"{ds.device}")
        a = a.contiguous()
        if tuple(a.shape) != lead + (3, h, w):
            raise ValueError(f"normals_ds: shape {tuple(a.shape)} "
                             f"(channel-first), expected {lead + (3, h, w)}")
        b = None
        mode = 2
        scale = R.texel_scale(level, full_width, camera.tan_half_fov_h)
    table = _level_table(params, level, full_width, camera)
    m2 = tangent_m2(params, level, full_width, camera)
    out = torch.empty_like(ds)
    _launch("tpuao_render_ao_level_normals", ds.data_ptr(), a.data_ptr(),
            _ptr(b), out.data_ptr(), _batch(lead), h, w, table.ctypes.data,
            m2.ctypes.data, len(table), float(params.rejection_falloff),
            float(params.strength), float(scale), mode, nt, ds.device.index,
            _stream(ds.device))
    render_ao_level_normals.launches += 1
    if mode == 2:
        render_ao_level_normals.raw_launches += 1
    return out


render_ao_level_normals.launches = 0
render_ao_level_normals.raw_launches = 0


# ---------------------------------------------------------------------------
# 2. Blur + upsample chain step (replaces pallas_kernels.blur_upsample_step)
# ---------------------------------------------------------------------------

blur_upsample_step_plain = U.blur_upsample_step


def blur_upsample_step(lo_ao: torch.Tensor, lo_d: torch.Tensor,
                       hi_d: torch.Tensor, params, full_width: int,
                       lo_ao2=None, hi_ao_blend=None,
                       crop_hw=None) -> torch.Tensor:
    """One chain step, (..., lh, lw) -> (..., 2lh, 2lw) cropped to
    ``crop_hw``; kernel ``csrc/upsample.cu``.  ``hi_ao_blend`` is the
    uncropped (..., 2lh, 2lw) field."""
    named = {"lo_ao": lo_ao, "lo_d": lo_d, "hi_d": hi_d, "lo_ao2": lo_ao2,
             "hi_ao_blend": hi_ao_blend}
    for name, x in named.items():
        if x is not None:
            _check(name, x)
    lh, lw = lo_d.shape[-2:]
    shapes = {"lo_ao": (lh, lw), "lo_ao2": (lh, lw), "hi_d": (2 * lh, 2 * lw),
              "hi_ao_blend": (2 * lh, 2 * lw)}
    for name, hw in shapes.items():
        x = named[name]
        if x is not None and tuple(x.shape[-2:]) != hw:
            raise ValueError(f"{name}: spatial shape {tuple(x.shape[-2:])}, "
                             f"expected {hw}")
    h0, w0 = _crop(crop_hw, 2 * lh, 2 * lw)
    nt = _tiles("blur_upsample_step", lo_d, lh, lw,
                lambda: blur_upsample_step(
                    lo_ao, lo_d, hi_d, params, full_width, lo_ao2=lo_ao2,
                    hi_ao_blend=hi_ao_blend, crop_hw=crop_hw), h0, w0)
    if lo_d.device.type == "cpu":
        return blur_upsample_step_plain(lo_ao, lo_d, hi_d, params, full_width,
                                        lo_ao2=lo_ao2, hi_ao_blend=hi_ao_blend,
                                        crop_hw=crop_hw)
    _check_no_grad("blur_upsample_step", named.values(), params)
    lead = tuple(lo_d.shape[:-2])
    for name, x in named.items():
        if x is not None:
            _check_kernel_input(name, x, lo_d.device, lead)
    _, k_blur, k_up, nfs = upsample_constants(params, full_width, lw)
    out = torch.empty(*lead, h0, w0, dtype=torch.float32, device=lo_d.device)
    _launch("tpuao_blur_upsample_step", lo_ao.data_ptr(), _ptr(lo_ao2),
            lo_d.data_ptr(), hi_d.data_ptr(), _ptr(hi_ao_blend),
            out.data_ptr(), _batch(lead), lh, lw, h0, w0, float(k_blur),
            float(k_up), float(nfs), nt, lo_d.device.index,
            _stream(lo_d.device))
    blur_upsample_step.launches += 1
    return out


blur_upsample_step.launches = 0


# ---------------------------------------------------------------------------
# 3. Fused render + pre-min + blur + upsample step
#    (replaces pallas_kernels.fused_render_upsample_step)
# ---------------------------------------------------------------------------


def fused_render_upsample_step_plain(ds, c1, hi_d, level: int,
                                     full_width: int, camera, params,
                                     crop_hw=None) -> torch.Tensor:
    """``render_ao_level`` then ``blur_upsample_step(c1, ..., lo_ao2=ao)``:
    the composition the fused kernel equals."""
    ao = R.render_ao_level(ds, level, full_width, camera, params)
    return U.blur_upsample_step(c1, ds, hi_d, params, full_width, lo_ao2=ao,
                                crop_hw=crop_hw)


def _check_fused(ds, c1, hi_d, crop_hw) -> tuple[int, int, int, int]:
    """The fused steps' inputs: (lh, lw), (2lh, 2lw) and the crop; returns
    ``(lh, lw, h0, w0)``."""
    for name, x in (("ds", ds), ("c1", c1), ("hi_d", hi_d)):
        _check(name, x)
    lh, lw = ds.shape[-2:]
    if tuple(c1.shape[-2:]) != (lh, lw):
        raise ValueError(f"c1: spatial shape {tuple(c1.shape[-2:])}, "
                         f"expected {(lh, lw)}")
    if tuple(hi_d.shape[-2:]) != (2 * lh, 2 * lw):
        raise ValueError(f"hi_d: spatial shape {tuple(hi_d.shape[-2:])}, "
                         f"expected {(2 * lh, 2 * lw)}")
    return (lh, lw) + _crop(crop_hw, 2 * lh, 2 * lw)


def _fused_launch(entry: str, dims, ds, c1, hi_d, level: int,
                  full_width: int, camera, params, *extra,
                  nt: int | None = None) -> torch.Tensor:
    """Launch one of the fused entry points on CUDA tensors; ``dims`` is
    ``_check_fused``'s, ``extra`` goes between the sizes and the pair table
    (the zero-copy step's R), ``nt`` before the device (the tiled fused
    step's texels a thread)."""
    lh, lw, h0, w0 = dims
    _check_no_grad(entry, (ds, c1, hi_d), params)
    lead = tuple(ds.shape[:-2])
    for name, x in (("ds", ds), ("c1", c1), ("hi_d", hi_d)):
        _check_kernel_input(name, x, ds.device, lead)
    if lh < 4 or lw < 4:
        raise ValueError(f"fused kernel needs a level of at least 4x4, "
                         f"got {(lh, lw)}")
    table = _level_table(params, level, full_width, camera)
    _, k_blur, k_up, nfs = upsample_constants(params, full_width, lw)
    out = torch.empty(*lead, h0, w0, dtype=torch.float32, device=ds.device)
    _launch(entry, ds.data_ptr(), c1.data_ptr(), hi_d.data_ptr(),
            out.data_ptr(), _batch(lead), lh, lw, h0, w0, *extra,
            table.ctypes.data, len(table), float(params.rejection_falloff),
            float(params.strength), float(k_blur), float(k_up), float(nfs),
            *(() if nt is None else (nt,)), ds.device.index,
            _stream(ds.device))
    return out


def fused_render_upsample_step(ds: torch.Tensor, c1: torch.Tensor,
                               hi_d: torch.Tensor, level: int,
                               full_width: int, camera, params,
                               crop_hw=None) -> torch.Tensor:
    """Render level ``level`` (``ds``, (..., lh, lw)), min it with the
    combined AO from below ``c1``, and run the chain step up to ``hi_d``
    (..., 2lh, 2lw); the level's AO never reaches device memory.  Kernel
    ``csrc/fused.cu``."""
    dims = _check_fused(ds, c1, hi_d, crop_hw)
    lh, lw, h0, w0 = dims
    nt = _tiles("fused_render_upsample_step", ds, lh, lw,
                lambda: fused_render_upsample_step(
                    ds, c1, hi_d, level, full_width, camera, params,
                    crop_hw=crop_hw), h0, w0)
    if ds.device.type == "cpu":
        return fused_render_upsample_step_plain(
            ds, c1, hi_d, level, full_width, camera, params, crop_hw=crop_hw)
    out = _fused_launch("tpuao_fused_render_upsample_step", dims, ds, c1,
                        hi_d, level, full_width, camera, params, nt=nt)
    fused_render_upsample_step.launches += 1
    return out


fused_render_upsample_step.launches = 0


# ---------------------------------------------------------------------------
# 3z. Zero-copy fused step
#     (replaces pallas_kernels.fused_render_upsample_step_zc)
# ---------------------------------------------------------------------------


def zc_rows(row_tile: int, lh: int) -> int:
    """Lo rows per block segment: ``max(min(row_tile, lh), 40)``, as the
    JAX package's zero-copy step takes them (it needs R >= 40 so a window
    spans two row blocks; here R only sets the grid)."""
    return max(min(_row_tile(row_tile), lh), 40)


def fused_render_upsample_step_zc(ds: torch.Tensor, c1: torch.Tensor,
                                  hi_d: torch.Tensor, level: int,
                                  full_width: int, camera, params,
                                  row_tile: int = 64,
                                  crop_hw=None) -> torch.Tensor:
    """``fused_render_upsample_step`` with the level's depth windows put
    together in shared memory from the plainly stored level: kernel
    ``csrc/fused_zc.cu``, whose blocks walk ``zc_rows(row_tile, lh)`` lo
    rows each.  ``row_tile`` does not change the result."""
    dims = _check_fused(ds, c1, hi_d, crop_hw)
    seg = zc_rows(row_tile, ds.shape[-2])
    if ds.device.type == "cpu":
        return fused_render_upsample_step_plain(
            ds, c1, hi_d, level, full_width, camera, params, crop_hw=crop_hw)
    out = _fused_launch("tpuao_fused_render_upsample_step_zc", dims, ds, c1,
                        hi_d, level, full_width, camera, params, seg)
    fused_render_upsample_step_zc.launches += 1
    return out


fused_render_upsample_step_zc.launches = 0


# ---------------------------------------------------------------------------
# 4. Windowed history resample (replaces pallas_kernels.windowed_resolve)
# ---------------------------------------------------------------------------

windowed_resolve_plain = T._bilinear_windowed2


def windowed_resolve(prev_ao: torch.Tensor, prev_d: torch.Tensor,
                     ip: torch.Tensor, jp: torch.Tensor,
                     r: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Bilinear sample of both (h, w) history fields at (ip, jp) within a
    window of radius ``r``; returns ``(hist_ao, hist_depth)``.  Kernel
    ``csrc/windowed.cu``."""
    named = {"prev_ao": prev_ao, "prev_d": prev_d, "ip": ip, "jp": jp}
    for name, x in named.items():
        _check(name, x)
        if x.ndim != 2 or tuple(x.shape) != tuple(prev_ao.shape):
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected one "
                             f"(h, w) plane {tuple(prev_ao.shape)}")
    r = int(r)
    if r < 1:
        raise ValueError(f"window radius must be >= 1, got {r}")
    if prev_ao.device.type == "cpu":
        return windowed_resolve_plain(prev_ao, prev_d, ip, jp, r)
    _check_no_grad("windowed_resolve", named.values())
    for name, x in named.items():
        _check_kernel_input(name, x, prev_ao.device, ())
    h, w = prev_ao.shape
    hist_ao = torch.empty_like(prev_ao)
    hist_d = torch.empty_like(prev_ao)
    _launch("tpuao_windowed_resolve", prev_ao.data_ptr(), prev_d.data_ptr(),
            ip.data_ptr(), jp.data_ptr(), hist_ao.data_ptr(),
            hist_d.data_ptr(), h, w, r, prev_ao.device.index,
            _stream(prev_ao.device))
    windowed_resolve.launches += 1
    return hist_ao, hist_d


windowed_resolve.launches = 0

KERNELS = (render_ao_level, render_ao_level_normals, blur_upsample_step,
           fused_render_upsample_step, windowed_resolve, render_ao_level_dma,
           fused_render_upsample_step_zc)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    render_ao_level_normals.raw_launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}

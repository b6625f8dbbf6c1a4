"""The frame path's CUDA kernels: wrappers, plain versions, launch counts.

Counterpart of ``tpuao/ops/pallas_kernels.py``.  Each kernel has

* a wrapper (``prepare_levels``, ``render_ao_level``,
  ``render_ao_level_normals``, ``blur_upsample_step``,
  ``fused_render_upsample_step``, ``windowed_resolve``, and the two
  variants that no ``impl`` of the pipeline reaches, as in the JAX
  package: ``render_ao_level_dma`` and
  ``fused_render_upsample_step_zc``): on a CPU tensor it runs the plain
  version; on a CUDA tensor it launches the kernel (``csrc/``, built by
  ``ops/_build.py`` at first use) or raises.  It never falls back;
* a plain PyTorch version (``*_plain``), the CPU path and the reference the
  kernel is held against on the card;
* a launch count, ``wrapper.launches``, a plain integer that the wrapper
  adds one to where it launches its kernel and nowhere else -- except in
  a ``tally_launches`` block on the launching thread (a CUDA graph's
  capture, which runs nothing), where the launch goes to the block's
  tally, and the graph's replays add it (``add_launches``).

The render, upsample and fused wrappers pass each launch's texels a thread
as ``utils/launch_opts.nt_for`` resolves it (the tuned table, else the
rule), and ``record_launches`` lists the launches a program makes, with a
call that repeats each one on its inputs (``utils/autotune.tune_frame``
sweeps them).

The wrappers take float32, C-contiguous tensors whose leading dimensions
(a batch) agree; the batch becomes the kernels' ``blockIdx.z``.  The
prologue (``prepare_levels``) takes the caller's depth and normals as they
come, converting a depth of another dtype or layout first.  The
windowed resolve takes single (h, w) planes: the temporal path is one
sequence per call.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Callable, NamedTuple

import numpy as np
import torch

from tpuao_torch.ops import prepare as P
from tpuao_torch.ops import render as R
from tpuao_torch.ops import temporal as T
from tpuao_torch.ops import upsample as U
from tpuao_torch.params import (PARAM_RANGES, AOParams, sphere_radius_coef,
                                upsample_constants)
from tpuao_torch.utils import launch_opts as L
from tpuao_torch.utils import trace

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
    among them).  Traced as ``ao_launch``."""
    from tpuao_torch.ops import _build

    with trace.span("ao_launch") if trace.ON else trace.OFF:
        lib = _build.load()
        _build.check(lib, getattr(lib, entry)(*args), entry)


class Launch(NamedTuple):
    """One launch of a tiled kernel, as ``record_launches`` lists it."""
    kernel: str  # its wrapper's name, launch_opts' kernel key
    batch: int
    h: int  # the level the kernel reads (the lo level of a chain step)
    w: int
    rule: int  # the rule's texels a thread (launch_opts.rule_nt)
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


def _tiles(kernel: str, x: torch.Tensor, h: int, w: int, crop, wrapper,
           /, *args, **kwargs) -> int:
    """Texels a thread for this launch of ``kernel`` over ``x``'s batch of
    (h, w) levels, its output cropped to ``crop`` = (h0, w0) or None
    (``launch_opts.nt_for``).  While a ``record_launches`` block is open,
    the launch is noted with a call of ``wrapper(*args, **kwargs)``, which
    repeats it."""
    batch = math.prod(x.shape[:-2])
    h0, w0 = crop or (None, None)
    if _RECORD is not None:
        _RECORD.append(Launch(kernel, batch, h, w,
                              L.rule_nt(kernel, batch, h, w, h0, w0),
                              functools.partial(wrapper, *args, **kwargs)))
    return L.nt_for(kernel, batch, h, w, h0, w0)


_LOCAL = threading.local()  # .tally: the open tally_launches block's dict


def _count(wrapper, attr: str = "launches") -> None:
    """One launch onto ``wrapper.<attr>``, or onto this thread's tally
    while a ``tally_launches`` block is open on it."""
    tally = getattr(_LOCAL, "tally", None)
    if tally is None:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
    else:
        tally[wrapper, attr] = tally.get((wrapper, attr), 0) + 1


@contextlib.contextmanager
def tally_launches():
    """Within the block, this thread's launches go to the dict it yields,
    ``{(wrapper, "launches" or "raw_launches"): n}``, and not to the
    counts; other threads' launches count as ever."""
    prior = getattr(_LOCAL, "tally", None)
    _LOCAL.tally = {}
    try:
        yield _LOCAL.tally
    finally:
        _LOCAL.tally = prior


def add_launches(tally: dict) -> None:
    """Add a ``tally_launches`` dict to the counts."""
    for (wrapper, attr), n in tally.items():
        setattr(wrapper, attr, getattr(wrapper, attr) + n)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _crop(crop_hw, hh: int, hw: int) -> tuple[int, int]:
    h0, w0 = (hh, hw) if crop_hw is None else (int(crop_hw[0]),
                                               int(crop_hw[1]))
    if not (1 <= h0 <= hh and 1 <= w0 <= hw):
        raise ValueError(f"crop_hw {crop_hw} outside the ({hh}, {hw}) output")
    return h0, w0


# ---------------------------------------------------------------------------
# 0. The prologue: pad, linearise, the pick-one pyramid and the slope
#    levels in one launch (the JAX package leaves them to XLA)
# ---------------------------------------------------------------------------

def _check_prepare_dims(h0: int, w0: int, hp: int, wp: int,
                        depth_levels: int) -> None:
    if not (h0 <= hp and w0 <= wp and 0 <= depth_levels <= 6
            and wp % 4 == 0 and hp % (1 << depth_levels) == 0
            and wp % (1 << depth_levels) == 0):
        raise ValueError(
            f"prepare_levels: ({hp}, {wp}) must cover the ({h0}, {w0}) "
            f"frame with both dims multiples of 2^{depth_levels} and the "
            "width of 4 (depth_levels in [0, 6])")


def _normals_strides(normals: torch.Tensor, lead: tuple, h0: int,
                     w0: int) -> tuple[torch.Tensor, tuple]:
    """``normals`` as a (batch, h0, w0, 3) view (channel-first input is
    not copied) and its element strides (batch, row, column, channel)."""
    _check("normals", normals)
    cl = R.normals_channel_last(normals)
    if tuple(cl.shape) != lead + (h0, w0, 3):
        raise ValueError(f"normals: shape {tuple(normals.shape)}, expected "
                         f"{lead + (h0, w0)} with 3 channels first or last")
    cl = cl.reshape(-1, h0, w0, 3)  # a view but for an odd batch layout
    return cl, tuple(cl.stride())


def prepare_levels(depth: torch.Tensor, camera, depth_levels: int, hp: int,
                   wp: int, normals=None):
    """``ops/prepare.prepare_levels_plain`` in one launch of
    ``csrc/prepare.cu``,
    bit-equal to it: every level of the linear depth and, with
    ``normals``, the slope planes of levels 1..d, straight from the
    caller's depth and normals (read once, by their strides: a batch or
    row slice of the depth, either layout of the normals, no copy).  A
    depth or normals of another dtype is made float32 first, and a depth
    whose rows are not dense is copied."""
    _check_prepare_dims(*depth.shape[-2:], hp, wp, depth_levels)
    if depth.device.type == "cpu":
        return P.prepare_levels_plain(depth, camera, depth_levels, hp,
                                      wp, normals)
    _check_no_grad("prepare_levels", (depth, normals))
    depth = depth.to(torch.float32)
    _check("depth", depth)
    lead = tuple(depth.shape[:-2])
    h0, w0 = depth.shape[-2:]
    batch = _batch(lead)
    if depth.stride(-1) != 1:
        depth = depth.contiguous()
    depth = depth.reshape(batch, h0, w0)  # a view but for an odd layout
    # the kernel's depth modes: 0 linear, 1 reversed-Z, 2 forward-Z
    mode = (0 if camera.depth_mode == "linear" else
            1 if camera.reversed_z else 2)
    new = functools.partial(torch.empty, dtype=torch.float32,
                            device=depth.device)
    pyr = [new(*lead, hp >> l, wp >> l) for l in range(depth_levels + 1)]
    ptrs = [x.data_ptr() for x in pyr] + [0] * (2 * depth_levels + 2)
    slopes, nrm, strides, ts0 = None, None, (0, 0, 0, 0), 0.0
    if normals is not None:
        if normals.device != depth.device:
            raise ValueError(f"normals: on {normals.device}, expected "
                             f"{depth.device}")
        nrm, strides = _normals_strides(normals.to(torch.float32), lead,
                                        h0, w0)
        slopes = [None] + [(new(*lead, hp >> l, wp >> l),
                            new(*lead, hp >> l, wp >> l))
                           for l in range(1, depth_levels + 1)]
        for l in range(1, depth_levels + 1):
            ptrs[depth_levels + 1 + l] = slopes[l][0].data_ptr()
            ptrs[2 * depth_levels + 2 + l] = slopes[l][1].data_ptr()
        ts0 = float(np.float32(2.0 * camera.tan_half_fov_h / wp))
    outs = np.array(ptrs, np.uint64)
    _launch("tpuao_prepare_levels", depth.data_ptr(), *depth.stride()[:2],
            batch, h0, w0, hp, wp, depth_levels, mode,
            float(np.float32(P.zmagic(camera))),
            _ptr(nrm), *strides, ts0, outs.ctypes.data, depth.device.index,
            _stream(depth.device))
    _count(prepare_levels)
    return pyr, slopes


prepare_levels.launches = 0


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
    nt = _tiles("render_ao_level", ds, h, w, None, render_ao_level, ds,
                level, full_width, camera, params)
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
    _count(render_ao_level)
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
    ``batch`` blocks spread over the card's ``launch_opts.SMS`` SMs as
    the blocks finish, so the busiest takes ``ceil(blocks / SMS)`` of
    them, each ``seg + 2`` rows
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
        rounds = -(-strips * -(-h // seg) * batch // L.SMS)
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
    _count(render_ao_level_dma)
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
    nt = _tiles("render_ao_level_normals", ds, h, w, None,
                render_ao_level_normals, ds, level, full_width, camera,
                params, normals_ds=normals_ds, slopes_ds=slopes_ds)
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
    _count(render_ao_level_normals)
    if mode == 2:
        _count(render_ao_level_normals, "raw_launches")
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
    nt = _tiles("blur_upsample_step", lo_d, lh, lw, (h0, w0),
                blur_upsample_step, lo_ao, lo_d, hi_d, params, full_width,
                lo_ao2=lo_ao2, hi_ao_blend=hi_ao_blend, crop_hw=crop_hw)
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
    _count(blur_upsample_step)
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
    nt = _tiles("fused_render_upsample_step", ds, lh, lw, (h0, w0),
                fused_render_upsample_step, ds, c1, hi_d, level, full_width,
                camera, params, crop_hw=crop_hw)
    if ds.device.type == "cpu":
        return fused_render_upsample_step_plain(
            ds, c1, hi_d, level, full_width, camera, params, crop_hw=crop_hw)
    out = _fused_launch("tpuao_fused_render_upsample_step", dims, ds, c1,
                        hi_d, level, full_width, camera, params, nt=nt)
    _count(fused_render_upsample_step)
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
    _count(fused_render_upsample_step_zc)
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
    _count(windowed_resolve)
    return hist_ao, hist_d


windowed_resolve.launches = 0

KERNELS = (prepare_levels, render_ao_level, render_ao_level_normals,
           blur_upsample_step, fused_render_upsample_step, windowed_resolve,
           render_ao_level_dma, fused_render_upsample_step_zc)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    render_ao_level_normals.raw_launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}

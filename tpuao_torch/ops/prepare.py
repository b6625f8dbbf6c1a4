"""AoPrepare stage: pad, linearise, pick-one pyramid, parity-4 padding.

Counterpart of ``tpuao/ops/prepare.py``.  Plain tensor code; the frame
path's prologue, ``prepare_levels_plain``, runs it on the CPU and under
``impl="jnp"``, and on the card is one launch of its kernel
(``ops/kernels.prepare_levels``, ``csrc/prepare.cu``), bit-equal to it.
"""

from __future__ import annotations

import torch

from tpuao_torch.ops import render as R
from tpuao_torch.ops.upsample import _edge_pad


def prepare_levels_plain(depth: torch.Tensor, camera, depth_levels: int,
                         hp: int, wp: int, normals=None):
    """The frame program's prologue in plain PyTorch: the depth edge-padded
    (bottom and right) to (hp, wp), linearised, and its pick-one pyramid,
    each level dense; with ``normals`` (either layout) the slope planes,
    edge-padded and picked alike (``ops/render.slope_pyramid``).  Returns
    ``(levels, slopes)``: levels 0..d, and ``slopes[l] = (g_x, g_y)`` for
    l in 1..d (``slopes[0]`` is None: no render reads it), or None without
    normals.  On the card ``ops/kernels.prepare_levels`` is this in one
    launch, bit-equal to it."""
    h0, w0 = depth.shape[-2:]
    linz = linearize_depth(pad_to(depth.to(torch.float32), hp, wp), camera)
    pyr = [lvl.contiguous() for lvl in build_pyramid(linz, depth_levels)]
    if normals is None:
        return pyr, None
    slopes = R.slope_pyramid(normals.to(torch.float32),
                             camera.tan_half_fov_h, hp, wp, depth_levels,
                             h0=h0, w0=w0)
    return pyr, [None] + slopes[1:]


def pad_to(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """``x`` (..., h, w) edge-padded at the bottom and right to (hp, wp)
    (``x`` itself where it has that shape)."""
    h, w = x.shape[-2:]
    if (hp, wp) == (h, w):
        return x
    return _edge_pad(x, 0, hp - h, 0, wp - w)


def zmagic(camera):
    """``(far - near) / near``, the hardware-depth linearisation's scale."""
    return (camera.far - camera.near) / camera.near


def linearize_depth(depth: torch.Tensor, camera) -> torch.Tensor:
    """Hardware depth -> normalised linear eye depth z/far.

    ``LinearZ(d) = 1 / (zmagic * d + 1)``, ``zmagic = (far - near)/near``;
    a forward-Z buffer is flipped first, and ``depth_mode="linear"`` passes
    through (as float32).
    """
    depth = depth.to(torch.float32)
    if camera.depth_mode == "linear":
        return depth
    d = depth if camera.reversed_z else 1.0 - depth
    return 1.0 / (zmagic(camera) * d + 1.0)


def downsample2x(z: torch.Tensor) -> torch.Tensor:
    """Pick-one 2x downsample: the (0, 0) corner of each 2x2 quad.

    Returns a strided view; callers that hand a level to a kernel make it
    contiguous first.
    """
    return z[..., ::2, ::2]


def build_pyramid(linear_z: torch.Tensor, depth_levels: int) -> list:
    """[LinearZ, DS2x, ..., DS(2^depth_levels)x]."""
    pyr = [linear_z]
    for _ in range(depth_levels):
        pyr.append(downsample2x(pyr[-1]))
    return pyr


def deinterleave_4x4(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., 16, H/4, W/4): slice ``4*i + j`` holds the
    pixels with ``row % 4 == i`` and ``col % 4 == j``."""
    h, w = x.shape[-2:]
    if h % 4 or w % 4:
        raise ValueError(f"deinterleave_4x4 needs H, W multiples of 4, "
                         f"got {(h, w)}")
    lead = x.shape[:-2]
    n = len(lead)
    x4 = x.reshape(*lead, h // 4, 4, w // 4, 4)  # (..., H4, i, W4, j)
    x4 = x4.permute(*range(n), n + 1, n + 3, n + 0, n + 2)
    return x4.reshape(*lead, 16, h // 4, w // 4)


def interleave_4x4(slices: torch.Tensor) -> torch.Tensor:
    """Inverse of ``deinterleave_4x4``: (..., 16, H/4, W/4) -> (..., H, W)."""
    lead = slices.shape[:-3]
    n = len(lead)
    hh, ww = slices.shape[-2:]
    x4 = slices.reshape(*lead, 4, 4, hh, ww)  # (..., i, j, H4, W4)
    x4 = x4.permute(*range(n), n + 2, n + 0, n + 3, n + 1)
    return x4.reshape(*lead, hh * 4, ww * 4)


def pad_parity4(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the last two dims by ``pad`` (a multiple of 4), preserving mod-4
    parity: the apron tiles the first and last 4 rows and columns, so a
    stride-4 tap that walks off the edge reads the edge texel of its own
    4x4-deinterleaved slice.  Padded row ``r < 0`` is ``x[r & 3]`` and row
    ``r >= h`` is ``x[h - 4 + ((r - h) & 3)]``; columns alike."""
    if pad % 4:
        raise ValueError(f"pad must be a multiple of 4, got {pad}")
    reps = pad // 4
    rep_r = (1,) * (x.ndim - 2) + (reps, 1)
    rep_c = (1,) * (x.ndim - 2) + (1, reps)
    x = torch.cat([x[..., :4, :].repeat(rep_r), x,
                   x[..., -4:, :].repeat(rep_r)], dim=-2)
    return torch.cat([x[..., :, :4].repeat(rep_c), x,
                      x[..., :, -4:].repeat(rep_c)], dim=-1)

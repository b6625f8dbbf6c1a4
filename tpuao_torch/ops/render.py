"""AoRender stage: the plain PyTorch per-level AO estimator.

Counterpart of ``tpuao/ops/render.py``.  It is the plain version of the
CUDA render kernels (``ops/kernels.py``): the CPU path and the reference
the kernels are held against on the card.  Each of the 68 taps is a
shifted window of the parity-4 padded level, and the pair test keeps the
JAX package's default form ``1 + (zs*inv_zc - (1 + rel))*inv_r`` (``rel``
is 0 without normals), so the two agree to float32 noise.

The normals path adds a soft-clamped tangent-plane offset per pair.  It
takes the level's normals in one of two forms:

* ``slopes_ds``: the level's ``(g_x, g_y)`` slope planes at level-0 texel
  scale (``slope_pyramid``, the pipeline's prologue); the exact 2^level
  factor folds into the pair offsets;
* ``normals_ds``: the level's raw normals, channel-last (..., h, w, 3) or
  channel-first (..., 3, h, w), with the slopes derived per level.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuao_torch.ops import prepare as P
from tpuao_torch.ops.upsample import _edge_pad
from tpuao_torch.params import build_pair_table, sphere_radius_coef

HALO = 16  # max disc offset: 4 slice texels * stride 4


class _PowGradsafe(torch.autograd.Function):
    """``x ** s`` with gradients defined at ``x == 0`` (counterpart of the
    JAX package's ``custom_jvp`` ``_pow_gradsafe``).

    The forward is ``torch.pow``, bit for bit.  The raw derivatives
    ``s x^(s-1)`` and ``x^s log(x)`` are inf/nan at x = 0, so a fully
    occluded texel (vis = 0) would poison every gradient of the frame; the
    backward evaluates them at ``max(x, 1e-12)``, the clamped-subgradient
    convention of the differentiable path (``models/autodiff.py``)."""

    @staticmethod
    def forward(ctx, x, s):
        y = torch.pow(x, s)
        ctx.save_for_backward(x, y, s if isinstance(s, torch.Tensor)
                              else None)
        ctx.s = s
        return y

    @staticmethod
    def backward(ctx, g):
        x, y, s_t = ctx.saved_tensors
        s = ctx.s if s_t is None else s_t
        xs = torch.clamp(x, min=1e-12)
        gx = s * torch.pow(xs, s - 1.0) * g if ctx.needs_input_grad[0] \
            else None
        gs = None
        if s_t is not None and ctx.needs_input_grad[1]:
            gs = (g * y * torch.log(xs)).sum().reshape(s_t.shape)
        return gx, gs


def _pow_gradsafe(x: torch.Tensor, s) -> torch.Tensor:
    """``x ** s`` (``s`` a float or a 0-d tensor) with the clamped-
    subgradient backward of ``_PowGradsafe``."""
    return _PowGradsafe.apply(x, s)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``clamp(x, lo, hi)``; under autograd in the JAX package's form
    ``min(max(x, lo), hi)`` (``jnp.clip``), whose gradient splits evenly
    where x equals a bound (``torch.clamp`` passes all of it there).  The
    render clamps at exact ties all the time (vis == 1 on an open plane),
    so the two conventions would give different gradients.  The values
    are the same either way.  The bounds are 0-d CPU tensors, which a
    binary op on a card takes as scalars: no host-to-device copy."""
    if not (x.requires_grad and torch.is_grad_enabled()):
        return torch.clamp(x, lo, hi)
    return torch.minimum(torch.maximum(x, torch.tensor(lo)), torch.tensor(hi))


def _pair_constants(params) -> list[tuple[int, int, float, float]]:
    """Static per-pair (dx, dy in level texels, thickness, weight) table."""
    offsets, weights = build_pair_table(params.exhaustive)
    out = []
    for (sx, sy), w in zip(offsets, weights):
        t = float(np.sqrt(max(1.0 - (sx * sx + sy * sy) / 25.0, 1e-12)))
        out.append((4 * int(sx), 4 * int(sy), t, float(w)))
    return out


def normals_channel_last(normals: torch.Tensor) -> torch.Tensor:
    """``normals`` in channel-last (..., H, W, 3) layout, from either
    layout.  When both the last and the third-from-last dims are 3 (e.g. a
    (3, W, 3) buffer) the layout cannot be inferred, and this raises."""
    cl = normals.shape[-1] == 3
    cf = normals.ndim >= 3 and normals.shape[-3] == 3
    if cl and cf:
        raise ValueError(
            f"ambiguous normals layout {tuple(normals.shape)}: both "
            "candidate channel dims are 3 -- pass channel-last "
            "(..., H, W, 3) with H != 3")
    if cf:
        return torch.movedim(normals, -3, -1)
    if cl:
        return normals
    raise ValueError(f"normals shape {tuple(normals.shape)} has no size-3 "
                     "channel dim")


def normals_channel_first(normals: torch.Tensor) -> torch.Tensor:
    """``normals`` in channel-first (..., 3, H, W) layout, from either
    layout (the raw-normals kernel's layout)."""
    return torch.movedim(normals_channel_last(normals), -1, -3)


def slope_planes(normals: torch.Tensor, tan_half_fov_h, full_width: int):
    """(g_x, g_y) tangent-slope planes at level-0 texel scale:
    ``(n_x, n_y) / max(n_z, 0.05) * 2 tanH / full_width``.  At level l the
    slope per level texel is exactly g * 2^l.  ``normals`` is channel-last
    (..., H, W, 3) or channel-first (..., 3, H, W)."""
    cl = normals.shape[-1] == 3
    cf = normals.ndim >= 3 and normals.shape[-3] == 3
    if cf and not cl:
        n_x, n_y, n_z = (normals[..., c, :, :] for c in range(3))
    else:
        normals = normals_channel_last(normals)
        n_x, n_y, n_z = (normals[..., c] for c in range(3))
    ts0 = 2.0 * tan_half_fov_h / full_width
    n_z = torch.clamp(n_z.to(torch.float32), min=0.05)
    # a tensor numerator: Python-scalar / tensor is reciprocal-then-
    # multiply in torch, one rounding more than the JAX package's divide;
    # a 0-d CPU one, which reaches the card as a kernel argument and not as
    # a copy, so that a CUDA graph can capture the normals path
    grad = torch.tensor(ts0, dtype=torch.float32) / n_z
    return n_x.to(torch.float32) * grad, n_y.to(torch.float32) * grad


def slope_pyramid(normals: torch.Tensor, tan_half_fov_h, hp: int, wp: int,
                  depth: int, h0: int | None = None, w0: int | None = None):
    """Edge-padded slope planes and their pick-one pyramid:
    ``[(g_x, g_y)] * (depth + 1)``, level l at 1/2^l of the (hp, wp)
    padded frame, each plane contiguous (the kernels read raw pointers)."""
    g_x, g_y = slope_planes(normals, tan_half_fov_h, wp)
    h0 = g_x.shape[-2] if h0 is None else h0
    w0 = g_x.shape[-1] if w0 is None else w0
    if (hp, wp) != (h0, w0):
        g_x = _edge_pad(g_x, 0, hp - h0, 0, wp - w0)
        g_y = _edge_pad(g_y, 0, hp - h0, 0, wp - w0)
    pyr = [(g_x, g_y)]
    for _ in range(depth):
        gx, gy = pyr[-1]
        pyr.append((gx[..., ::2, ::2], gy[..., ::2, ::2]))
    return [(gx.contiguous(), gy.contiguous()) for gx, gy in pyr]


def normals_pyramid(normals: torch.Tensor, hp: int, wp: int, depth: int):
    """Channel-first (..., 3, h, w) raw normals, edge-padded to (hp, wp),
    and their pick-one pyramid, each level contiguous: the raw-normals
    ABI (``impl="pallas"``)."""
    ncf = normals_channel_first(normals.to(torch.float32))
    h0, w0 = ncf.shape[-2:]
    if (hp, wp) != (h0, w0):
        ncf = _edge_pad(ncf, 0, hp - h0, 0, wp - w0)
    pyr = [ncf]
    for _ in range(depth):
        pyr.append(pyr[-1][..., ::2, ::2])
    return [lvl.contiguous() for lvl in pyr]


def texel_scale(level: int, full_width: int, tan_half_fov_h) -> float:
    """Tangent of one level-``level`` texel: ``2 tanH / (full_width >>
    level)``."""
    return 2.0 * tan_half_fov_h / (full_width // (1 << level))


def tangent_m2(params, radius_coef: float) -> list[float]:
    """Per-pair ``m2 = (0.5 * radius_coef * t)^2`` of the soft clamp, in
    the plain version's float64 rounding."""
    return [(0.5 * radius_coef * t) ** 2 for _, _, t, _ in
            _pair_constants(params)]


def render_ao_level(ds: torch.Tensor, level: int, full_width: int, camera,
                    params, normals_ds=None, slopes_ds=None) -> torch.Tensor:
    """AO estimate at hierarchy level ``level`` on the 1/2^level buffer
    ``ds`` (..., h, w); the output has the same shape.  With
    ``params.use_normals`` and ``slopes_ds`` or ``normals_ds`` given, the
    pair test takes the tangent-plane offset."""
    ds = ds.to(torch.float32)
    radius_coef = sphere_radius_coef(
        level, full_width, camera.tan_half_fov_h, params.screenspace_diameter)
    h, w = ds.shape[-2:]
    zp = P.pad_parity4(ds, HALO)
    use_n = params.use_normals and (normals_ds is not None
                                    or slopes_ds is not None)
    gxy = None
    if use_n and slopes_ds is not None:
        g_x, g_y = (s.to(torch.float32) for s in slopes_ds)
        gxy = (g_x, g_y, float(1 << level))
    elif use_n:
        nrm = normals_channel_first(normals_ds).to(torch.float32)
        n_z = torch.clamp(nrm[..., 2, :, :], min=0.05)
        grad = n_z.new_tensor(
            texel_scale(level, full_width, camera.tan_half_fov_h)) / n_z
        gxy = (nrm[..., 0, :, :] * grad, nrm[..., 1, :, :] * grad, 1.0)

    def window(dy, dx):
        return zp[..., HALO + dy: HALO + dy + h, HALO + dx: HALO + dx + w]

    inv_zc = 1.0 / ds
    falloff = params.rejection_falloff
    vis = torch.zeros_like(ds)
    for dx, dy, t, w_pair in _pair_constants(params):
        inv_r = 1.0 / (radius_coef * t)
        zs1 = window(dy, dx)
        zs2 = window(-dy, -dx)
        if gxy is not None:
            # soft-clamped tangent correction (golden _tangent_offset)
            g_x, g_y, off_scale = gxy
            x = g_x * (dx * off_scale) + g_y * (dy * off_scale)
            m2 = (0.5 * radius_coef * t) ** 2
            rel = x * m2 / (m2 + x * x)
            d1 = 1.0 + (zs1 * inv_zc - (1.0 + rel)) * inv_r
            d2 = 1.0 + (zs2 * inv_zc - (1.0 - rel)) * inv_r
        else:
            d1 = 1.0 + (zs1 * inv_zc - 1.0) * inv_r
            d2 = 1.0 + (zs2 * inv_zc - 1.0) * inv_r
        p1 = _clip(falloff * d1, 0.0, 1.0)
        p2 = _clip(falloff * d2, 0.0, 1.0)
        pair_vis = (torch.maximum(_clip(d1, 0.0, 1.0), p2)
                    + torch.maximum(_clip(d2, 0.0, 1.0), p1))
        vis = vis + (0.5 * w_pair) * pair_vis
    # pow gives exactly 0 at vis == 0 for every strength in range (> 0)
    return _pow_gradsafe(_clip(vis, 0.0, 1.0), params.strength)

"""The plain reference of the AO frame pipeline: a frozen copy of the
float64 spec (``tpuao_torch/golden/reference.py``), function for function,
with the program's parameters replaced by ``reference.params``.

It reads nothing of the program: every derived quantity (linear depth, the
pick-one pyramid, the normals pyramid, the per-level constants) is worked
out again from the inputs the benchmark hands it.  Arithmetic is in
``dtype``: float64 for the reference, a lower precision for the control
(``control.py``).  It keeps the spec's explicit loops over the sample-pair
table, the 3x3 noise-filter taps and the 2x2 upsample taps, and fuses
nothing.  One unbatched (H, W) frame a call, computed on the device of its
inputs.

Conventions (the spec's): (H, W) row-major, row 0 at the top; linear depth
is z_eye/far in (0, 1]; downsampling picks the (0, 0) corner of each 2x2;
AO samples that leave the frame clamp to the edge of their own 4x4 slice;
normals are unit vectors in buffer view space (x = +column, y = +row,
z toward the camera).
"""

from __future__ import annotations

import math

import torch

from aobench.reference.params import (AO, Camera, build_pair_table,
                                      padded_shape, sphere_radius_coef,
                                      upsample_constants)

F64 = torch.float64


def _pad_edge(x: torch.Tensor, rows, cols) -> torch.Tensor:
    """Edge padding of the two leading axes: a padded index reads the
    nearest edge texel."""
    h, w = x.shape[:2]
    r = torch.arange(-rows[0], h + rows[1], device=x.device).clamp(0, h - 1)
    c = torch.arange(-cols[0], w + cols[1], device=x.device).clamp(0, w - 1)
    return x.index_select(0, r).index_select(1, c)


def linearize_depth(depth: torch.Tensor, camera: Camera) -> torch.Tensor:
    """Hardware depth -> z_eye/far: ``1 / (zmagic d + 1)`` with
    ``zmagic = (far - near) / near`` (forward-Z flipped first)."""
    if camera.depth_mode == "linear":
        return depth
    zmagic = (float(camera.far) - float(camera.near)) / float(camera.near)
    d = depth if camera.reversed_z else 1.0 - depth
    return 1.0 / (zmagic * d + 1.0)


def build_pyramid(x: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """[x, x at 1/2, ..., x at 1/2^levels], each the (0, 0) corner of the
    previous level's 2x2 quads."""
    pyr = [x]
    for _ in range(levels):
        pyr.append(pyr[-1][0::2, 0::2])
    return pyr


def pad_parity4(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad by ``pad`` (a multiple of 4) on all sides, keeping mod-4 parity:
    the apron tiles the first and last 4 rows and columns."""
    assert pad % 4 == 0
    reps = pad // 4
    x = torch.cat([x[:4, :].repeat(reps, 1), x, x[-4:, :].repeat(reps, 1)],
                  dim=0)
    return torch.cat([x[:, :4].repeat(1, reps), x,
                      x[:, -4:].repeat(1, reps)], dim=1)


def _tangent_offset(normals, ox: int, oy: int, texel_scale: float,
                    half_chord: float) -> torch.Tensor:
    """Soft-clamped tangent-plane depth offset delta_z / z_c at texel
    offset (ox, oy): ``x m^2 / (m^2 + x^2)``, m half the pair chord."""
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    nz = torch.clamp(nz, min=0.05)
    x = (nx * ox + ny * oy) / nz * texel_scale
    m2 = half_chord * half_chord
    return x * m2 / (m2 + x * x)


def render_ao_level(ds: torch.Tensor, level: int, full_width: int,
                    camera: Camera, params: AO,
                    normals_ds=None) -> torch.Tensor:
    """AO at one hierarchy level of the 1/2^l linear depth ``ds``: the
    12-entry mirrored pair test, each slice-texel offset a stride-4 offset
    in ``ds``; ``AO = clip(sum_i w_i pairVis_i, 0, 1) ** strength``."""
    offsets, weights = build_pair_table(params.exhaustive)
    tan_h = float(camera.tan_half_fov_h)
    radius_coef = sphere_radius_coef(level, full_width, tan_h,
                                     float(params.screenspace_diameter))
    texel_scale = 2.0 * tan_h / (full_width // (1 << level))
    halo = 16
    zp = pad_parity4(ds, halo)
    n_c = normals_ds if normals_ds is not None and params.use_normals \
        else None
    h, w = ds.shape
    z_c = ds
    falloff = float(params.rejection_falloff)
    vis = torch.zeros_like(z_c)

    def window(arr, dy, dx):
        return arr[halo + dy: halo + dy + h, halo + dx: halo + dx + w]

    for (sx, sy), w_pair in zip(offsets.tolist(), weights.tolist()):
        dx, dy = 4 * int(sx), 4 * int(sy)
        t = math.sqrt(max(1.0 - (sx * sx + sy * sy) / 25.0, 1e-12))
        inv_r = 1.0 / (radius_coef * t)
        zs1 = window(zp, dy, dx)
        zs2 = window(zp, -dy, -dx)
        if n_c is not None:
            rel1 = _tangent_offset(n_c, dx, dy, texel_scale,
                                   0.5 * radius_coef * t)
            rel2 = -rel1
            zref1 = z_c * (1.0 + rel1)
            zref2 = z_c * (1.0 + rel2)
        else:
            zref1 = zref2 = z_c
        d1 = 1.0 + (zs1 - zref1) * inv_r / z_c
        d2 = 1.0 + (zs2 - zref2) * inv_r / z_c
        p1 = torch.clamp(falloff * d1, 0.0, 1.0)
        p2 = torch.clamp(falloff * d2, 0.0, 1.0)
        pair_vis = 0.5 * (torch.clamp(torch.maximum(d1, p2), 0.0, 1.0)
                          + torch.clamp(torch.maximum(d2, p1), 0.0, 1.0))
        vis = vis + w_pair * pair_vis
    return torch.clamp(vis, 0.0, 1.0) ** float(params.strength)


def noise_filter(lo_ao, lo_d, nfs: float) -> torch.Tensor:
    """Depth-aware 3x3 smoothing: [1,2,1] x [1,2,1] taps, each scaled by
    ``1 / (1 + nfs (d_n - d_c)^2)`` and normalised."""
    nfs = float(nfs)
    ap = _pad_edge(lo_ao, (1, 1), (1, 1))
    dp = _pad_edge(lo_d, (1, 1), (1, 1))
    h, w = lo_ao.shape
    acc = torch.zeros_like(lo_ao)
    wacc = torch.zeros_like(lo_ao)
    g = {(-1, -1): 1, (-1, 0): 2, (-1, 1): 1,
         (0, -1): 2, (0, 0): 4, (0, 1): 2,
         (1, -1): 1, (1, 0): 2, (1, 1): 1}
    for (dy, dx), gw in g.items():
        a_n = ap[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
        d_n = dp[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
        dd = d_n - lo_d
        wt = gw / (1.0 + nfs * dd * dd)
        acc += wt * a_n
        wacc += wt
    return acc / wacc


def blur_upsample_step(lo_ao, lo_d, hi_d, params: AO, full_width: int,
                       lo_ao2=None) -> torch.Tensor:
    """One chain step: [pre-min] -> noise filter on the field extended by
    one texel bottom/right -> depth-aware bilateral 2x upsample, each of
    the 4 enclosing lo taps weighted ``bilinear / ((lo_d - hi_d)^2 /
    k_blur + k_up)`` and normalised."""
    if lo_ao2 is not None:
        lo_ao = torch.minimum(lo_ao, lo_ao2)
    _, k_blur, k_up, nfs = (float(v) for v in upsample_constants(
        params, full_width, lo_d.shape[1]))
    ap = _pad_edge(lo_ao, (0, 1), (0, 1))
    dp = _pad_edge(lo_d, (0, 1), (0, 1))
    filtered = noise_filter(ap, dp, nfs)
    hh, hw = hi_d.shape
    dev, dt = hi_d.device, hi_d.dtype
    r = torch.arange(hh, device=dev)
    c = torch.arange(hw, device=dev)
    r0, c0 = r // 2, c // 2
    fr = (r % 2).to(dt) * 0.5
    fc = (c % 2).to(dt) * 0.5
    acc = torch.zeros((hh, hw), dtype=dt, device=dev)
    wacc = torch.zeros((hh, hw), dtype=dt, device=dev)
    for dr in (0, 1):
        for dc in (0, 1):
            a = filtered.index_select(0, r0 + dr).index_select(1, c0 + dc)
            d = dp.index_select(0, r0 + dr).index_select(1, c0 + dc)
            bw = ((1.0 - fr if dr == 0 else fr)[:, None]
                  * (1.0 - fc if dc == 0 else fc)[None, :])
            dd = d - hi_d
            wt = bw / (dd * dd / k_blur + k_up)
            acc += wt * a
            wacc += wt
    return acc / torch.clamp(wacc, min=1e-30)


def render_frame(depth: torch.Tensor, camera: Camera, params: AO,
                 normals=None, dtype: torch.dtype = F64) -> torch.Tensor:
    """Depth (H, W) [+ channel-last normals (H, W, 3)] -> AO (H, W) in
    [0, 1], in ``dtype``: edge-pad to a multiple of 64, linearise, the
    pick-one pyramid, every level's render, the pre-min chain of blur +
    upsample steps to full resolution, the crop.  Without blur: the
    nearest 2x of level 1."""
    depth = depth.to(dtype)
    h0, w0 = depth.shape
    hp, wp = padded_shape(h0, w0)
    depth = _pad_edge(depth, (0, hp - h0), (0, wp - w0))
    if normals is not None:
        normals = _pad_edge(normals.to(dtype), (0, hp - h0), (0, wp - w0))
    d = params.hierarchy_depth
    linz = linearize_depth(depth, camera)
    pyr = build_pyramid(linz, d)
    npyr = build_pyramid(normals, d) if (
        normals is not None and params.use_normals) else [None] * (d + 1)
    aos = {l: render_ao_level(pyr[l], l, wp, camera, params, npyr[l])
           for l in range(1, d + 1)}
    if not params.enable_blur:
        ao = aos[1].repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
        return ao[:h0, :w0]
    combined = aos[d]
    for l in range(d, 0, -1):
        combined = blur_upsample_step(combined, pyr[l], pyr[l - 1], params,
                                      wp, lo_ao2=aos[l] if l != d else None)
    return combined[:h0, :w0]

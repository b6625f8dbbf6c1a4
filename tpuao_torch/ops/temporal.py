"""Temporal AO resolve: history accumulation with reprojection.

Counterpart of ``tpuao/ops/temporal.py`` (spec: ``tpuao/golden/
temporal.py``).  Each frame blends the reprojected history into the
current AO::

    (ip, jp)  = previous-frame coordinates of each texel (camera motion
                (4, 4), or a per-pixel motion-vector buffer)
    hist, d_h = bilinear(prev_ao, prev_depth) at (ip, jp)
    conf      = clip(1 - |d_h - expected| / max(expected, 1e-6) / tol, 0, 1)
    alpha     = history_weight * valid * conf
    out       = alpha * clip(hist, min3x3, max3x3) + (1 - alpha) * curr_ao

With ``tparams.max_displacement = r`` the history sample is the windowed
form: a tent-weighted sum over the (2r+2)^2 offsets [-r, r+1]^2 of the
edge-padded history (``_bilinear_windowed2``, the plain version of the
CUDA kernel ``ops/kernels.windowed_resolve``).  ``impl`` routes it: on CUDA
tensors ``"auto"``, ``"fused"`` and ``"pallas"`` launch the kernel and
``"jnp"`` runs the plain version; on CPU tensors every value runs the
plain version.  ``max_displacement=None`` samples with a plain gather.
All other work is plain PyTorch.

The float32 formula order of the JAX package is kept: the reprojected
coordinates reach ~1900 at 1080p, and their rounding feeds the bilinear
weights.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuao_torch.ops.upsample import _edge_pad

# Any real normalised depth (<= 1) is rejected against this sentinel for
# every in-range depth_tolerance: the null history has zero confidence.
NULL_DEPTH = 1.0e6


def initial_state(h: int, w: int, device=None):
    """Null history ``(ao=1, depth=NULL_DEPTH)``, (h, w) float32 each:
    frame 0 resolves to its own single-frame AO (zero confidence)."""
    return (torch.ones((h, w), dtype=torch.float32, device=device),
            torch.full((h, w), NULL_DEPTH, dtype=torch.float32,
                       device=device))


def _neighborhood_bounds(ao: torch.Tensor):
    """(min, max) over the edge-clamped 3x3 neighbourhood."""
    h, w = ao.shape[-2:]
    p = _edge_pad(ao, 1, 1, 1, 1)
    lo = ao
    hi = ao
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            win = p[..., 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
            lo = torch.minimum(lo, win)
            hi = torch.maximum(hi, win)
    return lo, hi


def _motion_matrix(motion) -> np.ndarray:
    """A (4, 4) motion as host float32 values: each entry then multiplies
    a float32 tensor as the JAX package's float32 matrix entries do."""
    m = (motion.detach().cpu().numpy() if isinstance(motion, torch.Tensor)
         else np.asarray(motion))
    return m.astype(np.float32)


def _project(x, y, z, m: np.ndarray, tanh: float, tan_v: float, h, w,
             far: float):
    """(ip, jp, z_prev / far, in_front) of eye points (x, y, z) moved by
    ``m`` into the previous frame of an (h, w) image."""
    f = [[float(v) for v in row] for row in m]
    xp = f[0][0] * x + f[0][1] * y + f[0][2] * z + f[0][3]
    yp = f[1][0] * x + f[1][1] * y + f[1][2] * z + f[1][3]
    zp = f[2][0] * x + f[2][1] * y + f[2][2] * z + f[2][3]
    in_front = zp > 0.0
    zs = torch.where(in_front, zp, torch.ones_like(zp))
    jp = ((xp / (zs * tanh)) + 1.0) * (0.5 * w) - 0.5
    ip = (1.0 - (yp / (zs * tan_v))) * (0.5 * h) - 0.5
    return ip, jp, zp / far, in_front


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=like.device)


def _reproject_coords(depth: torch.Tensor, camera, motion):
    """Previous-frame coordinates ``(ip, jp, z_prev_norm, in_front)`` of
    every texel of ``depth`` (h, w) under the (4, 4) ``motion``."""
    h, w = depth.shape[-2:]
    tanh = camera.tan_half_fov_h
    tan_v = tanh * (h / w)
    u = (2.0 * (_arange(w, depth) + 0.5) / w) - 1.0
    v = 1.0 - 2.0 * (_arange(h, depth) + 0.5) / h
    z = depth * camera.far
    x = (u[None, :] * tanh) * z
    y = (v[:, None] * tan_v) * z
    return _project(x, y, z, _motion_matrix(motion), tanh, tan_v, h, w,
                    camera.far)


def _mv_planes(mv, device):
    """(di, dj) planes of a motion-vector buffer, channel-last (H, W, 2)
    or channel-first (2, H, W).  A tensor must lie on ``device``; NumPy
    input is placed there."""
    if isinstance(mv, torch.Tensor):
        if mv.device != device:
            raise ValueError(f"motion vectors on {mv.device}, expected "
                             f"{device}")
    else:
        mv = torch.as_tensor(np.asarray(mv, np.float32), device=device)
    mv = mv.to(torch.float32)
    if mv.ndim != 3:
        raise ValueError(f"motion vectors must be rank 3, got "
                         f"{tuple(mv.shape)}")
    if mv.shape[0] == 2 and mv.shape[-1] != 2:
        return mv[0], mv[1]
    if mv.shape[-1] == 2:
        return mv[..., 0], mv[..., 1]
    raise ValueError("motion vectors must be (H, W, 2) or (2, H, W), got "
                     f"{tuple(mv.shape)}")


def _bilinear_gather2(ao: torch.Tensor, d: torch.Tensor, ip: torch.Tensor,
                      jp: torch.Tensor):
    """Bilinear sample of both history fields at (ip, jp) by a gather, for
    unbounded motion; coordinates clip to the frame (validity is the
    caller's mask).  Returns ``(hist_ao, hist_depth)``."""
    h, w = ao.shape[-2:]
    ip = torch.clamp(ip, 0.0, h - 1.0)
    jp = torch.clamp(jp, 0.0, w - 1.0)
    i0 = (torch.clamp(torch.floor(ip), max=h - 2.0) if h > 1
          else torch.zeros_like(ip))
    j0 = (torch.clamp(torch.floor(jp), max=w - 2.0) if w > 1
          else torch.zeros_like(jp))
    fi = ip - i0
    fj = jp - j0
    i0 = i0.to(torch.int64)
    j0 = j0.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=h - 1)
    j1 = torch.clamp(j0 + 1, max=w - 1)
    flat = torch.stack([ao.reshape(-1), d.reshape(-1)])  # (2, H*W)

    def tap(ii, jj):
        return flat[:, ii * w + jj]  # (2, H, W)

    top = tap(i0, j0) * (1.0 - fj) + tap(i0, j1) * fj
    bot = tap(i1, j0) * (1.0 - fj) + tap(i1, j1) * fj
    out = top * (1.0 - fi) + bot * fi
    return out[0], out[1]


def _bilinear_windowed2(ao: torch.Tensor, d: torch.Tensor, ip: torch.Tensor,
                        jp: torch.Tensor, r: int):
    """Bilinear sample of both (h, w) history fields at (ip, jp) as the
    tent-weighted sum over the (2r+2)^2 shifted windows of the edge-padded
    fields: exact wherever |ip - i| <= r and |jp - j| <= r; offsets outside
    [-r, r+1] contribute nothing.  Row offsets outside, column taps
    inside, summed per row first.  The plain version of
    ``ops/kernels.windowed_resolve``."""
    h, w = ao.shape[-2:]
    di = ip - _arange(h, ao)[:, None]
    dj = jp - _arange(w, ao)[None, :]
    p = r + 1  # offsets span [-r, r+1]
    sp = _edge_pad(torch.stack([ao, d]).to(torch.float32), p, p, p, p)
    acc = torch.zeros((2, h, w), dtype=torch.float32, device=ao.device)
    for oy in range(-r, r + 2):
        band = sp[:, p + oy: p + oy + h, :]
        ty = torch.clamp(1.0 - torch.abs(di - float(oy)), min=0.0)
        inner = torch.zeros_like(acc)
        for ox in range(-r, r + 2):
            t = ty * torch.clamp(1.0 - torch.abs(dj - float(ox)), min=0.0)
            inner = inner + t[None] * band[:, :, p + ox: p + ox + w]
        acc = acc + inner
    return acc[0], acc[1]


def _history_sample(prev_ao, prev_d, ip, jp, r, impl: str):
    """The history sample at (ip, jp): gather (``r is None``), else the
    windowed kernel (plain version under ``impl="jnp"``)."""
    if r is None:
        return _bilinear_gather2(prev_ao, prev_d, ip, jp)
    if impl == "jnp":
        return _bilinear_windowed2(prev_ao, prev_d, ip, jp, r)
    from tpuao_torch.ops import kernels as K

    return K.windowed_resolve(prev_ao.contiguous(), prev_d.contiguous(),
                              ip.contiguous(), jp.contiguous(), r)


def _blend(curr_ao, hist, d_hist, expected, valid, tparams):
    rel_err = torch.abs(d_hist - expected) / torch.clamp(expected, min=1e-6)
    conf = torch.clamp(1.0 - rel_err / tparams.depth_tolerance, 0.0, 1.0)
    alpha = tparams.history_weight * valid * conf
    if tparams.neighborhood_clamp:
        lo, hi = _neighborhood_bounds(curr_ao)
        hist = torch.minimum(torch.maximum(hist, lo), hi)
    return alpha * hist + (1.0 - alpha) * curr_ao


def _check_impl(impl: str) -> None:
    if impl not in ("auto", "jnp", "pallas", "fused"):
        raise ValueError(f"impl={impl!r} must be one of auto, jnp, pallas, "
                         "fused")


def temporal_resolve(curr_ao, curr_depth, prev_ao, prev_depth, camera,
                     tparams, motion=None, impl: str = "auto"):
    """One temporal resolve step; all fields (H, W), depths normalised
    linear eye depth.  Returns the resolved AO; the next history is
    ``(resolved, curr_depth)``.

    ``motion``: None (static camera, no resample), a (4, 4) current->
    previous eye transform, or a motion-vector tensor (H, W, 2) or
    (2, H, W) on the fields' device (pixel units, current->previous, row
    offset first; disocclusion then tests the history depth against the
    current depth).
    """
    _check_impl(impl)
    curr_ao = curr_ao.to(torch.float32)
    curr_depth = curr_depth.to(torch.float32)
    prev_ao = prev_ao.to(torch.float32)
    prev_depth = prev_depth.to(torch.float32)
    h, w = curr_ao.shape[-2:]

    if motion is None:
        return _blend(curr_ao, prev_ao, prev_depth, curr_depth, 1.0, tparams)
    if np.ndim(motion) == 3:  # per-pixel motion vectors
        di, dj = _mv_planes(motion, curr_ao.device)
        ip = di + _arange(h, curr_ao)[:, None]
        jp = dj + _arange(w, curr_ao)[None, :]
        expected = curr_depth
        valid = ((ip >= -0.5) & (ip <= h - 0.5)
                 & (jp >= -0.5) & (jp <= w - 0.5))
    else:
        ip, jp, z_prev, in_front = _reproject_coords(curr_depth, camera,
                                                     motion)
        expected = z_prev
        valid = (in_front
                 & (ip >= -0.5) & (ip <= h - 0.5)
                 & (jp >= -0.5) & (jp <= w - 0.5))
    r = tparams.max_displacement
    hist, d_hist = _history_sample(prev_ao, prev_depth, ip, jp, r, impl)
    if r is not None:
        rf = float(r)
        di = ip - _arange(h, curr_ao)[:, None]
        dj = jp - _arange(w, curr_ao)[None, :]
        valid = valid & (torch.abs(di) <= rf) & (torch.abs(dj) <= rf)
    return _blend(curr_ao, hist, d_hist, expected, valid.to(torch.float32),
                  tparams)


def _reproject_coords_l1(depth_l1: torch.Tensor, h0: int, w0: int, camera,
                         motion):
    """Reprojection of the pick-one half-res field of an (h0, w0) frame:
    half texel (i, j) holds full texel (2i, 2j).  Returns full-res-unit
    ``(ip_f, jp_f, z_prev_norm, in_front)``."""
    h1, w1 = depth_l1.shape[-2:]
    tanh = camera.tan_half_fov_h
    tan_v = tanh * (h0 / w0)
    u = (2.0 * (2.0 * _arange(w1, depth_l1) + 0.5) / w0) - 1.0
    v = 1.0 - 2.0 * (2.0 * _arange(h1, depth_l1) + 0.5) / h0
    z = depth_l1 * camera.far
    x = (u[None, :] * tanh) * z
    y = (v[:, None] * tan_v) * z
    return _project(x, y, z, _motion_matrix(motion), tanh, tan_v, h0, w0,
                    camera.far)


def temporal_resolve_l1(curr_ao1, curr_d1, prev_ao1, prev_d1, h0: int,
                        w0: int, camera, tparams, motion=None,
                        impl: str = "auto"):
    """Half-res resolve: the resolve applied to the level-1 AO and depth of
    an (h0, w0) frame, both at the true half dims (ceil(h0/2),
    ceil(w0/2)).  ``max_displacement`` keeps its full-res meaning, so the
    windowed sample needs radius ceil(R/2).  ``motion`` as in
    ``temporal_resolve``; a motion-vector buffer is full-res."""
    _check_impl(impl)
    curr_ao1 = curr_ao1.to(torch.float32)
    curr_d1 = curr_d1.to(torch.float32)
    prev_ao1 = prev_ao1.to(torch.float32)
    prev_d1 = prev_d1.to(torch.float32)
    h1, w1 = curr_ao1.shape[-2:]

    if motion is None:
        return _blend(curr_ao1, prev_ao1, prev_d1, curr_d1, 1.0, tparams)
    if np.ndim(motion) == 3:  # full-res motion vectors, pick-one sampled
        di_f, dj_f = _mv_planes(motion, curr_ao1.device)
        ip_f = di_f[::2, ::2] + 2.0 * _arange(h1, curr_ao1)[:, None]
        jp_f = dj_f[::2, ::2] + 2.0 * _arange(w1, curr_ao1)[None, :]
        expected = curr_d1
        valid = ((ip_f >= -0.5) & (ip_f <= h0 - 0.5)
                 & (jp_f >= -0.5) & (jp_f <= w0 - 0.5))
    else:
        ip_f, jp_f, z_prev, in_front = _reproject_coords_l1(
            curr_d1, h0, w0, camera, motion)
        expected = z_prev
        valid = (in_front
                 & (ip_f >= -0.5) & (ip_f <= h0 - 0.5)
                 & (jp_f >= -0.5) & (jp_f <= w0 - 0.5))
    r = tparams.max_displacement
    hist, d_hist = _history_sample(prev_ao1, prev_d1, ip_f * 0.5,
                                   jp_f * 0.5,
                                   None if r is None else -(-int(r) // 2),
                                   impl)
    if r is not None:
        rf = float(r)
        di = ip_f - 2.0 * _arange(h1, curr_ao1)[:, None]
        dj = jp_f - 2.0 * _arange(w1, curr_ao1)[None, :]
        valid = valid & (torch.abs(di) <= rf) & (torch.abs(dj) <= rf)
    return _blend(curr_ao1, hist, d_hist, expected, valid.to(torch.float32),
                  tparams)

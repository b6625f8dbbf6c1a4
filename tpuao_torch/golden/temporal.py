"""Golden float64 spec for temporal AO accumulation (reprojection resolve),
in PyTorch.

Counterpart of ``tpuao/golden/temporal.py``, function for function, under
the same names and conventions; devices, dtypes and parameters as in
``tpuao_torch.golden.reference`` (float64 tensors, NumPy input to the
call's tensor device or ``device=``, tunables read through ``float``).

The reference (keijiro/MiniEngineAO) is a single-frame effect -- it has no
temporal component (SURVEY.md SS1).  This module is a BEYOND-REFERENCE
capability for the sequence/streaming/serving surfaces: an exponential
history accumulator with camera reprojection and depth-based disocclusion
rejection.  Like every other stage, the slow, obviously-correct
implementation here IS the spec; the port's ``ops/temporal.py`` must match
it to <= 1e-3 max-abs-err.

Conventions fixed by this spec
------------------------------

* Depth fields are *normalized linear eye depth* ``z_eye / far`` in (0, 1]
  -- the pipeline's post-linearize representation (golden/reference.py),
  NOT hardware depth.  Camera intrinsics (``tan_half_fov_h``, ``far``) are
  assumed constant across the sequence; only the camera *pose* moves.
* Eye space is the utils/camera.py convention: the camera sits at the
  origin looking down **+z**, ``x = +right`` (increasing column),
  ``y = +up`` (DEcreasing row -- row 0 is the top of the frame).  The
  vertical half-fov tangent is ``tan_half_fov_v = tan_half_fov_h * H / W``
  (square pixels).
* ``motion`` is the row-major 4x4 rigid transform taking CURRENT-frame eye
  coordinates to PREVIOUS-frame eye coordinates::

      p_prev = motion @ [x_curr, y_curr, z_curr, 1]

  i.e. ``motion = view_prev @ inv(view_curr)`` for world->eye view
  matrices.  ``None`` means a static camera (identity reprojection,
  gather-free).  Its 16 entries are Python floats in the arithmetic.
* ``motion`` may instead be a per-pixel MOTION-VECTOR buffer (H, W, 2):
  ``mv[i, j] = (di, dj)`` maps current pixel (i, j) to its previous-frame
  position ``(i + di, j + dj)`` in pixel units (row offset first, +down /
  +right).  With no reprojected eye depth available, the disocclusion test
  expects the history depth to match the CURRENT frame's depth along the
  motion path (``expected = curr_depth`` -- the standard TAA
  depth-agreement test).  A zero buffer is texel-for-texel identical to
  the static-camera path.
* Pixel (i, j) has continuous image coordinates (i + 0.5, j + 0.5);
  reprojected history is sampled bilinearly at the continuous coordinate.
  Samples reprojecting outside the frame, behind the camera, or onto a
  surface whose stored depth disagrees with the reprojected depth
  (disocclusion) lose history confidence and fall back to the current
  frame's AO.

Resolve (the spec)
------------------

::

    z'        = (motion @ eye(i, j, depth)).z            (reprojected eye z)
    (i', j')  = project(motion @ eye(i, j, depth))       (prev pixel coords)
    hist      = bilinear(prev_ao,    i', j')
    d_hist    = bilinear(prev_depth, i', j')
    rel_err   = |d_hist - z'/far| / max(z'/far, 1e-6)
    conf      = clip(1 - rel_err / depth_tolerance, 0, 1)   (soft rejection)
    valid     = [z' > 0] * [-0.5 <= i' <= H-0.5] * [-0.5 <= j' <= W-0.5]
                * [|i'-i| <= R] * [|j'-j| <= R]     (if max_displacement=R)
    alpha     = history_weight * valid * conf
    hist      = clip(hist, min3x3(curr_ao), max3x3(curr_ao))   (if clamping)
    out       = alpha * hist + (1 - alpha) * curr_ao

The neighborhood clamp (``neighborhood_clamp=True``, the default) bounds
history to the 3x3 min/max envelope of the current frame's AO -- the
standard anti-ghosting measure for occlusion changes that depth agreement
cannot catch.  ``max_displacement=R`` (default 4) additionally invalidates
history that reprojects more than R pixels away from its output pixel (a
motion clamp; it is what lets the port's windowed-resolve kernel read a
bounded window); ``max_displacement=None`` keeps the unbounded gather.

A fresh sequence starts from the null history ``(ao=1, depth=NULL_DEPTH)``:
the depth mismatch drives ``conf`` to 0 everywhere, so frame 0 resolves to
exactly its own single-frame AO with no special-casing.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuao_torch.golden.reference import (
    _device_of,
    _f64,
    _pad_edge,
    blur_upsample_step,
    linearize_depth,
    render_frame_golden,
)
from tpuao_torch.params import CameraParams, TemporalParams, padded_shape

__all__ = [
    "NULL_DEPTH",
    "eye_rays",
    "mv_coords",
    "reproject_coords",
    "reproject_coords_l1",
    "bilinear_sample",
    "neighborhood_bounds",
    "temporal_resolve_golden",
    "temporal_resolve_l1_golden",
    "render_frame_l1_temporal_golden",
    "render_sequence_golden",
]

# Null-history depth sentinel: any real normalized depth is <= 1, so the
# relative depth error vs NULL_DEPTH saturates confidence to 0 for every
# in-range depth_tolerance -- frame 0 of a sequence keeps no history.
NULL_DEPTH = 1.0e6


def _ndim(x) -> int:
    return x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)


def _motion4x4(motion) -> list[list[float]]:
    """The 4x4 ``motion`` as rows of Python floats; raises on any other
    shape."""
    m = (motion.detach().cpu().numpy() if isinstance(motion, torch.Tensor)
         else motion)
    m = np.asarray(m, dtype=np.float64)
    if m.shape != (4, 4):
        raise ValueError(f"motion must be 4x4, got {m.shape}")
    return m.tolist()


def eye_rays(h: int, w: int, tan_half_fov_h: float, device=None):
    """Per-pixel eye-space ray slopes ``(xr, yr)``: ``x_eye = xr * z_eye``,
    ``y_eye = yr * z_eye`` at the pixel center (see module conventions)."""
    dev = _device_of(device)
    tan_half_fov_h = float(tan_half_fov_h)
    tan_v = tan_half_fov_h * h / w
    u = (2.0 * (torch.arange(w, dtype=torch.float64, device=dev) + 0.5)
         / w) - 1.0
    v = 1.0 - 2.0 * (torch.arange(h, dtype=torch.float64, device=dev)
                     + 0.5) / h
    xr = (u[None, :] * tan_half_fov_h).expand(h, w)
    yr = (v[:, None] * tan_v).expand(h, w)
    return xr, yr


def reproject_coords(depth, camera: CameraParams, motion, device=None):
    """Continuous previous-frame pixel coords + reprojected depth.

    Returns ``(ip, jp, z_prev_norm, in_front)`` where (ip, jp) are the
    continuous row/col coordinates in the previous frame, ``z_prev_norm``
    is the reprojected normalized depth z'/far, and ``in_front`` flags
    ``z' > 0`` (points that stay in front of the previous camera).
    """
    dev = _device_of(device, depth)
    depth = _f64(depth, dev)
    m = _motion4x4(motion)
    h, w = depth.shape
    tanh = float(camera.tan_half_fov_h)
    tan_v = tanh * h / w
    xr, yr = eye_rays(h, w, tanh, device=dev)
    z = depth * float(camera.far)
    x, y = xr * z, yr * z
    xp = m[0][0] * x + m[0][1] * y + m[0][2] * z + m[0][3]
    yp = m[1][0] * x + m[1][1] * y + m[1][2] * z + m[1][3]
    zp = m[2][0] * x + m[2][1] * y + m[2][2] * z + m[2][3]
    in_front = zp > 0.0
    zs = torch.where(in_front, zp, 1.0)  # keep the divide well-defined
    up = xp / (zs * tanh)
    vp = yp / (zs * tan_v)
    jp = (up + 1.0) * 0.5 * w - 0.5
    ip = (1.0 - vp) * 0.5 * h - 0.5
    return ip, jp, zp / float(camera.far), in_front


def mv_coords(mv, device=None):
    """Continuous previous-frame pixel coords from a per-pixel
    motion-vector buffer (module conventions: ``mv[i, j] = (di, dj)``,
    current -> previous, pixel units, row offset first).

    Returns ``(ip, jp)``; there is no reprojected depth -- the resolve's
    depth-agreement test uses the CURRENT frame's depth as the expected
    history depth (``expected = curr_depth``).
    """
    dev = _device_of(device, mv)
    mv = _f64(mv, dev)
    if mv.ndim != 3 or mv.shape[-1] != 2:
        raise ValueError(
            f"motion vectors must be (H, W, 2), got {tuple(mv.shape)}")
    h, w = mv.shape[:2]
    ip = mv[..., 0] + torch.arange(h, dtype=torch.float64, device=dev)[:, None]
    jp = mv[..., 1] + torch.arange(w, dtype=torch.float64, device=dev)[None, :]
    return ip, jp


def bilinear_sample(field, ip, jp, device=None):
    """Bilinear sample of (H, W) ``field`` at continuous coords (ip, jp).

    Coordinates are clipped to the valid square first -- out-of-bounds
    VALIDITY is the caller's concern (temporal_resolve_golden masks those
    texels to zero confidence); clipping merely keeps the taps in range.
    Tap indices are int64, as the spec's ``astype(np.int64)``.
    """
    dev = _device_of(device, field, ip, jp)
    field = _f64(field, dev)
    ip = _f64(ip, dev)
    jp = _f64(jp, dev)
    h, w = field.shape
    ip = torch.clamp(ip, 0.0, h - 1.0)
    jp = torch.clamp(jp, 0.0, w - 1.0)
    i0 = torch.clamp(torch.floor(ip).to(torch.int64), max=h - 2) if h > 1 \
        else torch.zeros_like(ip, dtype=torch.int64)
    j0 = torch.clamp(torch.floor(jp).to(torch.int64), max=w - 2) if w > 1 \
        else torch.zeros_like(jp, dtype=torch.int64)
    fi = ip - i0
    fj = jp - j0
    i1 = torch.clamp(i0 + 1, max=h - 1)
    j1 = torch.clamp(j0 + 1, max=w - 1)
    f00 = field[i0, j0]
    f01 = field[i0, j1]
    f10 = field[i1, j0]
    f11 = field[i1, j1]
    top = f00 * (1.0 - fj) + f01 * fj
    bot = f10 * (1.0 - fj) + f11 * fj
    return top * (1.0 - fi) + bot * fi


def neighborhood_bounds(ao, device=None):
    """(min, max) over the edge-clamped 3x3 neighborhood of each texel."""
    ao = _f64(ao, _device_of(device, ao))
    p = _pad_edge(ao, (1, 1), (1, 1))
    h, w = ao.shape
    lo = torch.full_like(ao, np.inf)
    hi = torch.full_like(ao, -np.inf)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            win = p[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
            lo = torch.minimum(lo, win)
            hi = torch.maximum(hi, win)
    return lo, hi


def temporal_resolve_golden(
    curr_ao,
    curr_depth,
    prev_ao,
    prev_depth,
    camera: CameraParams,
    tparams: TemporalParams,
    motion=None,
    device=None,
) -> torch.Tensor:
    """One temporal resolve step (see module docstring for the spec).

    All four fields are (H, W); depths are normalized linear eye depth.
    Returns the resolved AO; the caller's next-frame history state is
    ``(resolved_ao, curr_depth)``.
    """
    dev = _device_of(device, curr_ao, curr_depth, prev_ao, prev_depth)
    curr_ao = _f64(curr_ao, dev)
    curr_depth = _f64(curr_depth, dev)
    prev_ao = _f64(prev_ao, dev)
    prev_depth = _f64(prev_depth, dev)
    h, w = curr_ao.shape

    if motion is None:
        hist = prev_ao
        d_hist = prev_depth
        expected = curr_depth
        valid = torch.ones((h, w), dtype=torch.float64, device=dev)
    else:
        if _ndim(motion) == 3:  # per-pixel motion vectors (H, W, 2)
            ip, jp = mv_coords(motion, device=dev)
            expected = curr_depth  # TAA depth agreement (module docstring)
            in_front = torch.ones((h, w), dtype=torch.bool, device=dev)
        else:
            ip, jp, z_prev, in_front = reproject_coords(curr_depth, camera,
                                                        motion)
            expected = z_prev
        hist = bilinear_sample(prev_ao, ip, jp)
        d_hist = bilinear_sample(prev_depth, ip, jp)
        # validity over the frame RECTANGLE [-0.5, H-0.5] (edge texels
        # extend half a texel past their center; bilinear clamps there) --
        # a center-lattice [0, H-1] test would invalidate the frame's own
        # edge rows under identity motion from f.p. coordinate roundoff
        valid = (
            in_front
            & (ip >= -0.5) & (ip <= h - 0.5)
            & (jp >= -0.5) & (jp <= w - 0.5)
        )
        if tparams.max_displacement is not None:
            r = float(tparams.max_displacement)
            ii = torch.arange(h, dtype=torch.float64, device=dev)[:, None]
            jj = torch.arange(w, dtype=torch.float64, device=dev)[None, :]
            valid = valid & ((ip - ii).abs() <= r) & ((jp - jj).abs() <= r)
        valid = valid.to(torch.float64)

    rel_err = (d_hist - expected).abs() / torch.clamp(expected, min=1e-6)
    conf = torch.clamp(1.0 - rel_err / float(tparams.depth_tolerance),
                       0.0, 1.0)
    alpha = float(tparams.history_weight) * valid * conf
    if tparams.neighborhood_clamp:
        lo, hi = neighborhood_bounds(curr_ao)
        hist = torch.clamp(hist, lo, hi)
    return alpha * hist + (1.0 - alpha) * curr_ao


def reproject_coords_l1(depth_l1, h0: int, w0: int, camera: CameraParams,
                        motion, device=None):
    """Reprojection for the LEVEL-1 (pick-one half-res) field of an
    (h0, w0) frame.

    Half-res texel (i, j) holds full-res texel (2i, 2j) (pick-one
    downsampling, golden/reference.py::downsample2x), so its eye ray passes
    through full-res index coordinate (2i, 2j) of the TRUE frame -- NOT
    through (i, j) of a fictitious uniform half grid (that convention would
    shift every ray by half a full-res pixel and bias the depth-agreement
    test).  Returns ``(ip_full, jp_full, z_prev_norm, in_front)`` with the
    previous-frame coordinates in FULL-RES index units; the half-grid
    bilinear sample coordinate is ``ip_full / 2`` (half texel k sits at
    full index coord 2k).
    """
    dev = _device_of(device, depth_l1)
    depth_l1 = _f64(depth_l1, dev)
    m = _motion4x4(motion)
    h1, w1 = depth_l1.shape
    tanh = float(camera.tan_half_fov_h)
    tan_v = tanh * h0 / w0
    # rays of the retained full-res texels: full index coords (2i, 2j)
    u = (2.0 * (2.0 * torch.arange(w1, dtype=torch.float64, device=dev)
                + 0.5) / w0) - 1.0
    v = 1.0 - 2.0 * (2.0 * torch.arange(h1, dtype=torch.float64, device=dev)
                     + 0.5) / h0
    xr = (u[None, :] * tanh).expand(h1, w1)
    yr = (v[:, None] * tan_v).expand(h1, w1)
    z = depth_l1 * float(camera.far)
    x, y = xr * z, yr * z
    xp = m[0][0] * x + m[0][1] * y + m[0][2] * z + m[0][3]
    yp = m[1][0] * x + m[1][1] * y + m[1][2] * z + m[1][3]
    zp = m[2][0] * x + m[2][1] * y + m[2][2] * z + m[2][3]
    in_front = zp > 0.0
    zs = torch.where(in_front, zp, 1.0)
    up = xp / (zs * tanh)
    vp = yp / (zs * tan_v)
    jp = (up + 1.0) * 0.5 * w0 - 0.5
    ip = (1.0 - vp) * 0.5 * h0 - 0.5
    return ip, jp, zp / float(camera.far), in_front


def temporal_resolve_l1_golden(
    curr_ao1,
    curr_d1,
    prev_ao1,
    prev_d1,
    h0: int,
    w0: int,
    camera: CameraParams,
    tparams: TemporalParams,
    motion=None,
    device=None,
) -> torch.Tensor:
    """Half-res temporal resolve: the spec formula applied at LEVEL 1.

    All four fields are the (ceil(h0/2), ceil(w0/2)) pick-one half-res
    planes of an (h0, w0) frame (the pipeline's level-1 combined AO and
    depth-pyramid level 1, cropped to true half dims).  Semantics match
    ``temporal_resolve_golden`` texel-for-texel with these mappings:

    * reprojection uses the TRUE full-res ray of each retained texel
      (``reproject_coords_l1``); history is sampled bilinearly on the
      half grid at ``(ip_full/2, jp_full/2)``;
    * ``max_displacement`` keeps its full-res-pixel meaning: validity is
      ``|ip_full - 2i| <= R`` (identical motion bound as the full-res
      spec);
    * frame-rectangle validity tests the full-res frame rectangle;
    * the anti-ghosting clamp is the 3x3 envelope of the CURRENT half-res
      AO (a 3x3 half-res neighborhood spans ~5x5 full-res texels --
      slightly wider, strictly safer against ghosting).

    Returns the resolved half-res AO; the caller's next history state is
    ``(resolved, curr_d1)``.  The full-res frame is produced by lifting the
    resolved field through the standard final bilateral upsample
    (``render_frame_l1_temporal_golden``).
    """
    dev = _device_of(device, curr_ao1, curr_d1, prev_ao1, prev_d1)
    curr_ao1 = _f64(curr_ao1, dev)
    curr_d1 = _f64(curr_d1, dev)
    prev_ao1 = _f64(prev_ao1, dev)
    prev_d1 = _f64(prev_d1, dev)
    h1, w1 = curr_ao1.shape

    if motion is None:
        hist = prev_ao1
        d_hist = prev_d1
        expected = curr_d1
        valid = torch.ones((h1, w1), dtype=torch.float64, device=dev)
    else:
        if _ndim(motion) == 3:  # FULL-RES (h0, w0, 2) motion vectors:
            # the retained texel (i, j) holds full-res texel (2i, 2j), so
            # its motion is the pick-one sample of the full-res buffer
            mv = _f64(motion, dev)
            if tuple(mv.shape) != (h0, w0, 2):
                raise ValueError(f"motion vectors must be ({h0}, {w0}, 2), "
                                 f"got {tuple(mv.shape)}")
            mv1 = mv[::2][:, ::2]
            ii = 2.0 * torch.arange(h1, dtype=torch.float64,
                                    device=dev)[:, None]
            jj = 2.0 * torch.arange(w1, dtype=torch.float64,
                                    device=dev)[None, :]
            ip_f = mv1[..., 0] + ii
            jp_f = mv1[..., 1] + jj
            expected = curr_d1  # TAA depth agreement (module docstring)
            in_front = torch.ones((h1, w1), dtype=torch.bool, device=dev)
        else:
            ip_f, jp_f, z_prev, in_front = reproject_coords_l1(
                curr_d1, h0, w0, camera, motion)
            expected = z_prev
        hist = bilinear_sample(prev_ao1, ip_f / 2.0, jp_f / 2.0)
        d_hist = bilinear_sample(prev_d1, ip_f / 2.0, jp_f / 2.0)
        valid = (
            in_front
            & (ip_f >= -0.5) & (ip_f <= h0 - 0.5)
            & (jp_f >= -0.5) & (jp_f <= w0 - 0.5)
        )
        if tparams.max_displacement is not None:
            r = float(tparams.max_displacement)
            ii = 2.0 * torch.arange(h1, dtype=torch.float64,
                                    device=dev)[:, None]
            jj = 2.0 * torch.arange(w1, dtype=torch.float64,
                                    device=dev)[None, :]
            valid = (valid & ((ip_f - ii).abs() <= r)
                     & ((jp_f - jj).abs() <= r))
        valid = valid.to(torch.float64)

    rel_err = (d_hist - expected).abs() / torch.clamp(expected, min=1e-6)
    conf = torch.clamp(1.0 - rel_err / float(tparams.depth_tolerance),
                       0.0, 1.0)
    alpha = float(tparams.history_weight) * valid * conf
    if tparams.neighborhood_clamp:
        lo, hi = neighborhood_bounds(curr_ao1)
        hist = torch.clamp(hist, lo, hi)
    return alpha * hist + (1.0 - alpha) * curr_ao1


def render_frame_l1_temporal_golden(
    depth,
    state,
    camera: CameraParams,
    params,
    tparams: TemporalParams,
    motion=None,
    normals=None,
    device=None,
):
    """Frame + LEVEL-1 temporal resolve oracle: pipeline to the level-1
    combined AO (post pre-min), resolve at half res, then the standard
    final bilateral upsample lifts the resolved field to full res.

    ``state`` is the half-res ``(ao, depth)`` history (or None -- null
    history), at the TRUE half dims ``(ceil(H/2), ceil(W/2))``.  Returns
    ``(full_res_ao, new_state)``.
    """
    dev = _device_of(device, depth, normals, *(state or ()))
    depth = _f64(depth, dev)
    h0, w0 = depth.shape
    hp, wp = padded_shape(h0, w0)
    h1, w1 = -(-h0 // 2), -(-w0 // 2)
    if state is None:
        state = (torch.ones((h1, w1), dtype=torch.float64, device=dev),
                 torch.full((h1, w1), NULL_DEPTH, dtype=torch.float64,
                            device=dev))
    _, dbg = render_frame_golden(depth, camera, params, normals,
                                 return_debug=True)
    d = params.hierarchy_depth
    aos1 = dbg["ao_levels"][1]
    if params.enable_blur and d > 1:
        # the final chain step's pre-min combine, applied before the resolve
        cur1 = torch.minimum(dbg["combined_1"], aos1)
    else:
        cur1 = aos1
    cur1c = cur1[:h1, :w1]
    d1c = dbg["pyramid"][1][:h1, :w1]
    resolved = temporal_resolve_l1_golden(cur1c, d1c, state[0], state[1],
                                          h0, w0, camera, tparams, motion)
    rp = _pad_edge(resolved, (0, hp // 2 - h1), (0, wp // 2 - w1))
    if params.enable_blur:
        # final step WITHOUT lo_ao2: the pre-min was applied above, before
        # the resolve (resolving the pre-min field, not re-min-ing after,
        # keeps the clamp envelope consistent with what gets lifted)
        out = blur_upsample_step(rp, dbg["pyramid"][1], dbg["pyramid"][0],
                                 params, wp)
    else:
        out = rp.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    # sequence contract: history depth is the CURRENT frame's half-res
    # linear depth (pyramid level 1 = pick-one downsample of LinearZ)
    return out[:h0, :w0], (resolved, d1c)


def render_sequence_golden(
    depths,
    camera: CameraParams,
    params,
    tparams: TemporalParams,
    motions=None,
    normals=None,
    device=None,
):
    """Sequence oracle: per-frame golden pipeline + temporal resolve.

    ``depths`` is (T, H, W); ``motions`` is None (static camera), (T, 4, 4)
    with ``motions[t]`` mapping frame t's eye space to frame t-1's, or
    (T, H, W, 2) per-pixel motion vectors (``motions[0]`` is ignored --
    frame 0 has null history).  Returns the (T, H, W) stack of resolved AO
    frames.
    """
    dev = _device_of(device, depths, normals)
    depths = _f64(depths, dev)
    t_n, h, w = depths.shape
    prev_ao = torch.ones((h, w), dtype=torch.float64, device=dev)
    prev_d = torch.full((h, w), NULL_DEPTH, dtype=torch.float64, device=dev)
    out = torch.zeros_like(depths)
    for t in range(t_n):
        nrm = None if normals is None else normals[t]
        ao = render_frame_golden(depths[t], camera, params, nrm)
        linz = linearize_depth(depths[t], camera)
        mot = None if motions is None or t == 0 else motions[t]
        res = temporal_resolve_golden(ao, linz, prev_ao, prev_d, camera,
                                      tparams, mot)
        out[t] = res
        prev_ao, prev_d = res, linz
    return out

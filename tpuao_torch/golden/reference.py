"""Golden float64 reference for the full AO pipeline -- the executable spec,
in PyTorch.

Counterpart of ``tpuao/golden/reference.py``, function for function, under
the same names and conventions: the slow, obviously-correct implementation
of the pipeline that the port is held against (<= 1e-3 max-abs-err is the
[BJ] budget).  It runs wherever its tensors are, so the spec can be
computed on the card beside the port's output at full size.  Like the
NumPy spec it keeps explicit loops over the sample-pair table, the 3x3
noise-filter taps and the 2x2 upsample taps, and fuses nothing.

Arithmetic is float64 throughout.  Tensor inputs stay on their device;
other (NumPy) inputs go to the device of the call's first tensor input,
else to ``device=``, by default the card (``resolve_device``: with no card
that raises).  Outputs are float64 tensors.  Per-pair scalars (the pair
weight, ``t``, ``inv_r``, the radius coefficient, the texel scale and the
upsample constants) are Python floats, computed as the spec computes them.

The golden imports only ``torch``, ``numpy``, ``math`` and
``tpuao_torch.params``, never the code it judges (``ops``, ``models``,
``parallel``, ...) and no kernel library.  The JAX package keeps plain
``Golden*`` mirrors of its parameters because its ``AOParams`` and
``CameraParams`` are flax pytrees; the port's are plain dataclasses, so
the golden takes them directly and reads every tunable through
``float(...)`` (``params.to_golden`` makes every tunable a float).  Like
the NumPy spec the golden is unbatched: one (H, W) frame.

Pipeline stages (names mirror the reference's dispatch DAG, SURVEY.md SS4.2):

  prepare   : linearize hardware depth -> LinearZ; pick-one downsample pyramid
              DS2x..DS16x; the AO math below is defined directly on the
              strided layout, which is bit-identical to computing on the 16
              deinterleaved slices with per-slice clamp-to-edge sampling
              (see pad_parity4).
  render    : per-level hemisphere-occlusion estimate from the 12-entry
              mirrored sample-pair disc (SURVEY.md SS3.2).
  upsample  : depth-aware noise filter + bilateral 2x upsample chain
              1/16 -> 1/8 -> 1/4 -> 1/2 -> full (SURVEY.md SS3.3).
  composite : multiply AO into a color frame / debug view (SURVEY.md SS3.4).

Conventions fixed by this spec (SURVEY.md SS9):

  * arrays are (H, W) row-major, row 0 = top; depth is *normalized linear eye
    depth* z_eye/far in (0, 1] after linearization.
  * downsampling picks the (0,0) corner of each 2x2 (pick-one; preserves true
    depth values for the bilateral passes, SURVEY.md SS3.1).
  * out-of-bounds AO samples clamp to the edge *in slice space* (mod-4 parity
    preserving), matching per-slice texture clamping of the deinterleaved
    reference layout.
  * the pair test returns *visibility* in [0,1] (1 = unoccluded); final
    AO = clip(sum w_i * pairVis_i, 0, 1) ** strength, applied per level at
    render time (Strength plays upstream Accentuation's intensity role,
    SURVEY.md SS3.4).
  * normals (optional) are unit vectors in buffer view space: x = +column,
    y = +row, z = from surface toward camera (so a camera-facing wall is
    (0,0,1) and depth slope per texel is (nx/nz, ny/nz) * texel_world_size).
    The normals path evaluates the pair test against the tangent-plane
    expected depth instead of the center depth (SURVEY.md SS3.2 last bullet,
    [BJ] config 3).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpuao_torch.params import (
    AOParams,
    CameraParams,
    build_pair_table,
    sphere_radius_coef,
    upsample_constants,
    padded_shape,
)

__all__ = [
    "linearize_depth",
    "downsample2x",
    "build_pyramid",
    "pad_parity4",
    "render_ao_level",
    "noise_filter",
    "bilateral_upsample2x",
    "blur_upsample_step",
    "render_frame_golden",
    "composite",
]


# ---------------------------------------------------------------------------
# Devices and float64 inputs
# ---------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """``device``, by default the card (``"cuda"``); raises when that is a
    CUDA device and there is none (the rule of the port's
    ``models.pipeline.resolve_device``, copied so the golden imports
    nothing of the code it judges)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device here; pass "
                           "device=\"cpu\" (or CPU tensors) to run on the "
                           "CPU")
    return device


def _device_of(device, *xs) -> torch.device:
    """The device of a call: that of its first tensor input, else
    ``resolve_device(device)``."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(device)


def _f64(x, device: torch.device) -> torch.Tensor:
    """``x`` as a float64 tensor: a tensor stays on its device, anything
    else goes to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(np.array(x, dtype=np.float64), device=device)


def _pad_edge(x: torch.Tensor, rows: tuple[int, int],
              cols: tuple[int, int]) -> torch.Tensor:
    """``np.pad(x, (rows, cols, (0, 0)...), mode="edge")`` on the two
    leading axes: every padded index reads the nearest edge texel."""
    h, w = x.shape[:2]
    r = torch.arange(-rows[0], h + rows[1], device=x.device).clamp(0, h - 1)
    c = torch.arange(-cols[0], w + cols[1], device=x.device).clamp(0, w - 1)
    return x.index_select(0, r).index_select(1, c)


# ---------------------------------------------------------------------------
# Prepare (SURVEY.md SS3.1)
# ---------------------------------------------------------------------------

def linearize_depth(depth, camera: CameraParams,
                    device=None) -> torch.Tensor:
    """Hardware depth -> normalized linear eye depth z_eye/far in (0,1].

    LinearZ(d) = 1 / (zmagic * d + 1), zmagic = (far - near) / near, for
    reversed-Z (d=1 at near plane).  For forward-Z the buffer is flipped
    first.  ``depth_mode=="linear"`` passes through unchanged.
    """
    depth = _f64(depth, _device_of(device, depth))
    if camera.depth_mode == "linear":
        return depth
    zmagic = (float(camera.far) - float(camera.near)) / float(camera.near)
    d = depth if camera.reversed_z else 1.0 - depth
    return 1.0 / (zmagic * d + 1.0)


def downsample2x(z, device=None) -> torch.Tensor:
    """Pick-one 2x downsample: the (0,0) corner of each 2x2 quad."""
    z = _f64(z, _device_of(device, z))
    return z[0::2, 0::2]


def build_pyramid(linear_z, depth_levels: int,
                  device=None) -> list[torch.Tensor]:
    """[LinearZ, DS2x, DS4x, ...]: index l = 1/2^l resolution."""
    pyr = [_f64(linear_z, _device_of(device, linear_z))]
    for _ in range(depth_levels):
        pyr.append(downsample2x(pyr[-1]))
    return pyr


def pad_parity4(x, pad: int, device=None) -> torch.Tensor:
    """Pad by `pad` (multiple of 4) on all sides, preserving mod-4 parity.

    Equivalent to: deinterleave 4x4 -> clamp-to-edge pad each slice by pad/4
    -> re-interleave.  The apron tiles the first/last 4 rows/columns, so a
    strided (stride-4) sample that walks off the edge reads the edge texel of
    *its own slice*, exactly like per-slice GPU texture clamping.
    """
    assert pad % 4 == 0
    x = _f64(x, _device_of(device, x))
    reps = pad // 4
    top = x[:4, :].repeat(reps, 1)
    bot = x[-4:, :].repeat(reps, 1)
    x = torch.cat([top, x, bot], dim=0)
    left = x[:, :4].repeat(1, reps)
    right = x[:, -4:].repeat(1, reps)
    return torch.cat([left, x, right], dim=1)


# ---------------------------------------------------------------------------
# Render (SURVEY.md SS3.2)
# ---------------------------------------------------------------------------

def _tangent_offset(normals: torch.Tensor, ox: int, oy: int,
                    texel_scale: float, half_chord: float) -> torch.Tensor:
    """Soft-clamped relative tangent-plane depth offset delta_z / z_c at
    texel offset (ox, oy).

    The raw planar prediction x = (nx*ox + ny*oy)/nz * texel_scale is passed
    through x * m^2 / (m^2 + x^2) with m = half the pair chord: moderate
    slopes get the full correction (x << m -> ~x), while grazing slopes fade
    the correction to zero so the estimator degrades to the depth-only pair
    rejection (a hard clamp instead shifts the expectation by up to a whole
    radius and makes co-planar samples read as occluders -- a black horizon
    band, found via the demo render)."""
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    nz = torch.clamp(nz, min=0.05)
    x = (nx * ox + ny * oy) / nz * texel_scale
    m2 = half_chord * half_chord
    return x * m2 / (m2 + x * x)


def render_ao_level(
    ds,
    level: int,
    full_width: int,
    camera: CameraParams,
    params: AOParams,
    normals_ds=None,
    device=None,
) -> torch.Tensor:
    """AO estimate at one hierarchy level.

    ``ds`` is the 1/2^l linear-depth buffer; output has the same shape.
    Each disc offset (in slice texels) maps to a stride-4 offset in ``ds``
    (SURVEY.md SS3.1-3.2: deinterleaved slices sample +-1..4 slice texels
    == +-4..16 downsampled texels).

    Pair test (this spec's definition of the SS3.2 "to re-derive" unknown):

      r_i(z_c)      = radius_coef * T[i] * z_c          (world half-chord)
      disocc(z_s)   = 1 + (z_s - z_ref) / r_i(z_c)      in "visibility" units:
                      0 at the sphere's front face, 1 at the center plane,
                      >1 behind.  z_ref = z_c, or the tangent-plane expected
                      depth when normals are enabled.
      p_k           = clip(rejection_falloff * d_k, 0, 1)
      pairVis       = 0.5 * (clip(max(d_1, p_2), 0, 1)
                             + clip(max(d_2, p_1), 0, 1))

    A sample far in front of the center (d << 0, e.g. a foreground object
    over distant background) is *rejected* -- counted visible -- whenever its
    mirror partner lies at or behind the center surface (the pseudo-
    disocclusion coupling), which is the scalable-AO haze-rejection trick;
    rejection_falloff controls how quickly partial rejection engages.

      AO = clip(sum_i w_i * pairVis_i, 0, 1) ** strength
    """
    dev = _device_of(device, ds, normals_ds)
    ds = _f64(ds, dev)
    offsets, weights = build_pair_table(params.exhaustive)
    tan_h = float(camera.tan_half_fov_h)
    radius_coef = sphere_radius_coef(
        level, full_width, tan_h, float(params.screenspace_diameter)
    )
    texel_scale = 2.0 * tan_h / (full_width // (1 << level))

    halo = 16
    zp = pad_parity4(ds, halo)
    # Only the center normal is ever read (window offset (0, 0) == the
    # unpadded field), so no normals halo is built.
    n_c = (_f64(normals_ds, dev)
           if normals_ds is not None and params.use_normals else None)

    h, w = ds.shape
    z_c = ds
    falloff = float(params.rejection_falloff)
    vis = torch.zeros_like(z_c)

    def window(arr, dy, dx):
        return arr[halo + dy : halo + dy + h, halo + dx : halo + dx + w]

    for (sx, sy), w_pair in zip(offsets.tolist(), weights.tolist()):
        dx, dy = 4 * int(sx), 4 * int(sy)
        t = math.sqrt(max(1.0 - (sx * sx + sy * sy) / 25.0, 1e-12))
        inv_r = 1.0 / (radius_coef * t)  # per unit z_c
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
        pair_vis = 0.5 * (
            torch.clamp(torch.maximum(d1, p2), 0.0, 1.0)
            + torch.clamp(torch.maximum(d2, p1), 0.0, 1.0)
        )
        vis = vis + w_pair * pair_vis

    return torch.clamp(vis, 0.0, 1.0) ** float(params.strength)


# ---------------------------------------------------------------------------
# Blur + upsample (SURVEY.md SS3.3)
# ---------------------------------------------------------------------------

def noise_filter(lo_ao, lo_d, noise_filter_strength: float,
                 device=None) -> torch.Tensor:
    """Depth-aware 3x3 smoothing of low-res AO.

    Spatial kernel [1,2,1] x [1,2,1]; each neighbor's weight is additionally
    scaled by 1 / (1 + NFS * (d_n - d_c)^2).  Large NoiseFilterTolerance
    (-> 0) gives NFS ~ 1 (smooth across depth steps); small tolerance (-> -8)
    gives huge NFS (neighbors suppressed unless depths match).  Idempotent on
    constant AO (weights normalize to 1).
    """
    dev = _device_of(device, lo_ao, lo_d)
    lo_ao = _f64(lo_ao, dev)
    lo_d = _f64(lo_d, dev)
    nfs = float(noise_filter_strength)
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


def bilateral_upsample2x(lo_ao, lo_d, hi_d, k_blur: float, k_up: float,
                         device=None) -> torch.Tensor:
    """Depth-aware 2x upsample, corner-aligned with pick-one downsampling.

    Low-res texel l sits exactly at hi-res texel 2l, so hi texel r has
    lo coordinate r/2: even rows/cols interpolate with fraction 0, odd with
    fraction 1/2.  Each of the 4 enclosing lo taps gets weight

        w = bilinear(r, c) / ((lo_d - hi_d)^2 / k_blur + k_up)

    normalized over the 4 taps (SURVEY.md SS3.3: bilinear x depth-similarity
    with a k_upsample_tolerance floor so flat regions never divide by ~0).
    The spec's ``np.ix_`` gathers are ``index_select`` on rows, then on
    columns.
    """
    dev = _device_of(device, lo_ao, lo_d, hi_d)
    lo_ao = _f64(lo_ao, dev)
    lo_d = _f64(lo_d, dev)
    hi_d = _f64(hi_d, dev)
    k_blur, k_up = float(k_blur), float(k_up)
    hh, hw = hi_d.shape
    lh, lw = lo_d.shape
    assert lh * 2 == hh and lw * 2 == hw, (lo_d.shape, hi_d.shape)

    ap = _pad_edge(lo_ao, (0, 1), (0, 1))
    dp = _pad_edge(lo_d, (0, 1), (0, 1))

    r = torch.arange(hh, device=dev)
    c = torch.arange(hw, device=dev)
    r0 = r // 2
    c0 = c // 2
    fr = (r % 2).to(torch.float64) * 0.5
    fc = (c % 2).to(torch.float64) * 0.5

    acc = torch.zeros((hh, hw), dtype=torch.float64, device=dev)
    wacc = torch.zeros((hh, hw), dtype=torch.float64, device=dev)
    for dr in (0, 1):
        for dc in (0, 1):
            a = ap.index_select(0, r0 + dr).index_select(1, c0 + dc)
            d = dp.index_select(0, r0 + dr).index_select(1, c0 + dc)
            bw = (
                (1.0 - fr if dr == 0 else fr)[:, None]
                * (1.0 - fc if dc == 0 else fc)[None, :]
            )
            dd = d - hi_d
            wt = bw / (dd * dd / k_blur + k_up)
            acc += wt * a
            wacc += wt
    return acc / torch.clamp(wacc, min=1e-30)


def blur_upsample_step(
    lo_ao,
    lo_d,
    hi_d,
    params: AOParams,
    full_width: int,
    lo_ao2=None,
    hi_ao_blend=None,
    device=None,
) -> torch.Tensor:
    """One chain step: [pre-min] -> noise filter -> bilateral 2x [-> blend].

    The 4 reference kernel variants (SURVEY.md SS3.0 'Blur+upsample', upstream
    BlurUpsample{,PreMin}{,BlendOut}CS) are expressed by the two optional
    arguments: ``lo_ao2`` enables the low-res pre-min combine and
    ``hi_ao_blend`` enables the high-res min blend of the output.

    Composition rule (spec): the low-res field is first edge-extended by one
    texel bottom/right, the noise filter runs on the extended domain, and the
    upsample taps are plain slices of the extended filtered field -- i.e.
    edge clamping happens on the *input*, matching a GPU sampler reading a
    filtered texture with clamp addressing (and the fused TPU kernel).
    """
    dev = _device_of(device, lo_ao, lo_d, hi_d, lo_ao2, hi_ao_blend)
    lo_ao = _f64(lo_ao, dev)
    lo_d = _f64(lo_d, dev)
    hi_d = _f64(hi_d, dev)
    if lo_ao2 is not None:
        lo_ao = torch.minimum(lo_ao, _f64(lo_ao2, dev))
    _, k_blur, k_up, nfs = (float(v) for v in upsample_constants(
        params, full_width, lo_d.shape[1]
    ))
    lh, lw = lo_d.shape
    ap = _pad_edge(lo_ao, (0, 1), (0, 1))
    dp = _pad_edge(lo_d, (0, 1), (0, 1))
    filtered = noise_filter(ap, dp, nfs)  # (lh+1, lw+1) extended field

    hh, hw = hi_d.shape
    r = torch.arange(hh, device=dev)
    c = torch.arange(hw, device=dev)
    r0 = r // 2
    c0 = c // 2
    fr = (r % 2).to(torch.float64) * 0.5
    fc = (c % 2).to(torch.float64) * 0.5
    acc = torch.zeros((hh, hw), dtype=torch.float64, device=dev)
    wacc = torch.zeros((hh, hw), dtype=torch.float64, device=dev)
    for dr in (0, 1):
        for dc in (0, 1):
            a = filtered.index_select(0, r0 + dr).index_select(1, c0 + dc)
            d = dp.index_select(0, r0 + dr).index_select(1, c0 + dc)
            bw = (
                (1.0 - fr if dr == 0 else fr)[:, None]
                * (1.0 - fc if dc == 0 else fc)[None, :]
            )
            dd = d - hi_d
            wt = bw / (dd * dd / k_blur + k_up)
            acc += wt * a
            wacc += wt
    up = acc / torch.clamp(wacc, min=1e-30)
    if hi_ao_blend is not None:
        up = torch.minimum(up, _f64(hi_ao_blend, dev))
    return up


# ---------------------------------------------------------------------------
# Full frame (SURVEY.md SS4.2 dispatch DAG) + composite (SS3.4)
# ---------------------------------------------------------------------------

def render_frame_golden(
    depth,
    camera: CameraParams,
    params: AOParams,
    normals=None,
    return_debug: bool = False,
    full_width: int | None = None,
    device=None,
):
    """Full golden pipeline: depth [+ normals] -> full-res AO in [0,1].

    Input of any (H, W) is edge-padded to a multiple of 64 and the output is
    cropped back (SURVEY.md SS8 hard-part 4 padding rule).  ``normals`` are
    raw (H, W, 3) unit normals, pyramided by pick-one slicing like depth.

    ``full_width`` overrides the buffer width used for the camera-derived
    constants (sphere radius, texel scale, upsample step tolerances), which
    the reference derives from the FRAME width, not the evaluated window
    (SURVEY.md SS3.2 ThicknessMultiplier ~ 1/BufferWidth).  Pass the original
    frame width when evaluating the golden on a 64-aligned interior crop of a
    larger frame: with a sufficient halo margin the crop's interior is then
    equal to the full-frame result.

    Chain (hierarchy_depth=4, SURVEY.md SS3.3):
      AO@1/16                                  -> up -> Combined@1/8
      min(Combined@1/8, AO@1/8)                -> up -> Combined@1/4
      min(Combined@1/4, AO@1/4)                -> up -> Combined@1/2
      min(Combined@1/2, AO@1/2)                -> up -> AO@full
    With enable_blur=False, returns the nearest-upsampled finest-level AO.
    """
    dev = _device_of(device, depth, normals)
    depth = _f64(depth, dev)
    h0, w0 = depth.shape
    hp, wp = padded_shape(h0, w0)
    depth = _pad_edge(depth, (0, hp - h0), (0, wp - w0))
    if normals is not None:
        normals = _f64(normals, dev)
        normals = _pad_edge(normals, (0, hp - h0), (0, wp - w0))

    d = params.hierarchy_depth
    fw = wp if full_width is None else int(full_width)
    linz = linearize_depth(depth, camera)
    pyr = build_pyramid(linz, d)
    npyr = build_pyramid(normals, d) if (
        normals is not None and params.use_normals) else [None] * (d + 1)

    aos = {
        l: render_ao_level(pyr[l], l, fw, camera, params, npyr[l])
        for l in range(1, d + 1)
    }
    debug = {"linear_z": linz, "pyramid": pyr, "ao_levels": dict(aos)}

    if not params.enable_blur:
        ao = (aos[1].repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
              if d >= 1 else linz)
        ao = ao[:h0, :w0]
        return (ao, debug) if return_debug else ao

    # Chain uses the PreMin variant throughout (wiring it with BlendOut
    # instead is algebraically identical: the min migrates across the step
    # boundary).
    combined = aos[d]
    for l in range(d, 0, -1):
        hi_d = pyr[l - 1]
        # upsample constants depend only on step_size = full_W / lo_W = 2^l,
        # which is the same for a 64-aligned crop as for its frame -- so the
        # crop's own padded width is always correct here (fw is NOT needed)
        combined = blur_upsample_step(
            combined, pyr[l], hi_d, params, wp,
            lo_ao2=aos[l] if l != d else None,
        )
        debug[f"combined_{l-1}"] = combined
    ao = combined[:h0, :w0]
    return (ao, debug) if return_debug else ao


def composite(color, ao, debug: bool = False, device=None) -> torch.Tensor:
    """Multiply AO into a color frame (SURVEY.md SS3.4).  ``debug=True``
    returns the AO broadcast to the color shape instead (the debug blit)."""
    dev = _device_of(device, color, ao)
    color = _f64(color, dev)
    ao = _f64(ao, dev)
    ao_b = ao[..., None] if color.ndim == 3 else ao
    if debug:
        return ao_b.expand(color.shape).clone()
    return color * ao_b

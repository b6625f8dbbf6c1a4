"""The plain reference of temporal AO accumulation: a frozen copy of the
float64 spec's camera-motion path (``tpuao_torch/golden/temporal.py``),
function for function under the spec's names, written on
``reference.golden``'s functions and ``reference.params``' constants.  It
imports nothing of the program.  Arithmetic is in ``dtype``: float64 for
the reference, a lower precision for the control (``control.py``).
Motion-vector buffers are left out: the camera-motion form is the path an
engine driven by view matrices takes.

Conventions (the spec's): depth fields are linear z_eye / far; eye space
looks down +z with y up; ``motion`` is the (4, 4) current->previous eye
transform, ``None`` a static camera; pixel (i, j) sits at (i + 0.5,
j + 0.5) and history is sampled bilinearly at the reprojected coordinate.
A sequence starts from the null history (ao 1, depth ``NULL_DEPTH``),
whose confidence is 0, so frame 0 resolves to its own one-frame AO.

The allowance (``Sequence``)
----------------------------

The resolve has one kind of discontinuity: its validity tests, the frame
rectangle ``-0.5 <= i' <= H - 0.5`` (and in j), the window ``|i' - i| <=
R`` (and in j) and ``z' > 0``.  Where the program's float32 coordinate
lies on the other side of a boundary than the float64 one, its texel keeps
or drops history where the reference does not, and the gap is carried
through the history, up to ``history_weight`` a frame.  Everything else
(the frame pipeline, the confidence, the clamp, the bilinear weights) is
continuous and is judged at the plain limit.

``band_t`` is the set of texels whose margin, the least distance of any
validity test from its boundary (``|i' + 0.5|``, ``|i' - (H - 0.5)|``,
``||i' - i| - R|``, their j forms, and the normalised ``z'``), is at most
``EPS``, in full-resolution texels at either level.  The allowance is the
recursion, with ``a_t = history_weight * conf_t``, ``alpha_t`` the
reference's own alpha and ``B_t`` the bilinear sample at the reference's
history coordinate::

    delta_t = a_t (|clamp(hist_t) - curr_t| + B_t(delta_{t-1}))  on band_t
    delta_t = alpha_t B_t(delta_{t-1})                             elsewhere
    delta_0 = 0  (the null history has zero confidence)

Why it bounds the program's deviation e_t (less rounding): the history
the program samples is the reference's plus e_{t-1}, and the bilinear
weights are positive and sum to 1, so its sample lies within
``B_t(|e_{t-1}|)`` of the reference's; the clamp to the 3x3 envelope is
1-Lipschitz; the confidence and the depth do not depend on the AO.  Off
the band both sides keep history alike, and ``out = alpha hist' + (1 -
alpha) curr`` moves by at most ``alpha_t B_t(delta_{t-1})``.  On the band
the program may keep what the reference drops or the reverse, which moves
the output by at most ``a_t |clamp(hist') - curr|``, itself within ``a_t
(|clamp(hist) - curr| + B_t(delta_{t-1}))``.  By induction |e_t| <=
delta_t.  At level 1 the lift (``blur_upsample_step`` without pre-min) is
a positive normalised sum over the level-1 texels that a full-res texel
reads, rows ``r // 2 - 1 .. r // 2 + 2`` and as many columns, so its
allowance is the largest delta over that 4 x 4 superset.  Where no band
was crossed the allowance is exactly 0.

``EPS`` = max(1e-3 texel, 4 x the largest gap between the program's
float32 coordinates and the float64 ones measured on the card): 4 x
4.1755e-4, measured on an H100 at 1080p over 32 dolly frames of 0.05
(seeds 11-13, levels 0 and 1, ``aobench/temporal_check.py``).

Not covered, as continuous: where the previous depth jumps between the
bilinear taps, the confidence moves steeply with the coordinate, and its
float32 rounding moves the output by ``delta_alpha |clamp(hist) -
curr|``; that and the rounding of each frame are carried through the
history too.  They read up to ~1.6e-4 at 1080p, within the plain limit.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from aobench.reference import golden
from aobench.reference.golden import (_pad_edge, blur_upsample_step,
                                      build_pyramid, linearize_depth,
                                      render_ao_level)
from aobench.reference.params import (AO, Camera, Temporal, from_config,
                                      padded_shape, temporal_from_config)

F64 = torch.float64
NULL_DEPTH = 1.0e6
EPS = 1.68e-3


def _motion4x4(motion) -> list[list[float]]:
    """The (4, 4) ``motion`` as rows of Python floats; raises on any other
    shape."""
    m = torch.as_tensor(motion, dtype=F64).cpu()
    if tuple(m.shape) != (4, 4):
        raise ValueError(f"motion must be 4x4, got {tuple(m.shape)}")
    return m.tolist()


def _project(x, y, z, m, tanh: float, tan_v: float, h: int, w: int,
             far: float):
    """``(ip, jp, z' / far, z' > 0)`` of eye points moved by ``m`` into
    the previous frame of an (h, w) image."""
    xp = m[0][0] * x + m[0][1] * y + m[0][2] * z + m[0][3]
    yp = m[1][0] * x + m[1][1] * y + m[1][2] * z + m[1][3]
    zp = m[2][0] * x + m[2][1] * y + m[2][2] * z + m[2][3]
    in_front = zp > 0.0
    zs = torch.where(in_front, zp, torch.ones_like(zp))
    up = xp / (zs * tanh)
    vp = yp / (zs * tan_v)
    jp = (up + 1.0) * 0.5 * w - 0.5
    ip = (1.0 - vp) * 0.5 * h - 0.5
    return ip, jp, zp / far, in_front


def reproject_coords(depth, camera: Camera, motion):
    """Continuous previous-frame coordinates of every texel of the linear
    depth (H, W): ``(ip, jp, z_prev_norm, in_front)``."""
    h, w = depth.shape
    tanh = float(camera.tan_half_fov_h)
    tan_v = tanh * h / w
    ar = functools.partial(torch.arange, dtype=depth.dtype,
                           device=depth.device)
    u = 2.0 * (ar(w) + 0.5) / w - 1.0
    v = 1.0 - 2.0 * (ar(h) + 0.5) / h
    z = depth * float(camera.far)
    x = (u[None, :] * tanh).expand(h, w) * z
    y = (v[:, None] * tan_v).expand(h, w) * z
    return _project(x, y, z, _motion4x4(motion), tanh, tan_v, h, w,
                    float(camera.far))


def reproject_coords_l1(depth_l1, h0: int, w0: int, camera: Camera, motion):
    """Reprojection of the pick-one level-1 field of an (h0, w0) frame:
    level-1 texel (i, j) holds full-res texel (2i, 2j) and takes its ray.
    Returns ``(ip_full, jp_full, z_prev_norm, in_front)`` in full-res
    index units."""
    h1, w1 = depth_l1.shape
    tanh = float(camera.tan_half_fov_h)
    tan_v = tanh * h0 / w0
    ar = functools.partial(torch.arange, dtype=depth_l1.dtype,
                           device=depth_l1.device)
    u = 2.0 * (2.0 * ar(w1) + 0.5) / w0 - 1.0
    v = 1.0 - 2.0 * (2.0 * ar(h1) + 0.5) / h0
    z = depth_l1 * float(camera.far)
    x = (u[None, :] * tanh).expand(h1, w1) * z
    y = (v[:, None] * tan_v).expand(h1, w1) * z
    return _project(x, y, z, _motion4x4(motion), tanh, tan_v, h0, w0,
                    float(camera.far))


def bilinear_sample(field, ip, jp):
    """Bilinear sample of (H, W) ``field`` at continuous (ip, jp), clipped
    to the frame first (validity is the caller's); int64 taps."""
    h, w = field.shape
    ip = torch.clamp(ip, 0.0, h - 1.0)
    jp = torch.clamp(jp, 0.0, w - 1.0)
    i0 = (torch.clamp(torch.floor(ip).to(torch.int64), max=h - 2) if h > 1
          else torch.zeros_like(ip, dtype=torch.int64))
    j0 = (torch.clamp(torch.floor(jp).to(torch.int64), max=w - 2) if w > 1
          else torch.zeros_like(jp, dtype=torch.int64))
    fi = ip - i0
    fj = jp - j0
    i1 = torch.clamp(i0 + 1, max=h - 1)
    j1 = torch.clamp(j0 + 1, max=w - 1)
    top = field[i0, j0] * (1.0 - fj) + field[i0, j1] * fj
    bot = field[i1, j0] * (1.0 - fj) + field[i1, j1] * fj
    return top * (1.0 - fi) + bot * fi


def neighborhood_bounds(ao):
    """(min, max) over the edge-clamped 3x3 neighbourhood of each
    texel."""
    p = _pad_edge(ao, (1, 1), (1, 1))
    h, w = ao.shape
    lo = torch.full_like(ao, float("inf"))
    hi = torch.full_like(ao, float("-inf"))
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            win = p[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
            lo = torch.minimum(lo, win)
            hi = torch.maximum(hi, win)
    return lo, hi


def _margin(ip, jp, z_prev, h: int, w: int, step: float, r):
    """The least distance of any validity test from its boundary, in
    full-res texels (``z'`` normalised); ``step`` is the full-res index of
    a texel's unit (1, or 2 at level 1)."""
    parts = [(ip + 0.5).abs(), (ip - (h - 0.5)).abs(), (jp + 0.5).abs(),
             (jp - (w - 0.5)).abs(), z_prev.abs()]
    if r is not None:
        hh, ww = ip.shape
        ii = step * torch.arange(hh, dtype=ip.dtype, device=ip.device)
        jj = step * torch.arange(ww, dtype=ip.dtype, device=ip.device)
        parts += [((ip - ii[:, None]).abs() - r).abs(),
                  ((jp - jj[None, :]).abs() - r).abs()]
    return functools.reduce(torch.minimum, parts)


def _blend(curr_ao, hist, d_hist, expected, valid, tparams: Temporal,
           terms):
    """The spec's blend; fills ``terms`` (where given) with ``conf``,
    ``alpha`` and the clamped ``hist``."""
    rel_err = (d_hist - expected).abs() / torch.clamp(expected, min=1e-6)
    conf = torch.clamp(1.0 - rel_err / float(tparams.depth_tolerance),
                       0.0, 1.0)
    alpha = float(tparams.history_weight) * valid * conf
    if tparams.neighborhood_clamp:
        lo, hi = neighborhood_bounds(curr_ao)
        hist = torch.clamp(hist, lo, hi)
    if terms is not None:
        terms.update(conf=conf, alpha=alpha, hist=hist, curr=curr_ao)
    return alpha * hist + (1.0 - alpha) * curr_ao


def temporal_resolve_golden(curr_ao, curr_depth, prev_ao, prev_depth,
                            camera: Camera, tparams: Temporal, motion=None,
                            terms: dict | None = None):
    """One resolve step at full resolution; all fields (H, W), depths
    linear.  The next history is ``(resolved, curr_depth)``.  ``terms``,
    where given, receives what the allowance reads: ``coords`` (the
    history's sample coordinates, None for a static camera), ``margin``
    and the blend's ``conf``, ``alpha``, ``hist``, ``curr``."""
    h, w = curr_ao.shape
    if motion is None:
        hist, d_hist, expected = prev_ao, prev_depth, curr_depth
        valid = torch.ones_like(curr_ao)
        coords, margin = None, torch.full_like(curr_ao, float("inf"))
    else:
        ip, jp, z_prev, in_front = reproject_coords(curr_depth, camera,
                                                    motion)
        expected = z_prev
        hist = bilinear_sample(prev_ao, ip, jp)
        d_hist = bilinear_sample(prev_depth, ip, jp)
        valid = (in_front & (ip >= -0.5) & (ip <= h - 0.5)
                 & (jp >= -0.5) & (jp <= w - 0.5))
        r = tparams.max_displacement
        if r is not None:
            ii = torch.arange(h, dtype=ip.dtype, device=ip.device)[:, None]
            jj = torch.arange(w, dtype=ip.dtype, device=ip.device)[None, :]
            valid = valid & ((ip - ii).abs() <= r) & ((jp - jj).abs() <= r)
        valid = valid.to(curr_ao.dtype)
        coords = (ip, jp)
        margin = _margin(ip, jp, z_prev, h, w, 1.0, r)
    if terms is not None:
        terms.update(coords=coords, margin=margin)
    return _blend(curr_ao, hist, d_hist, expected, valid, tparams, terms)


def temporal_resolve_l1_golden(curr_ao1, curr_d1, prev_ao1, prev_d1, h0: int,
                               w0: int, camera: Camera, tparams: Temporal,
                               motion=None, terms: dict | None = None):
    """The resolve at level 1: the fields are the (ceil(h0/2),
    ceil(w0/2)) level-1 planes; reprojection takes each texel's full-res
    ray, history is sampled on the half grid at ``(ip_full / 2, jp_full /
    2)``, and the rectangle and ``max_displacement`` keep their full-res
    meaning (``|ip_full - 2i| <= R``).  ``terms`` as in
    ``temporal_resolve_golden``, with ``coords`` on the half grid."""
    if motion is None:
        hist, d_hist, expected = prev_ao1, prev_d1, curr_d1
        valid = torch.ones_like(curr_ao1)
        coords, margin = None, torch.full_like(curr_ao1, float("inf"))
    else:
        ip_f, jp_f, z_prev, in_front = reproject_coords_l1(
            curr_d1, h0, w0, camera, motion)
        expected = z_prev
        coords = (ip_f / 2.0, jp_f / 2.0)
        hist = bilinear_sample(prev_ao1, *coords)
        d_hist = bilinear_sample(prev_d1, *coords)
        valid = (in_front & (ip_f >= -0.5) & (ip_f <= h0 - 0.5)
                 & (jp_f >= -0.5) & (jp_f <= w0 - 0.5))
        r = tparams.max_displacement
        if r is not None:
            h1, w1 = curr_ao1.shape
            ar = functools.partial(torch.arange, dtype=ip_f.dtype,
                                   device=ip_f.device)
            valid = (valid & ((ip_f - 2.0 * ar(h1)[:, None]).abs() <= r)
                     & ((jp_f - 2.0 * ar(w1)[None, :]).abs() <= r))
        valid = valid.to(curr_ao1.dtype)
        margin = _margin(ip_f, jp_f, z_prev, h0, w0, 2.0, r)
    if terms is not None:
        terms.update(coords=coords, margin=margin)
    return _blend(curr_ao1, hist, d_hist, expected, valid, tparams, terms)


def _level1(depth, camera: Camera, params: AO, normals, dtype):
    """The frame pipeline up to the level-1 field that the level-1
    resolve takes, ``min(combined_1, AO_1)`` (``AO_1`` alone without blur
    or at depth 1), with the padded pyramid: ``(cur1 (hp/2, wp/2),
    pyramid)``."""
    depth = depth.to(dtype)
    h0, w0 = depth.shape
    hp, wp = padded_shape(h0, w0)
    depth = _pad_edge(depth, (0, hp - h0), (0, wp - w0))
    if normals is not None:
        normals = _pad_edge(normals.to(dtype), (0, hp - h0), (0, wp - w0))
    d = params.hierarchy_depth
    pyr = build_pyramid(linearize_depth(depth, camera), d)
    npyr = build_pyramid(normals, d) if (
        normals is not None and params.use_normals) else [None] * (d + 1)
    aos = {l: render_ao_level(pyr[l], l, wp, camera, params, npyr[l])
           for l in range(1, d + 1)}
    if not params.enable_blur or d == 1:
        return aos[1], pyr
    combined = aos[d]
    for l in range(d, 1, -1):
        combined = blur_upsample_step(combined, pyr[l], pyr[l - 1], params,
                                      wp, lo_ao2=aos[l] if l != d else None)
    return torch.minimum(combined, aos[1]), pyr


def render_frame_l1_temporal_golden(depth, state, camera: Camera,
                                    params: AO, tparams: Temporal,
                                    motion=None, normals=None,
                                    dtype: torch.dtype = F64,
                                    terms: dict | None = None):
    """One frame with the level-1 resolve: the pipeline to the level-1
    field, the resolve at the true half dims, then the last upsample
    (without pre-min) lifts it; nearest 2x without blur.  ``state`` is the
    level-1 ``(ao, depth)`` history, or None for the null history.
    Returns ``(full-res AO, new state)``."""
    h0, w0 = depth.shape
    hp, wp = padded_shape(h0, w0)
    h1, w1 = -(-h0 // 2), -(-w0 // 2)
    cur1, pyr = _level1(depth, camera, params, normals, dtype)
    d1c = pyr[1][:h1, :w1]
    if state is None:
        state = (torch.ones_like(d1c), torch.full_like(d1c, NULL_DEPTH))
    resolved = temporal_resolve_l1_golden(cur1[:h1, :w1], d1c, state[0],
                                          state[1], h0, w0, camera, tparams,
                                          motion, terms)
    rp = _pad_edge(resolved, (0, hp // 2 - h1), (0, wp // 2 - w1))
    if params.enable_blur:
        out = blur_upsample_step(rp, pyr[1], pyr[0], params, wp)
    else:
        out = rp.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    return out[:h0, :w0], (resolved, d1c)


def render_sequence_golden(depths, camera: Camera, params: AO,
                           tparams: Temporal, motions=None, normals=None,
                           dtype: torch.dtype = F64):
    """The full-resolution sequence: each frame's one-frame reference,
    resolved against the history.  ``motions`` is None (static) or (T, 4,
    4) with ``motions[t]`` taking frame t's eye space to frame t-1's
    (``motions[0]`` is ignored).  Returns the (T, H, W) resolved frames."""
    t_n, h, w = depths.shape
    dev = depths.device
    prev_ao = torch.ones((h, w), dtype=dtype, device=dev)
    prev_d = torch.full((h, w), NULL_DEPTH, dtype=dtype, device=dev)
    out = torch.zeros((t_n, h, w), dtype=dtype, device=dev)
    for t in range(t_n):
        nrm = None if normals is None else normals[t]
        ao = golden.render_frame(depths[t], camera, params, nrm, dtype=dtype)
        linz = linearize_depth(depths[t].to(dtype), camera)
        mot = None if motions is None or t == 0 else motions[t]
        res = temporal_resolve_golden(ao, linz, prev_ao, prev_d, camera,
                                      tparams, mot)
        out[t] = res
        prev_ao, prev_d = res, linz
    return out


def _lift_slack(delta1, h0: int, w0: int, enable_blur: bool):
    """The full-res allowance of a level-1 one: the largest delta over the
    level-1 texels the lift reads for each full-res texel (module
    docstring), edge-padded as the resolved field is."""
    hp, wp = padded_shape(h0, w0)
    h1, w1 = delta1.shape
    d = _pad_edge(delta1, (0, hp // 2 - h1), (0, wp // 2 - w1))
    if enable_blur:
        e = _pad_edge(d, (1, 2), (1, 2))
        hh, ww = d.shape
        d = functools.reduce(torch.maximum, [
            e[dy: dy + hh, dx: dx + ww] for dy in range(4)
            for dx in range(4)])
    return d.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)[
        :h0, :w0]


class Sequence:
    """The reference of one sequence from a reset, frame by frame, with
    its allowance: ``at(t) -> (ref_t, slack_t)``, each (H, W) in ``dtype``
    on ``device``.  It keeps its state, so frames asked for in order cost
    one pass up to the last; an earlier frame starts again from the reset.

    ``depth`` (F, H, W) and ``normals`` (F, H, W, 3) or None are the
    frames; ``motions[t]`` the (4, 4) motion of frame t (t >= 1), or None
    for a static camera.  After each step ``injected`` holds the
    allowance that step's band added, and ``carry(field)`` takes a field
    one step the way the allowance was carried, so a caller can follow
    one frame's injection alone."""

    def __init__(self, depth, normals, camera: Camera, params: AO,
                 tparams: Temporal, motions, device,
                 dtype: torch.dtype = F64, eps: float = EPS):
        if tparams.resolve_level not in (0, 1):
            raise ValueError(f"resolve_level must be 0 or 1, got "
                             f"{tparams.resolve_level!r}")
        self.depth, self.normals, self.motions = depth, normals, motions
        self.camera, self.params, self.tparams = camera, params, tparams
        self.device, self.dtype, self.eps = device, dtype, eps
        self.t, self.state, self.delta, self.out = -1, None, None, None

    def at(self, t: int):
        if t < self.t:
            self.t, self.state, self.delta = -1, None, None
        while self.t < t:
            self._step()
        return self.out

    def _step(self):
        t = self.t + 1
        d = self.depth[t].to(device=self.device, dtype=self.dtype)
        n = (None if self.normals is None else
             self.normals[t].to(device=self.device, dtype=self.dtype))
        motion = None if t == 0 or self.motions is None else self.motions[t]
        cam, params, tp = self.camera, self.params, self.tparams
        terms = {}
        if tp.resolve_level == 0:
            ao = golden.render_frame(d, cam, params, n, dtype=self.dtype)
            linz = linearize_depth(d, cam)
            prev = self.state or (torch.ones_like(linz),
                                  torch.full_like(linz, NULL_DEPTH))
            out = temporal_resolve_golden(ao, linz, *prev, cam, tp, motion,
                                          terms)
            self.state = (out, linz)
        else:
            out, self.state = render_frame_l1_temporal_golden(
                d, self.state, cam, params, tp, motion, n, self.dtype, terms)
        band = terms["margin"] <= self.eps
        a = float(tp.history_weight) * terms["conf"]
        self._coords = terms["coords"]
        self._weight = torch.where(band, a, terms["alpha"])
        self.injected = torch.where(
            band, a * (terms["hist"] - terms["curr"]).abs(),
            torch.zeros_like(a))
        prev = (torch.zeros_like(a) if self.delta is None else self.delta)
        self.delta = self.injected + self.carry(prev)
        slack = (self.delta if tp.resolve_level == 0 else _lift_slack(
            self.delta, *d.shape, params.enable_blur))
        self.t, self.out = t, (out, slack)

    def carry(self, field):
        """``field`` (at the resolve's resolution) carried one step by the
        newest frame: ``a_t B_t(field)`` on its band, ``alpha_t
        B_t(field)`` elsewhere."""
        moved = field if self._coords is None else bilinear_sample(
            field, *self._coords)
        return self._weight * moved


@dataclasses.dataclass
class Pool:
    """The inputs of a temporal sequence, as a traffic hands them to the
    check: ``depth`` (F, H, W) and ``normals`` (F, H, W, 3) or None, the
    frames of one dolly in order; ``sequences`` keeps the references
    begun on them, one a (device, dtype)."""

    depth: torch.Tensor
    normals: torch.Tensor | None = None
    sequences: dict = dataclasses.field(default_factory=dict)


def reference(key: int, pool: Pool, config: dict, workload: dict, device,
              dtype: torch.dtype = F64):
    """A traffic kind's ``reference`` for a dolly sequence from a reset:
    ``(ref, slack)`` of frame ``key`` of ``pool``, the configuration's
    ``ao``, ``camera`` and ``temporal`` groups, and the workload's
    ``dolly_step`` (``scenes.dolly_motion``) between frames."""
    from aobench.scenes import dolly_motion

    k = (str(device), dtype)
    if k not in pool.sequences:
        params, camera = from_config(config)
        step = dolly_motion(workload["dolly_step"])
        pool.sequences[k] = Sequence(
            pool.depth, pool.normals, camera, params,
            temporal_from_config(config), [step] * pool.depth.shape[0],
            device, dtype)
    return pool.sequences[k].at(key)

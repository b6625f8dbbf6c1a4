"""The per-frame pipeline of the PyTorch port.

Counterpart of the frame path of ``tpuao/models/pipeline.py``: depth ->
pad to 64 -> linearise -> pick-one pyramid -> per-level AO -> blur/upsample
chain -> crop [-> composite -> quantise].  PyTorch runs eagerly, so there is
no jit and no program cache: every call runs the ops on the device its
tensors are on.

``impl`` takes the JAX package's four values, so calls carry over:

* ``"jnp"``: the plain PyTorch versions of every op;
* ``"pallas"``: the render kernel at every level and the upsample kernel at
  every chain step;
* ``"fused"`` and ``"auto"``: the render kernel at the coarsest level only,
  the upsample kernel for the first step d -> d-1 (no pre-min), and the
  fused render+upsample kernel for every step after it -- 1 + 1 + (d-1)
  launches per call at hierarchy depth d, whatever the batch size (the
  batch is a grid dimension of each kernel).  With ``debug_outputs``,
  ``"auto"`` also renders levels 1..d-1 for the debug dict (d render
  launches), as the JAX package's ``"auto"`` returns every level;
  ``"fused"`` returns level d alone, as the JAX package's does.

With normals (``params.use_normals``, the ``ULTRA`` preset) there is no
fused step: the normals render kernel runs at every level (slope planes
under ``"auto"``/``"fused"``, raw normals under ``"pallas"``) and the
upsample kernel with pre-min at every step -- d + d launches.

The temporal entry points (``render_frame_temporal``,
``render_sequence_temporal``, ``TemporalAOEngine``) add one windowed-
resolve launch per frame under a moving camera, none under a static one.

On CPU tensors the kernel wrappers run their plain versions, so every value
gives the plain path there.

Gradients: when autograd is on and the depth, the normals or a tunable
tensor of ``params`` requires grad, every impl but ``"jnp"`` raises
``ValueError``: no kernel has a backward, and the JAX package refuses
gradients through its kernels too.  ``models/autodiff.py`` maps its
``"auto"`` to ``"jnp"``, as the JAX package's ``"auto"`` is its jnp
path.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuao_torch.ops import composite as C
from tpuao_torch.ops import kernels as K
from tpuao_torch.ops import prepare as P
from tpuao_torch.ops import render as R
from tpuao_torch.ops import temporal as T
from tpuao_torch.ops import upsample as U
from tpuao_torch.params import (AOParams, CameraParams, TemporalParams,
                                load_config, padded_shape, save_config)
from tpuao_torch.utils.camera import relative_motion

IMPLS = ("auto", "jnp", "pallas", "fused")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r} must be one of {IMPLS}")


def _select_render_impl(impl: str):
    """Per-level render function: the plain version for ``"jnp"``, the
    kernel wrapper otherwise."""
    _check_impl(impl)
    return R.render_ao_level if impl == "jnp" else K.render_ao_level


def _select_upsample_impl(impl: str):
    """Chain-step function: the plain version for ``"jnp"``, the kernel
    wrapper otherwise."""
    _check_impl(impl)
    return U.blur_upsample_step if impl == "jnp" else K.blur_upsample_step


def _pad_to_64(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    if (hp, wp) == (h, w):
        return x
    return U._edge_pad(x, 0, hp - h, 0, wp - w)


def _normals_on(normals, device: torch.device) -> torch.Tensor:
    """Normals as a tensor on the depth's ``device``: a tensor elsewhere
    raises (nothing is moved silently), NumPy input is placed there."""
    if isinstance(normals, torch.Tensor):
        if normals.device != device:
            raise ValueError(f"normals on {normals.device}, depth on "
                             f"{device}: put both on one device")
        return normals
    return _as_tensor(normals, device)


def ao_pipeline(depth: torch.Tensor, camera, params, normals=None,
                impl: str = "auto", all_levels: bool = False,
                stop_at_level1: bool = False):
    """depth (..., H, W) [+ normals] -> (full-res AO (..., H, W) float32,
    debug dict).

    With normals (``params.use_normals``), every level renders with the
    normals kernel -- slope planes under ``"auto"``/``"fused"``, raw
    channel-first normals under ``"pallas"`` -- and every chain step is
    the upsample kernel with pre-min: the fused kernel is depth-only.
    ``all_levels`` renders every level even where the frame does not need
    them, for the debug dict: levels 2..d without blur, and levels
    1..d-1 under ``"auto"``'s fused chain (which renders them inside the
    fused kernel) -- as the JAX package's ``"auto"``, its jnp path,
    returns them; ``"fused"`` keeps only level d, as the JAX package's
    does.  With ``all_levels`` under ``"pallas"`` and ``"fused"``,
    ``combined_0`` is the padded (hp, wp) buffer, as there.
    ``stop_at_level1``
    stops before the final step 1 -> 0 and returns the level-1 field
    ``min(combined_1, AO_1)`` at padded level-1 dims instead (``AO_1``
    alone without blur or at depth 1): what the level-1 temporal resolve
    takes.
    """
    _check_impl(impl)
    if impl != "jnp" and K.needs_grad((depth, normals), params):
        raise ValueError(
            f"impl={impl!r} cannot differentiate: its CUDA kernels have no "
            "backward; use impl=\"jnp\" (or models.autodiff, whose \"auto\" "
            "is the plain ops) for gradients")
    h0, w0 = depth.shape[-2:]
    hp, wp = padded_shape(h0, w0)
    use_n = normals is not None and params.use_normals
    d = params.hierarchy_depth
    render_level = _select_render_impl(impl)

    # the padded depth is not held past linearising: where it is a copy
    # and the depth is hardware depth, it is a frame of its own
    linz = P.linearize_depth(_pad_to_64(depth.to(torch.float32), hp, wp),
                             camera)
    # each level once as a dense array: the kernels read raw pointers
    pyr = [lvl.contiguous() for lvl in P.build_pyramid(linz, d)]
    nkw = [{} for _ in range(d + 1)]
    if use_n:
        normals = _normals_on(normals, depth.device)
        if impl == "pallas":  # the raw-normals ABI
            nkw = [{"normals_ds": n}
                   for n in R.normals_pyramid(normals, hp, wp, d)]
        else:  # slope planes once at full res, then pick-one
            nkw = [{"slopes_ds": g} for g in R.slope_pyramid(
                normals.to(torch.float32), camera.tan_half_fov_h, hp, wp, d,
                h0=h0, w0=w0)]
    fused = impl in ("auto", "fused") and params.enable_blur and not use_n
    if not params.enable_blur:
        levels = range(1, d + 1) if all_levels else (1,)
    elif fused and all_levels and impl == "auto":
        levels = range(1, d + 1)  # 1..d-1 for the dict only
    elif fused:
        levels = (d, 1) if stop_at_level1 and d > 1 else (d,)
    else:
        levels = range(1, d + 1)
    aos = {l: render_level(pyr[l], l, wp, camera, params, **nkw[l])
           for l in levels}
    debug = {"linear_z": linz, "ao_levels": aos,
             "pyramid": {l: pyr[l] for l in range(d + 1)}}

    if not params.enable_blur:
        if stop_at_level1:
            return aos[1], debug
        # nearest 2x of the level-1 AO
        ao = aos[1].repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
        return ao[..., :h0, :w0], debug

    # PreMin chain, cropped to (h0, w0) inside its final step -- except
    # for the debug dict under "pallas" and the fused chain of "fused",
    # whose final step the JAX package runs uncropped: there combined_0 is
    # the padded buffer, and the frame is cropped from it
    combined = aos[d]
    upsample_step = _select_upsample_impl(impl)
    padded_c0 = all_levels and (impl == "pallas"
                                or (impl == "fused" and fused))
    for l in range(d, 1 if stop_at_level1 else 0, -1):
        crop = (h0, w0) if l == 1 and not padded_c0 else None
        if fused and l != d:
            combined = K.fused_render_upsample_step(
                pyr[l], combined, pyr[l - 1], l, wp, camera, params,
                crop_hw=crop)
        else:
            combined = upsample_step(
                combined, pyr[l], pyr[l - 1], params, wp,
                lo_ao2=None if l == d else aos[l], crop_hw=crop)
        debug[f"combined_{l - 1}"] = combined
    if stop_at_level1:
        return (torch.minimum(combined, aos[1]) if d > 1 else aos[1]), debug
    if padded_c0:
        return combined[..., :h0, :w0].contiguous(), debug
    return combined, debug


def _quantize(out: torch.Tensor, out_dtype: str) -> torch.Tensor:
    """``"float32"`` passes through, ``"bfloat16"`` casts, ``"uint8"`` is
    the reference's R8 buffer: round(x * 255) for normalised float input;
    an integer input (a composite into an integer colour frame) is already
    in display codes and is cast without the x255 rescale."""
    if out_dtype == "float32":
        return out
    if out_dtype == "bfloat16":
        return out.to(torch.bfloat16)
    if out_dtype == "uint8":
        if not out.dtype.is_floating_point:
            return torch.clamp(out, 0, 255).to(torch.uint8)
        return (torch.clamp(out, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    raise ValueError(f"unsupported out_dtype {out_dtype!r} "
                     "(float32 | bfloat16 | uint8)")


def resolve_device(device=None) -> torch.device:
    """Where NumPy input goes: ``device``, by default the card
    (``"cuda"``), as the JAX package puts it on its default device, the
    chip.  Raises, naming the device and the ``device="cpu"`` escape, when
    that is a CUDA device and there is none: nothing falls back to the CPU
    unasked."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device here; pass "
                           "device=\"cpu\" (or CPU tensors) to run on the "
                           "CPU")
    return device


def _as_tensor(x, device) -> torch.Tensor:
    """A tensor stays where it is; anything else goes to ``device``
    (``resolve_device``: the card unless asked), with float64 narrowed to
    float32 as the JAX package's 32-bit mode does."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=resolve_device(device))


def render_frame(depth, camera=None, params=None, normals=None, color=None,
                 debug_outputs: bool = False, impl: str = "auto",
                 out_dtype: str = "float32", device=None):
    """Full AO pipeline on one frame (H, W) or a batch (..., H, W).

    Returns the AO buffer (or AO-multiplied ``color``), with the debug dict
    when ``debug_outputs``.  Tensors are computed on the device they are
    on; NumPy input is placed on ``device`` (default the card, ``"cuda"``;
    ``device="cpu"`` runs the plain versions on the CPU), NumPy normals and
    colour on the depth's device.  ``normals`` (used with
    ``params.use_normals``) are channel-last (..., H, W, 3) or
    channel-first (..., 3, H, W), batched like ``depth``.  ``out_dtype``:
    ``"float32"``, ``"bfloat16"`` or ``"uint8"``.
    """
    camera = camera or CameraParams()
    params = params or AOParams()
    depth = _as_tensor(depth, device)
    ao, debug = ao_pipeline(depth, camera, params, normals, impl=impl,
                            all_levels=debug_outputs)
    out = ao if color is None else C.composite(
        _as_tensor(color, depth.device), ao)
    out = _quantize(out, out_dtype)
    return (out, debug) if debug_outputs else out


def single_scale_ao(depth, camera=None, params=None, impl: str = "auto",
                    device=None) -> torch.Tensor:
    """[BJ] config 1: AO at 1/2 input resolution, no blur (ceil halves).
    NumPy input goes to ``device`` (default the card)."""
    camera = camera or CameraParams()
    params = (params or AOParams()).replace(hierarchy_depth=1,
                                            enable_blur=False)
    depth = _as_tensor(depth, device)
    h0, w0 = depth.shape[-2:]
    hp, wp = padded_shape(h0, w0)
    linz = P.linearize_depth(_pad_to_64(depth.to(torch.float32), hp, wp),
                             camera)
    ds2 = P.downsample2x(linz).contiguous()
    ao = _select_render_impl(impl)(ds2, 1, wp, camera, params)
    return ao[..., : -(-h0 // 2), : -(-w0 // 2)]


# ---------------------------------------------------------------------------
# Temporal accumulation (spec: tpuao/golden/temporal.py)
# ---------------------------------------------------------------------------


def _temporal_frame_core(depth, prev_ao, prev_depth, motion, camera, params,
                         tparams, normals, color, impl: str, out_dtype: str,
                         resolve_level: int = 0):
    """Frame pipeline + temporal resolve of one (H, W) frame.  Returns
    ``(output, (resolved_ao, linear_depth))``; the state is float32
    whatever ``out_dtype`` and ``color``.

    ``resolve_level=0`` resolves the full-res AO (the spec);
    ``resolve_level=1`` resolves the level-1 field before the final
    upsample lifts it, with a half-res history state."""
    h0, w0 = depth.shape[-2:]
    if resolve_level == 0:
        ao, dbg = ao_pipeline(depth, camera, params, normals, impl=impl)
        linz = dbg["linear_z"][..., :h0, :w0].contiguous()
        resolved = T.temporal_resolve(ao, linz, prev_ao, prev_depth, camera,
                                      tparams, motion, impl=impl)
        out, state = resolved, (resolved, linz)
    else:
        out, state = _resolve_l1_and_lift(depth, prev_ao, prev_depth, motion,
                                          camera, params, tparams, normals,
                                          impl)
    if color is not None:
        out = C.composite(_as_tensor(color, depth.device), out)
    return _quantize(out, out_dtype), state


def _resolve_l1_and_lift(depth, prev_ao1, prev_d1, motion, camera, params,
                         tparams, normals, impl: str):
    """Level-1 resolve and final lift (spec: golden
    ``render_frame_l1_temporal_golden``): the pipeline stops at the level-1
    field ``min(combined_1, AO_1)`` -- it never runs the step 1 -> 0 it
    would throw away -- which is resolved at the true half dims, edge-padded
    back and lifted by the upsample step 1 -> 0 without pre-min (nearest
    2x without blur).  Returns ``(full_res_ao, (resolved_l1, d1))``."""
    if impl == "fused":
        raise ValueError("resolve_level=1 needs the level-1 AO as a "
                         "separate buffer; impl='fused' renders it inside "
                         "the fused chain kernel -- use impl='auto'")
    h0, w0 = depth.shape[-2:]
    hp, wp = padded_shape(h0, w0)
    h1, w1 = -(-h0 // 2), -(-w0 // 2)
    cur1, dbg = ao_pipeline(depth, camera, params, normals, impl=impl,
                            stop_at_level1=True)
    d1c = dbg["pyramid"][1][..., :h1, :w1].contiguous()
    resolved = T.temporal_resolve_l1(cur1[..., :h1, :w1], d1c, prev_ao1,
                                     prev_d1, h0, w0, camera, tparams,
                                     motion, impl=impl)
    rp = _pad_to_64(resolved, hp // 2, wp // 2).contiguous()
    if params.enable_blur:
        out = _select_upsample_impl(impl)(rp, dbg["pyramid"][1],
                                          dbg["pyramid"][0], params, wp,
                                          crop_hw=(h0, w0))
    else:
        out = rp.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
        out = out[..., :h0, :w0]
    return out, (resolved, d1c)


def _temporal_state_shape(h0: int, w0: int, resolve_level: int):
    """History-state dims: full res, or ceil-half at level 1."""
    if resolve_level == 0:
        return h0, w0
    return -(-h0 // 2), -(-w0 // 2)


def _check_resolve_level(resolve_level) -> None:
    if resolve_level not in (0, 1):
        raise ValueError(f"resolve_level must be 0 or 1, "
                         f"got {resolve_level!r}")


def render_frame_temporal(depth, state=None, camera=None, params=None,
                          tparams=None, motion=None, normals=None,
                          color=None, impl: str = "auto",
                          out_dtype: str = "float32",
                          resolve_level: int = 0, device=None):
    """One temporally accumulated (H, W) frame: pipeline + resolve.

    ``state`` is the ``(ao, depth)`` history of the previous call, or None
    for a fresh sequence (the null history makes frame 0 resolve to its own
    single-frame AO).  ``motion``: None (static camera), a (4, 4) current->
    previous eye transform (``utils.camera.relative_motion``), or a
    per-pixel motion-vector buffer (H, W, 2) or (2, H, W) in pixels,
    current->previous.  ``resolve_level``: 0 resolves at full res (the
    spec), 1 resolves the level-1 field before the final upsample (half-res
    history).  NumPy input goes to ``device`` (default the card, as in
    ``render_frame``).  Returns
    ``(output, new_state)``.
    """
    camera = camera or CameraParams()
    params = params or AOParams()
    tparams = tparams or TemporalParams()
    depth = _as_tensor(depth, device)
    h0, w0 = depth.shape[-2:]
    if depth.ndim != 2:
        raise ValueError("temporal accumulation is per-sequence: depth must "
                         f"be a single (H, W) frame, got "
                         f"{tuple(depth.shape)}")
    _check_resolve_level(resolve_level)
    hs, ws = _temporal_state_shape(h0, w0, resolve_level)
    if state is None:
        state = T.initial_state(hs, ws, device=depth.device)
    elif tuple(state[0].shape[-2:]) != (hs, ws):
        raise ValueError(
            f"state shape {tuple(state[0].shape[-2:])} does not match "
            f"resolve_level={resolve_level} (expected {(hs, ws)}) -- a "
            "sequence must keep one resolve_level throughout")
    return _temporal_frame_core(depth, state[0], state[1], motion, camera,
                                params, tparams, normals, color, impl,
                                out_dtype, resolve_level)


def render_sequence_temporal(depths, camera=None, params=None, tparams=None,
                             motions=None, normals=None, impl: str = "auto",
                             out_dtype: str = "float32",
                             resolve_level: int = 0, device=None):
    """A temporally accumulated sequence: ``depths`` (T, H, W) -> the
    (T, H, W) stack of resolved frames, one host-loop step per frame.

    ``motions``: None (static camera), (T, 4, 4) with ``motions[t]``
    mapping frame t's eye space to frame t-1's (``motions[0]`` is ignored:
    frame 0 has the null history), or per-pixel motion-vector buffers
    (T, H, W, 2) / (T, 2, H, W).  ``normals``: (T, ...) per frame.
    ``resolve_level`` as in ``render_frame_temporal``.  NumPy input goes
    to ``device`` (default the card, as in ``render_frame``).
    """
    _check_resolve_level(resolve_level)
    camera = camera or CameraParams()
    params = params or AOParams()
    tparams = tparams or TemporalParams()
    depths = _as_tensor(depths, device)
    if depths.ndim != 3:
        raise ValueError(f"depths must be (T, H, W), got "
                         f"{tuple(depths.shape)}")
    t_n, h_n, w_n = depths.shape
    if motions is not None:
        ok = tuple(np.shape(motions)) in ((t_n, 4, 4), (t_n, h_n, w_n, 2),
                                      (t_n, 2, h_n, w_n))
        if not ok:
            raise ValueError(
                f"motions must be ({t_n}, 4, 4) eye transforms or "
                f"({t_n}, {h_n}, {w_n}, 2) / ({t_n}, 2, {h_n}, {w_n}) "
                f"motion-vector buffers, got {tuple(np.shape(motions))}")
    outs, state = [], None
    for t in range(t_n):
        out, state = render_frame_temporal(
            depths[t], state, camera, params, tparams,
            motion=None if motions is None or t == 0 else motions[t],
            normals=None if normals is None else normals[t], impl=impl,
            out_dtype=out_dtype, resolve_level=resolve_level)
        outs.append(out)
    return torch.stack(outs)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


class AmbientOcclusionEngine:
    """Stateful engine: validated tunable properties, config persistence,
    a debug view, and one ``render`` per frame.

    PyTorch runs eagerly, so there is no program cache: changing a tunable
    or the frame size costs nothing.  Tensors are computed on the device
    they are on; NumPy input goes to ``device`` (default the card, as in
    ``render_frame``; ``device="cpu"`` for the CPU).
    """

    def __init__(self, camera: CameraParams | None = None,
                 params: AOParams | None = None, impl: str = "auto",
                 debug: bool = False, out_dtype: str = "float32",
                 device=None):
        _check_impl(impl)
        self.device = device  # where NumPy input goes (None: the card)
        self.camera = camera or CameraParams()
        self._params = (params or AOParams()).validate()
        self.impl = impl
        self.debug = debug  # debug view: AO as a grayscale colour frame
        self.out_dtype = out_dtype

    # --- validated tunable properties ---
    @property
    def params(self) -> AOParams:
        return self._params

    @params.setter
    def params(self, value: AOParams):
        self._params = value.validate()

    def _set(self, **kw):
        self._params = self._params.replace(**kw).validate()

    noise_filter_tolerance = property(
        lambda s: s._params.noise_filter_tolerance,
        lambda s, v: s._set(noise_filter_tolerance=v))
    blur_tolerance = property(
        lambda s: s._params.blur_tolerance,
        lambda s, v: s._set(blur_tolerance=v))
    upsample_tolerance = property(
        lambda s: s._params.upsample_tolerance,
        lambda s, v: s._set(upsample_tolerance=v))
    rejection_falloff = property(
        lambda s: s._params.rejection_falloff,
        lambda s, v: s._set(rejection_falloff=v))
    strength = property(
        lambda s: s._params.strength,
        lambda s, v: s._set(strength=v))

    # --- config persistence ---
    def save_config(self, path: str) -> str:
        return save_config(path, self._params, self.camera)

    @classmethod
    def from_config(cls, path: str, **kw) -> "AmbientOcclusionEngine":
        params, camera = load_config(path)
        return cls(camera, params, **kw)

    # --- per-frame entry ---
    def render(self, depth, normals=None, color=None, debug_outputs=False):
        if self.debug and color is not None:
            out = render_frame(depth, self.camera, self._params, normals,
                               None, debug_outputs, self.impl,
                               device=self.device)
            ao, dbg = out if debug_outputs else (out, None)
            # channel count from the colour frame only when it has a
            # channel axis (a 2-D grayscale frame's shape[-1] is W)
            ch = color.shape[-1] if np.ndim(color) == ao.ndim + 1 else 1
            view = _quantize(C.debug_view(ao, ch), self.out_dtype)
            return (view, dbg) if debug_outputs else view
        return render_frame(depth, self.camera, self._params, normals,
                            color, debug_outputs, self.impl,
                            out_dtype=self.out_dtype, device=self.device)

    def render_views(self, depths, normals=None, color=None, mesh=None,
                     debug_outputs: bool = False):
        """[BJ] config 5 through the engine: ``render_views_sharded`` of
        a (V, H, W) batch with the engine's camera, params, impl,
        ``out_dtype`` and device."""
        from tpuao_torch.parallel.sharding import render_views_sharded

        return render_views_sharded(
            depths, self.camera, self._params, normals=normals, mesh=mesh,
            impl=self.impl, color=color, out_dtype=self.out_dtype,
            debug_outputs=debug_outputs, device=self.device)

    def render_spatial(self, depth, normals=None, color=None, mesh=None,
                       halo_rows: int | None = None,
                       debug_outputs: bool = False):
        """One large frame in row bands across a mesh through the engine:
        ``render_frame_spatial`` with the engine's camera, params, impl,
        ``out_dtype`` and device."""
        from tpuao_torch.parallel.spatial import render_frame_spatial

        return render_frame_spatial(
            depth, self.camera, self._params, mesh=mesh, impl=self.impl,
            halo_rows=halo_rows, normals=normals, color=color,
            out_dtype=self.out_dtype, debug_outputs=debug_outputs,
            device=self.device)

    def render_sections(self, depth, n_sections: int = 2, normals=None,
                        color=None, halo_rows: int | None = None):
        """One large frame as sequential row sections on one device
        through the engine: ``render_frame_sections`` with the engine's
        camera, params, impl, ``out_dtype`` and device.  It equals
        ``render_frame``'s result at about one section's peak memory."""
        from tpuao_torch.parallel.sections import render_frame_sections

        return render_frame_sections(
            depth, self.camera, self._params, n_sections=n_sections,
            halo_rows=halo_rows, impl=self.impl, normals=normals,
            color=color, out_dtype=self.out_dtype, device=self.device)

    __call__ = render


class TemporalAOEngine(AmbientOcclusionEngine):
    """Stateful temporal accumulation: carries the ``(ao, depth)`` history
    across ``render`` calls and derives each frame's motion from camera
    view matrices::

        eng = TemporalAOEngine()
        out = eng.render(depth0, view=V0)   # frame 0: resolves to itself
        out = eng.render(depth1, view=V1)   # reprojected accumulation

    ``view`` is the world->eye matrix (``utils/camera.py`` convention);
    omit it, or pass ``motion`` directly, for a static camera.  ``reset()``
    drops the history (scene cut).  A change of ``resolve_level`` drops it
    too: the state's shape differs between levels.
    """

    def __init__(self, camera: CameraParams | None = None,
                 params: AOParams | None = None,
                 tparams: TemporalParams | None = None,
                 impl: str = "auto", out_dtype: str = "float32",
                 resolve_level: int = 0, device=None):
        super().__init__(camera, params, impl=impl, out_dtype=out_dtype,
                         device=device)
        self._tparams = (tparams or TemporalParams()).validate()
        _check_resolve_level(resolve_level)
        self._resolve_level = resolve_level
        self._state = None
        self._prev_view = None

    @property
    def resolve_level(self) -> int:
        return self._resolve_level

    @resolve_level.setter
    def resolve_level(self, value: int):
        _check_resolve_level(value)
        if value != self._resolve_level:
            self._resolve_level = value
            self.reset()

    @property
    def tparams(self) -> TemporalParams:
        return self._tparams

    @tparams.setter
    def tparams(self, value: TemporalParams):
        self._tparams = value.validate()

    history_weight = property(
        lambda s: s._tparams.history_weight,
        lambda s, v: setattr(s, "tparams",
                             s._tparams.replace(history_weight=v)))
    depth_tolerance = property(
        lambda s: s._tparams.depth_tolerance,
        lambda s, v: setattr(s, "tparams",
                             s._tparams.replace(depth_tolerance=v)))

    def reset(self):
        """Drop the accumulated history (scene cut, sequence restart)."""
        self._state = None
        self._prev_view = None

    def render(self, depth, normals=None, color=None, motion=None,
               view=None):
        if motion is not None and view is not None:
            raise ValueError("pass motion= or view=, not both")
        if view is not None:
            view = np.asarray(view, np.float64).reshape(4, 4)
            if self._prev_view is not None:
                motion = relative_motion(self._prev_view, view)
            self._prev_view = view
        out, self._state = render_frame_temporal(
            depth, self._state, self.camera, self._params, self._tparams,
            motion=motion, normals=normals, color=color, impl=self.impl,
            out_dtype=self.out_dtype, resolve_level=self._resolve_level,
            device=self.device)
        return out

    __call__ = render

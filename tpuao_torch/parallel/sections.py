"""Sequential row sections of ONE large frame on one device.

Counterpart of ``tpuao/parallel/sections.py``.  It is a memory tool, not a
speed tool: the frame is cut into ``k`` halo-overlapped row sections, each
runs the frame program (``ao_pipeline``, every kernel of the main path) in
turn, and each section's kept rows are written into one output tensor.
Peak device memory is then the input, the output and one section's
temporaries, where the monolithic frame holds the whole frame's.

The result equals ``render_frame`` on the same frame (not the halo-padded
frame that the spatial mode equals): boundary sections include the real
frame edge, and the halo (``stencil_halo_rows(params)`` by default) covers
the whole render and chain stencil, so every kept row is computed from the
same values as in the monolithic frame.  Section starts are multiples of
64, so every level's pick-one grid and parity-4 layout are the frame's.

The JAX package edge-pads the whole frame to the plan's height (a multiple
of 64 k) and concatenates the sections' crops.  On the card each of those
would be a second full frame, so the port does neither:

* a section is the frame's rows ``[a, min(b, H))``, a view.  The section
  that reaches past the last row ends there, and the frame program pads it
  to a multiple of 64 rows as it pads the monolithic frame, so its bottom
  is the monolithic frame's own padded bottom;
* each section's kept rows are composited, quantised and copied into one
  output allocated once, and none of the section's tensors outlives that
  copy;
* a section with no row to keep (wholly below the frame, in a plan for a
  short frame) is not rendered.

The first point is also where the port departs from the reference's
result.  ``tpuao``'s last section, edge-padded to the plan's height,
differs from ``tpuao``'s monolithic frame near the bottom edge wherever
that height exceeds the frame's 64-aligned height, since rows past the
frame program's pad then replace its parity-4 apron (ROADMAP queue 3).

``debug_outputs`` is not offered, as in the JAX package: the debug pyramid
is a whole-frame buffer, which this mode exists to avoid.
"""

from __future__ import annotations

import torch

from tpuao_torch.models.pipeline import (_as_tensor, _normals_on, _quantize,
                                         ao_pipeline)
from tpuao_torch.ops import composite as C
from tpuao_torch.ops.render import normals_channel_last
from tpuao_torch.params import AOParams, CameraParams
from tpuao_torch.parallel.spatial import stencil_halo_rows


def section_plan(h: int, n_sections: int, halo: int):
    """Row bounds of ``n_sections`` halo-overlapped sections of ``h`` rows.

    Returns ``(aligned_h, band, [(start, stop, crop_off), ...])``: the
    frame's rows are counted up to ``aligned_h``, the next multiple of
    ``64 * n_sections``; section ``i`` runs the frame program on rows
    ``[start, stop)`` of that height and keeps its output rows
    ``[crop_off, crop_off + band)``.  Boundary sections have one halo,
    interior sections two.  Where ``band < halo`` (too many sections for
    the height) the bounds clamp at the frame and the crop offsets differ
    from ``halo``.  The JAX package's plan, bound for bound.
    """
    k = int(n_sections)
    if k < 1:
        raise ValueError(f"n_sections={n_sections} must be at least 1")
    if halo < 0 or halo % 64:
        raise ValueError(f"halo_rows={halo} must be a multiple of 64")
    mult = 64 * k
    ha = -(-h // mult) * mult
    band = ha // k
    plan = []
    for i in range(k):
        a = max(0, i * band - halo)
        b = min(ha, (i + 1) * band + halo)
        plan.append((a, b, i * band - a))
    return ha, band, plan


def _render_plan(depth, camera, params, plan, band: int, impl: str,
                 normals=None, color=None, color_rows: int = -2,
                 out_dtype: str = "float32") -> torch.Tensor:
    """Each section of ``plan`` through the frame program, in turn, its
    kept rows written into one output (see the module docstring).
    ``normals`` are channel-last; ``color``'s rows are on ``color_rows``."""
    h0 = depth.shape[-2]
    out_rows = color_rows if color is not None else -2
    out = None
    for a, b, off in plan:
        start = a + off
        keep = min(band, h0 - start)
        if keep <= 0:
            continue
        stop = min(b, h0)
        # [0] drops the debug dict at once: it holds the section's pyramid
        ao = ao_pipeline(depth[..., a:stop, :], camera, params,
                         None if normals is None else normals[..., a:stop,
                                                              :, :],
                         impl=impl)[0]
        piece = ao[..., off:off + keep, :]
        if color is not None:
            piece = C.composite(color.narrow(color_rows, start, keep), piece)
        piece = _quantize(piece, out_dtype)
        if out is None:
            shape = list(piece.shape)
            shape[out_rows] = h0
            out = piece.new_empty(shape)
        out.narrow(out_rows, start, keep).copy_(piece)
        del ao, piece  # free the section before the next one renders
    return out


def render_frame_sections(depth, camera=None, params=None,
                          n_sections: int = 2, halo_rows: int | None = None,
                          impl: str = "auto", normals=None, color=None,
                          out_dtype: str = "float32", device=None):
    """Render one (..., H, W) frame as ``n_sections`` sequential sections.

    ``render_frame``'s contract minus ``debug_outputs``, and its result on
    the same inputs (see the module docstring): tensors are computed on
    the device they are on, NumPy input goes to ``device`` (default the
    card); ``normals`` are channel-last (..., H, W, 3) or channel-first
    (..., 3, H, W); ``color`` is (..., H, W, C) or (..., H, W).
    ``halo_rows`` defaults to ``stencil_halo_rows(params)``, 320 rows at
    hierarchy depth 4; a section keeps ``aligned_h / n_sections`` rows
    (``section_plan``).  Each section launches the frame's kernels once.
    """
    camera = camera or CameraParams()
    params = params or AOParams()
    if halo_rows is None:
        halo_rows = stencil_halo_rows(params)
    depth = _as_tensor(depth, device)
    _, band, plan = section_plan(depth.shape[-2], n_sections, halo_rows)
    if normals is not None:
        normals = normals_channel_last(_normals_on(normals, depth.device))
    color_rows = -2
    if color is not None:
        color = _as_tensor(color, depth.device)
        color_rows = -3 if color.ndim == depth.ndim + 1 else -2
    return _render_plan(depth, camera, params, plan, band, impl, normals,
                        color, color_rows, out_dtype)


def sections_fused_fn(k: int, ha: int, band: int, halo: int, impl: str):
    """The fused form's callable for one plan, ``fn(depth, camera, params)
    -> ao``, for a depth of ``ha`` rows once aligned to ``64 * k``.

    The JAX package traces this decomposition into one program, the two
    boundary sections as one ``lax.map`` and the interior ones as another,
    which needs every section of a map to have one shape.  PyTorch has no
    program to trace: the callable runs the sections one after another,
    the kernels of each launched as in ``render_frame_sections``, and is
    what a harness captures in a CUDA graph (``utils.timing
    .cuda_graph_ms``).  A clamped plan (``band < halo``) raises here as it
    does there, where the stacked maps would keep the wrong rows.
    """
    if k > 1 and band < halo:
        raise ValueError(f"band {band} < halo {halo}: clamped plans need "
                         "the separate-launch mode (render_frame_sections)")
    _, _, plan = section_plan(ha, k, halo)

    def fn(depth, camera, params):
        if -(-depth.shape[-2] // (64 * k)) * 64 * k != ha:
            raise ValueError(f"a frame of {depth.shape[-2]} rows does not "
                             f"align to this plan's {ha}")
        return _render_plan(depth, camera, params, plan, band, impl)

    return fn


def render_frame_sections_fused(depth, camera=None, params=None,
                                n_sections: int = 2,
                                halo_rows: int | None = None,
                                impl: str = "auto", device=None):
    """The sections of one depth-only (H, W) frame through
    ``sections_fused_fn``: the same decomposition and result as
    ``render_frame_sections``, without normals, colour or a batch, and
    refusing a clamped plan."""
    camera = camera or CameraParams()
    params = params or AOParams()
    if halo_rows is None:
        halo_rows = stencil_halo_rows(params)
    depth = _as_tensor(depth, device)
    if depth.ndim != 2:
        raise ValueError(f"fused sections take a single (H, W) frame, got "
                         f"{tuple(depth.shape)}")
    ha, band, _ = section_plan(depth.shape[-2], n_sections, halo_rows)
    return sections_fused_fn(int(n_sections), ha, band, halo_rows,
                             impl)(depth, camera, params)

"""The frozen work model: the operations and bytes of one AO frame, and the
H100's peaks.

A copy of ``tpuao_torch/utils/roofline.py``'s ``stage_traffic_bytes``,
``min_traffic_bytes``, ``render_ops``, ``render_work``, ``chain_work``,
``stage_work`` and ``bound`` with its peaks, kept here so that a later
change to the program cannot move the yardstick.  The operation counts
were taken from the kernels' code (a depth-only pair test is 23 FP32
operations, the tangent term 11 more; a chain step ~153 a lo texel), so a
frame's bound reads the same work whatever implements it.

Peaks: NVIDIA H100 SXM data sheet at its 700 W power limit -- 67 TFLOP/s
FP32 outside the tensor cores (the pipeline is elementwise FP32 with no
matrix product) and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from aobench.reference.params import padded_shape

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
CHAIN_OPS = 153


def stage_traffic_bytes(h: int, w: int, depth_levels: int = 4,
                        use_normals: bool = False, enable_blur: bool = True,
                        single_scale: bool = False,
                        dtype_bytes: int = 4) -> dict[str, int]:
    """Per-stage minimal HBM bytes of one frame: prepare reads the depth
    and writes linz and each level (one read of the parent per level);
    each level's render reads it and writes its AO; each chain step reads
    combined, the pre-min AO, lo and hi depth and writes hi."""
    hw = h * w
    lv = [hw // (4 ** l) for l in range(depth_levels + 1)]
    out: dict[str, int] = {}
    t = 2 * hw
    for l in range(1, depth_levels + 1):
        t += lv[l - 1] + lv[l]
    if use_normals:
        t += 3 * hw
        for l in range(1, depth_levels + 1):
            t += 3 * (lv[l - 1] + lv[l])
    out["prepare"] = t
    for l in range(1, depth_levels + 1):
        out[f"render_l{l}"] = (2 + (3 if use_normals else 0)) * lv[l]
    if enable_blur:
        for l in range(depth_levels, 0, -1):
            out[f"upsample_l{l}"] = (
                lv[l] * (3 if l == depth_levels else 4) + 2 * lv[l - 1])
    elif not single_scale:
        out["upsample_nearest"] = lv[1] + hw
    return {k: v * dtype_bytes for k, v in out.items()}


def min_traffic_bytes(h: int, w: int, **kw) -> int:
    """Minimal HBM bytes of one frame (the sum over the stages)."""
    return sum(stage_traffic_bytes(h, w, **kw).values())


def render_ops(npairs: int, tangent: bool = False) -> int:
    """FP32 operations of one rendered texel."""
    return (34 if tangent else 23) * npairs + (8 if tangent else 6)


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(bound in ms, "operations" or "bytes"): the larger of the two
    times on the card."""
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def render_work(shape, npairs=34, planes=0):
    """Operations and bytes of one render call on (..., h, w)."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * render_ops(npairs, planes > 0), 4 * n * (2 + planes)


def chain_work(shape, h0, w0, npairs=0, lo_inputs=2, blend=False):
    """Operations and bytes of one chain step from (..., lh, lw) to the
    (h0, w0) crop; ``npairs`` > 0 renders the level too (the fused
    step)."""
    *lead, lh, lw = (int(d) for d in shape)
    b = 1
    for d in lead:
        b *= d
    lo = b * lh * lw
    ops = lo * (CHAIN_OPS + (render_ops(npairs) if npairs else 0))
    nbytes = 4 * (lo * lo_inputs + 4 * lo * (2 if blend else 1) +
                  b * h0 * w0)
    return ops, nbytes


def stage_work(h0: int, w0: int, params, batch: int = 1
               ) -> dict[str, tuple[float, float]]:
    """Operations and bytes of each stage on the padded levels the frame
    runs: prepare (bytes only), ``render_l{l}``, ``upsample_l{l}``."""
    hp, wp = padded_shape(h0, w0)
    d = params.hierarchy_depth
    npairs = 34 if params.exhaustive else 10
    lv = [(batch, hp >> l, wp >> l) for l in range(d + 1)]
    out = {"prepare": (0.0, float(batch * stage_traffic_bytes(
        hp, wp, d)["prepare"]))}
    for l in range(1, d + 1):
        out[f"render_l{l}"] = render_work(
            lv[l], npairs, planes=2 if params.use_normals else 0)
    for l in range(d, 0, -1):
        hi = (h0, w0) if l == 1 else lv[l - 1][1:]
        out[f"upsample_l{l}"] = chain_work(lv[l], *hi,
                                           lo_inputs=2 if l == d else 3)
    return out


def frame_bound_ms(h0: int, w0: int, params) -> tuple[float, str]:
    """The least time one frame could take on the card: the larger of its
    operations (the sum of ``stage_work``) at ``PEAK_FLOPS`` and its bytes
    (``min_traffic_bytes``) at ``PEAK_BYTES``."""
    ops = sum(o for o, _ in stage_work(h0, w0, params).values())
    nbytes = min_traffic_bytes(h0, w0, depth_levels=params.hierarchy_depth,
                               use_normals=params.use_normals,
                               enable_blur=params.enable_blur)
    return bound(ops, nbytes)

"""Roofline accounting for the port on one NVIDIA H100.

Counterpart of ``tpuao/utils/roofline.py``: it turns a measured time into
a share of the least time the card could take, the larger of a call's
bytes over the memory rate and its operations over the FP32 rate.  The
byte model is the JAX package's, which depends on no device; the peaks and
the operation counts are the card's and the port's kernels'.

Hardware model (NVIDIA H100 SXM data sheet, 700 W power limit; a card set
below it runs slower under load, so a share is stated beside the card's
power limit):

* ``PEAK_BYTES = 3.35e12`` -- HBM3 bytes a second;
* ``PEAK_FLOPS = 67e12`` -- FP32 operations a second outside the tensor
  cores: the AO pipeline is elementwise FP32 with no matrix product.

What each name of ``tpuao/utils/roofline.py`` became:

* ``stage_traffic_bytes``, ``min_traffic_bytes``: copied as they are
  (tests hold them equal to ``tpuao``'s);
* ``HBM_GBPS``, ``VPU_F32_TFLOPS``: ``PEAK_BYTES``, ``PEAK_FLOPS``;
* ``HBM_GBPS_ACHIEVED``, ``KERNEL_FIXED_MS``: none -- they were measured on
  a TPU v5e, and no counterpart has been measured on the card;
* ``floors_ms``: the same keys (``mem_floor_ms``, ``flop_floor_ms``,
  ``floor_ms``, ``pct_of_roofline``) against the card's peaks; the
  operations are the caller's count (``stage_work``, ``render_work``,
  ``chain_work``), where ``tpuao`` took XLA's ``cost_analysis``.  The
  relayout and attribution terms read XLA's compiled program and have no
  counterpart;
* ``entry_census``, ``relayout_bytes``, ``hbm_mb``, ``cost_counts``: these
  read XLA's HLO and buffer assignment, which eager PyTorch does not have.
  Their job, a count of what a program launches, is ``launch_census``
  (torch.profiler over a few calls: launches and device time by kernel;
  ``census_by_wrapper`` sorts the frame path's launches by wrapper);
  peak memory is ``torch.cuda.max_memory_allocated``.

Per-kernel work (``render_ops``, ``render_work``, ``chain_work``,
``CHAIN_OPS``, ``WINDOWED_OPS``, ``bound``) is counted from the kernels'
code, so that a kernel's bound reads the same work whatever implements it.
"""

from __future__ import annotations

import re

from tpuao_torch.params import padded_shape

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Operations counted from the kernels' code: a depth-only pair test is 23
# FP32 operations (csrc/common.cuh), the tangent term 11 more; a texel adds
# ~6 (1/z, clamp, pow) or ~8; the noise filter and 2x of a chain step ~153
# a lo texel; the windowed resolve ~30 a texel.
CHAIN_OPS = 153
WINDOWED_OPS = 30


def stage_traffic_bytes(h: int, w: int, depth_levels: int = 4,
                        use_normals: bool = False, enable_blur: bool = True,
                        single_scale: bool = False,
                        dtype_bytes: int = 4) -> dict[str, int]:
    """Per-stage minimal HBM bytes of one frame, keyed by the same stage
    names ``profiling.stage_times_ms`` reports.

      prepare : read depth (HW); write linz (HW); write each pyramid level.
                (Each level is produced by slicing its parent, which was
                just written -- count one read of the parent per level.)
      render  : per level, read the level + write the AO estimate.
      chain   : per step, read combined + premin AO + lo depth + hi depth,
                write the upsampled result (at hi res).
      output  : the final combined IS the output write (counted in chain).
    """
    hw = h * w
    lv = [hw // (4 ** l) for l in range(depth_levels + 1)]  # level sizes
    out: dict[str, int] = {}

    t = 2 * hw        # read input depth + write linz
    for l in range(1, depth_levels + 1):
        t += lv[l - 1] + lv[l]    # read parent, write level
    if use_normals:
        t += 3 * hw               # read normals
        for l in range(1, depth_levels + 1):
            t += 3 * (lv[l - 1] + lv[l])  # normal pyramid (channel planes)
    out["prepare"] = t

    for l in range(1, depth_levels + 1):
        out[f"render_l{l}"] = (2 + (3 if use_normals else 0)) * lv[l]

    if enable_blur:
        for l in range(depth_levels, 0, -1):
            out[f"upsample_l{l}"] = (
                lv[l] * (3 if l == depth_levels else 4) + 2 * lv[l - 1])
    elif not single_scale:
        out["upsample_nearest"] = lv[1] + hw
    # single_scale: the half-res AO buffer IS the output -- no re-read, no
    # full-res upsample write

    return {k: v * dtype_bytes for k, v in out.items()}


def min_traffic_bytes(h: int, w: int, **kw) -> int:
    """Minimal HBM bytes for one frame through the pipeline (the sum of
    ``stage_traffic_bytes``)."""
    return sum(stage_traffic_bytes(h, w, **kw).values())


def floors_ms(measured_ms: float, h: int, w: int, ops: float | None = None,
              **traffic_kw) -> dict:
    """Roofline floors of one frame of (h, w) and the share of them that
    ``measured_ms`` reaches: ``mem_floor_ms`` (``min_traffic_bytes`` at
    ``PEAK_BYTES``), ``flop_floor_ms`` (``ops`` at ``PEAK_FLOPS``; absent
    when ``ops`` is None), ``floor_ms`` (the larger) and
    ``pct_of_roofline`` (100 floor / measured)."""
    mem_ms = min_traffic_bytes(h, w, **traffic_kw) / PEAK_BYTES * 1e3
    out = {"mem_floor_ms": mem_ms}
    floor = mem_ms
    if ops is not None:
        out["flop_floor_ms"] = ops / PEAK_FLOPS * 1e3
        floor = max(floor, out["flop_floor_ms"])
    out["floor_ms"] = floor
    out["pct_of_roofline"] = 100.0 * floor / measured_ms
    return out


# -- per-kernel work ---------------------------------------------------------

def prepare_work(batch: int, h0: int, w0: int, depth_levels: int,
                 normals: bool = False) -> tuple[int, int]:
    """Operations and bytes of one prologue launch (``csrc/prepare.cu``)
    over ``batch`` (h0, w0) frames: the depth read once, linz written at
    the padded (hp, wp) and each level 1..d once; with normals their rows
    that the levels sample (every even row, and the last one where the
    pad clamps to it), read whole (a channel-last row's even texels share
    its sectors), and 2 slope planes a level.  Operations: 3 a linz texel
    (hardware depth), 4 a level-1 texel's pair of slopes (the deeper
    levels copy them)."""
    hp, wp = padded_shape(h0, w0)
    levels = sum((hp >> l) * (wp >> l) for l in range(1, depth_levels + 1))
    elems = h0 * w0 + hp * wp + levels
    ops = 3 * hp * wp
    if normals:
        rows = len({min(y, h0 - 1) for y in range(0, hp, 2)})
        elems += 3 * rows * w0 + 2 * levels
        ops += 4 * (hp >> 1) * (wp >> 1)
    return batch * ops, 4 * batch * elems


def render_ops(npairs: int, tangent: bool = False) -> int:
    """FP32 operations of one rendered texel."""
    return (34 if tangent else 23) * npairs + (8 if tangent else 6)


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(bound in ms, "operations" or "bytes"): the larger of the two
    times on the card."""
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def render_work(shape, npairs=34, planes=0):
    """Operations and bytes of one render call on (..., h, w); ``planes``
    extra input planes (2 slopes, 3 raw normals; tangent term then)."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * render_ops(npairs, planes > 0), 4 * n * (2 + planes)


def chain_work(shape, h0, w0, npairs=0, lo_inputs=2, blend=False):
    """Operations and bytes of one chain step from (..., lh, lw) to the
    (h0, w0) crop: ``npairs`` > 0 renders the level too (the fused step);
    ``lo_inputs`` lo planes read (depth and AO or c1, [+ pre-min])."""
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
    """Operations and bytes of each stage that ``profiling.stage_times_ms``
    times, on the padded levels the frame program runs: ``prepare`` (pad,
    linearise and the pyramid: ``stage_traffic_bytes``' bytes, no
    operations counted), ``render_l{l}`` (``render_work``, with the slope
    planes when ``params.use_normals``) and ``upsample_l{l}``
    (``chain_work``: no pre-min at the coarsest step, the crop to
    (h0, w0) at the last)."""
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


# -- what a program launches --------------------------------------------------

def launch_census(fn, calls: int = 20) -> dict[str, tuple[int, float]]:
    """``{kernel name: (launches, device ms)}`` over ``calls`` calls of
    ``fn`` after one warm-up call, read by ``torch.profiler`` from the
    card's own records (names shortened: ``void`` and the argument list
    dropped, at most 60 characters, e.g.
    ``tpuao::fused_step_kernel<34, 2>``).  The profiler may drop records
    on a busy host: a count that is not a whole number a call says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, tuple[int, float]] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = re.sub(r"^void |\(.*$|^(?:at::native::|tpuao::)", "",
                          name)[:60]
            n, ms = out.get(name, (0, 0.0))
            out[name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    return out


def census_by_wrapper(census: dict) -> dict[str, int]:
    """``launch_census``'s launches by the wrapper of ``ops/kernels.py``
    that owns each kernel of the frame path (``render_kernel<NP, MODE,
    NT>`` with MODE 0 is the depth-only render); other kernels (copies,
    PyTorch's own) are left out.  A replayed CUDA graph calls no wrapper,
    so this is how its launches are read from the card."""
    out: dict[str, int] = {}
    for name, (n, _) in census.items():
        if "prepare_levels_kernel<" in name:
            k = "prepare_levels"
        elif "render_kernel<" in name:
            mode = int(name.split("<")[1].split(",")[1])
            k = "render_ao_level" if mode == 0 else "render_ao_level_normals"
        elif "upsample_kernel<" in name:
            k = "blur_upsample_step"
        elif "fused_step_kernel<" in name:
            k = "fused_render_upsample_step"
        else:
            continue
        out[k] = out.get(k, 0) + n
    return out

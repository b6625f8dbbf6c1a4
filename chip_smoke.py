#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``tpuao_torch``) on one GPU.

    python3 chip_smoke.py [--parent DIR]

Phases, one or more lines each:

1. build   -- compile ``tpuao_torch/csrc`` with nvcc (sm_90a) and print the
              build time and each kernel's registers, shared memory and
              spills (a spill in the tiled render, upsample, fused,
              zero-copy or DMA kernel fails), and the instructions of one
              pair test in three instances, by kind (``cuobjdump -sass``);
              then ``csrc/selftest.cu``:
              the branch-free reciprocal and division against IEEE, and
              the tangent term's two forms over the slopes and m2 of
              1080p and 4K levels 1-4 (any mismatch of 1 +- rel fails);
2. card    -- the card's name and power limit, from nvidia-smi;
3. kernels -- each CUDA kernel against its plain PyTorch version on the
              card, at the 1080p main path's shapes (max_abs_err <= 1e-5);
4. slice   -- ``render_frame`` on a batch of four 1080p frames under
              ``impl="auto"`` (the main path; its launch counts must be
              prologue 1, render 1, upsample 1, fused 3) and ``"pallas"``,
              held against ``impl="jnp"``; the same call replayed from its
              CUDA graph
              (``models/frame_graph``: captured on the second call),
              bit-equal to the first and held against ``"jnp"``, its
              launches read from the card's kernel records; one 4K frame;
              uint8 output and composite;
5. times   -- ms per 1080p frame for auto / pallas / jnp, and each
              kernel's time beside its plain version's;
5b. prologue -- the prologue kernel (``csrc/prepare.cu``) against its
              plain ops bit for bit (NaN positions too) on hardware depth
              at 1080p, 8 x 1080p and 4K with channel-last normals, and on
              depth 0, 1 and NaN, n_z <= 0.05 and NaN normals in every
              depth mode, depths 1 and 4 and both normals layouts; its
              device and event times at the three cell shapes beside the
              plain ops' and its byte bound (a JSON line
              ``{"prologue": [...]}``);
6. normals and windowed kernels against their plain versions on the card:
              the normals render at levels 1-4 of a 1080p scene in both
              ABIs (slope planes, raw normals) and at levels 1-4 of a 4K
              scene, the windowed resolve at
              the 1080p full- and half-res planes and the 8K plane, with
              displacements past the window and a null history;
7. engine  -- ``AmbientOcclusionEngine(params=preset("ULTRA"))`` on four
              1080p frames with normals under auto and pallas against jnp
              (launch counts asserted), normals vs depth-only, one 4K
              normals frame in both layouts, the tunable sweep;
8. temporal -- ``TemporalAOEngine`` over 1080p dolly sequences at HIGH and
              ULTRA, resolve_level 0 and 1, a static camera, motion
              vectors and unbounded motion, against impl="jnp", with the
              launch counts of every frame asserted;
9. times   -- ms per frame of the ULTRA, 4K-normals and temporal paths,
              and the new kernels beside their plain versions; the
              windowed resolve's library yardstick (grid_sample) on the
              same inputs;
10. variants -- the two kernels no impl reaches, through their entry
              points: render_ao_level_dma at level 1 of 1080p, 4K and 8K,
              fused_render_upsample_step_zc at the 1080p steps 2->1 and
              1->0 and the 4K and 8K steps 1->0, each equal to its sibling
              kernel bit for bit (the render and fused kernels, which are
              held against their plain versions there too), against its
              plain version (the DMA render bit for bit), row_tile
              invariant, timed beside both; the DMA render's device time
              in turns with the render kernel's, their ratio, its bound
              share and its grid;
11. serving -- tpuao_torch.serving on the card (batch_size=4, warmed for
              1080p normals/temporal/temporal_l1) answering direct,
              batched, ULTRA, png, dolly-session (resolve_level 0 and 1),
              mv-session and DELETE requests through the port's client,
              each response equal to the direct render on the card, with
              the launch counts of the run, /stats latency and one
              request's decode/render/encode split;
12. parent -- the kernels at the 1080p, 4K and 8K shapes: the render
              (depth-only, normals) and the DMA render side by side (and
              their ratio), the upsample step (the ULTRA chain of four
              steps at four 1080p frames, the 4K step 1->0 with pre-min,
              HIGH's 4->3 at one frame), the fused and zero-copy steps side
              by side (and their ratio), the windowed resolve at 1080p,
              half res and 8K beside its library yardstick (grid_sample);
              device time per call from CUDA-graph replay, beside
              the computed bound and the roofline share, and the HIGH and
              ULTRA paths at four 1080p frames a call (device time by
              torch.profiler), each beside the same kernels built from an
              older tree's ``tpuao_torch/csrc`` (``--parent DIR``; by
              default ``tpuao_torch/_build/parent_csrc`` where that
              exists), timed in turns (parent, new, new, parent), with
              each kernel's output held against the older one's; then the
              device time by kernel and the idle share of the HIGH path at
              one and four frames a call and of the ULTRA path;
13. cli and views -- ``python -m tpuao_torch`` in-process on 1080p files
              in a temporary directory: the frame (bit-equal to
              render_frame, launches 1/1/3), PNG bytes, colour, ULTRA
              normals (4/4), the debug dump under auto, pallas and fused
              (every leaf equal to the in-memory dict, combined_0's
              interior equal to the cropped step), 8 frames at --batch 4
              (2x the frame's launches), --temporal --camera-path (7
              windowed resolves, equal to TemporalAOEngine), info; then
              render_views_sharded on 8 1080p views, a uniform rig (5
              launches) and one of 4 distinct (FOV, strength) pairs (20),
              every view bit-equal to render_frame with its own scalars,
              colour + uint8 too; host-clock and device times of both;
14. autodiff -- at 1080p: ``ao_loss`` with tunables that require grad
              bit-equal to the plain path's MSE, 0 launches; ``ao_grads``
              (wrt_depth) finite, a non-zero strength gradient, card and
              CPU agreeing at 270x480; examples/calibrate.py's fit (40
              steps) cutting the loss 10x or more, with ms a step, device
              ms, idle share and peak memory; "pallas"/"fused" and every
              wrapper refusing what requires grad;
15. mesh -- ``(cuda:0, cuda:0)`` (and ``make_mesh()`` with more cards):
              8 1080p views (10 launches) and 9 (padded to 10) bit-equal
              to one batch, a 4-pair rig, the temporal fleet of 4
              sequences x 4 frames at resolve_level 0 and 1 (launches
              asserted, each sequence bit-equal to
              render_sequence_temporal), the mesh server answering 4
              concurrent requests, the current device unchanged
              throughout; device ms per view beside one batch's;
16. spatial and grid -- one frame in row bands on meshes naming cuda:0
              several times (and ``make_row_mesh()`` with more cards): 8K
              HIGH on 2 and 4 bands (10 and 20 launches) and 4K ULTRA on 2
              (normals, uint8 colour, every debug leaf), each bit-equal to
              the frame program on the halo-padded frame, cropped; the
              kernels at an 8K band's shapes against their plain
              versions; a 2x2 grid of 4K views and a rig of 2 value sets
              (20 and 40 launches), each view bit-equal to its own spatial
              run; 1080p on 2 bands under impl="auto" and "jnp", each
              bit-equal to its padded monolithic frame, and the kernels
              at the 1080p band's shapes (chain steps <= 3.6e-7); the
              engine's render_spatial; the current device
              unchanged; event and graph-replay device ms and idle share
              of the 8K frame on 2 and 4 bands and of the 4K grid beside
              the monolithic frame, in turns;
17. golden -- each path against the port's float64 golden
              (``tpuao_torch.golden``) computed on the card from the same
              inputs, full frame (max_abs_err <= 1e-4): HIGH 1080p under
              auto and pallas, ULTRA 1080p with normals, VERY_LOW, LOW and
              MEDIUM, single_scale_ao at 720p, HIGH and ULTRA 4K, HIGH 8K
              (with the golden's peak memory), TemporalAOEngine on a 1080p
              dolly at resolve_level 0 and 1 and with motion vectors (each
              step against the golden step from the engine's history, the
              texels within BAND_EPS of a validity boundary masked; the
              whole sequence against the sequence oracle printed), and the
              DMA and zero-copy entry points at level 1 of 1080p; the
              golden on the card against the CPU's at 270x480 (<= 1e-12);
              bench.py's three sampled crops at 4K and 8K against the
              full-frame golden;
18. sections -- one frame in sequential row sections on the card
              (``tpuao_torch.parallel.sections``): 8K HIGH at k = 2, 4, 8
              and in the fused form at k = 2, 4, each bit-equal to the
              monolithic frame and within 1e-4 of the golden, launching k
              times the frame's kernels, its peak memory beside the
              prediction (``sections_peak``), its event and graph-replay
              device ms beside the monolithic frame's, in turns; 4K ULTRA
              with normals and uint8 colour at k = 3 through the engine;
              1080p on 8 sections (a clamped plan: equal to the frame;
              the fused form raises); a 16K-class frame (8640 x 15360) at
              k = 1, 2, 4, 8 against its golden, k = 4 and 8 below the
              monolithic frame's peak memory; ``render --sections 4`` on
              an 8K PFM bit-equal to ``render_frame_sections``;
19. tune   -- the tile rows of the tiled kernels (``utils/launch_opts``):
              the render (depth-only, slopes, raw normals), the upsample
              and the fused steps at every instance of their texels a
              thread at every level of 1080p, 4K and 8K at one and four
              frames a call, each bit-equal to the rule's output (the
              rule's within its bound of the plain version), a value with
              no instance refused (0 at the C entry point), graph-replay
              ms of each instance beside the rule's;
              ``tune`` through the CLI (1080p at one and four frames,
              1440p, 1080p with normals) into one cache, then a fresh
              process rendering a 1440p PFM with ``--autotune-cache``,
              bit-equal to the untuned render with its launches;
              ``stage_times_ms`` of HIGH and ULTRA 1080p beside each
              stage's bound and ``roofline.floors_ms``.

Then a JSON line ``{"golden": [...], "crops": [...]}`` (each path's shape,
max_abs_err and golden seconds), a JSON line ``{"sections": [...]}`` (each
sections path's errors, peak memory and prediction, rows and times), a
JSON line ``{"tile_rows": {...}}`` (phase 19's sweeps, tunes and stage
times), a
JSON line ``{"kernels": [...]}`` (each
kernel's launches on its
path, worst error, device time by graph replay as ``ms`` with the event
time beside it as ``event_ms``, its plain version's event time, computed
bound and library call: grid_sample's device time for the windowed
resolve, none for the rest; ``launches_by_path`` its launches on every
path driven: frame, frame replay (the card's kernel records), ULTRA
engine, temporal, variants, serving, mesh views, fleet at each level,
mesh server, autodiff and the spatial and grid runs and the sections),
the nvidia-smi
line, and last
``{"ok": true, "device": {...}}``.  With no CUDA device, or when any phase
fails, it exits non-zero before printing a result.  It imports neither JAX
nor the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

from tpuao_torch.utils.roofline import (WINDOWED_OPS, bound,
                                        census_by_wrapper, chain_work,
                                        launch_census, prepare_work,
                                        render_work)

TOL = 1e-5  # kernel vs plain version, both float32 on the card
RTOL_NULL_DEPTH = 1e-6  # history depth of a null history (1e6 in float32)
SEED = 7
COUNT_KEYS = ("prepare_levels", "render_ao_level", "render_ao_level_normals",
              "blur_upsample_step", "fused_render_upsample_step",
              "windowed_resolve", "render_ao_level_dma",
              "fused_render_upsample_step_zc")
TOL_SIBLING = 0.0  # the two variants against their sibling kernels: same
                   # arithmetic on the same tap values, so the same bits
TOL_EXACT = 0.0  # render kernels (all three modes) against their plain
                 # versions: every step rounded alike (csrc/common.cuh)
TOL_CHAIN_STEP = 3.6e-7  # a chain step against its plain version on the
                         # same inputs: the worst seen (the ULTRA 1080p chain)
TOL_GOLDEN = 1e-4  # a path (float32) against the float64 golden: the CPU
                   # tests' bound against the golden ([BJ] budget 1e-3)
TOL_GOLDEN_DEVICES = 1e-12  # the golden on the card against the CPU's
BAND_EPS = 1e-3  # texels: a temporal texel this close to a validity
                 # boundary is masked (tests/test_temporal.py's rule)
GOLDEN_SIZES = {"check": (270, 480), "720p": (720, 1280),
                "1080p": (1080, 1920), "4K": (2160, 3840),
                "8K": (4320, 7680)}  # phase 17's frames
SECTION_SIZES = {"1080p": (1080, 1920), "4K": (2160, 3840),
                 "8K": (4320, 7680),
                 "16K": (8640, 15360)}  # phase 18's frames
TUNE_SIZES = {"1080p": (1080, 1920), "4K": (2160, 3840),
              "8K": (4320, 7680)}  # phase 19a's frames
TUNE_INVALID = {"render_ao_level": 3, "render_ao_level_normals": 2,
                "blur_upsample_step": 4,
                "fused_render_upsample_step": 4}  # no such instance
PARENT_CSRC = "tpuao_torch/_build/parent_csrc"

# The bound: the least time the card could take for a call's work, the
# larger of its operations at the FP32 peak and its bytes (each input read
# once, each output written once) at the HBM3 peak; the peaks and the work
# of each kernel (render_work, chain_work, WINDOWED_OPS) are
# tpuao_torch.utils.roofline's.
LIBRARY = ("windowed: torch.nn.functional.grid_sample(bilinear, border, "
           "align_corners=True) on the stacked history, timed as a "
           "yardstick and called nowhere in the port; the rest: none, no "
           "single PyTorch call computes a per-texel 34-pair estimator or a "
           "depth-aware chain step")
# grid_sample against the windowed kernel: it takes (ip, jp) normalised to
# [-1, 1] in float32 and back, which moves a coordinate by up to ~5e-4
# texels at 8K; a texel's value moves by that times its neighbour's step
TOL_LIBRARY = 2e-3


def grid_sample_resolve(prev_ao, prev_d, ip, jp):
    """The windowed resolve's library yardstick: one
    ``F.grid_sample(mode="bilinear", padding_mode="border",
    align_corners=True)`` call on the stacked (prev_ao, prev_d) history at
    (ip, jp) normalised to [-1, 1].  Wherever |ip - i| <= r and
    |jp - j| <= r it computes what the kernel does (the border padding is
    the edge-padded tent sum's clamp).  Returns the call; its inputs are
    formed outside it.  Timed here only: the port never calls it."""
    import torch

    h, w = prev_ao.shape
    src = torch.stack([prev_ao, prev_d])[None]
    grid = torch.stack([jp * (2.0 / (w - 1)) - 1.0,
                        ip * (2.0 / (h - 1)) - 1.0], dim=-1)[None]
    return lambda: torch.nn.functional.grid_sample(
        src, grid, mode="bilinear", padding_mode="border",
        align_corners=True)


def library_error(call, kernel_out) -> float:
    """Max |library - kernel| over both history fields; fails above
    TOL_LIBRARY (a wrong normalisation would be off by far more)."""
    got = call()[0]
    err = max(float((g - k).abs().max()) for g, k in zip(got, kernel_out))
    if not err <= TOL_LIBRARY:
        raise RuntimeError(f"grid_sample yardstick off the windowed kernel "
                           f"by {err}")
    return err


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def short_name(mangled: str) -> str:
    """``_ZN5tpuao13render_kernelILi34ELi0ELi2EE...`` -> ``render_kernel<34,
    0, 2>``."""
    m = re.match(r"_ZN5tpuao(\d+)", mangled)
    if not m:
        return mangled
    n = int(m.group(1))
    name, rest = mangled[m.end():m.end() + n], mangled[m.end() + n:]
    args = re.match(r"I((?:Li-?\d+E)+)E", rest)
    if args:
        name += "<" + ", ".join(re.findall(r"Li(-?\d+)E", args.group(1))) + ">"
    return name


def ptxas_report(log: str) -> list[dict]:
    """Each kernel's registers, shared memory and spilled bytes from the
    build log's ``-Xptxas -v`` lines."""
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            out.append({"name": short_name(m.group(1)), "regs": 0, "smem": 0,
                        "spill": 0})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[-1]["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[-1]["smem"] = int(sm.group(1)) if sm else 0
    return out


# The instances the frame paths spend most of their time in, each with
# its 10-pair twin: the 34-pair instance's count less the 10-pair one's,
# over 24, is one pair (the code around the unrolled pairs is the same).
PAIR_INSTANCES = (("fused_step_kernel<34, 3>", "fused_step_kernel<10, 3>"),
                  ("render_kernel<34, 0, 4>", "render_kernel<10, 0, 4>"),
                  ("render_kernel<34, 1, 1>", "render_kernel<10, 1, 1>"))


def sass_ops(lib: pathlib.Path) -> dict[str, list[str]]:
    """Each kernel's SASS opcodes with their modifiers (``cuobjdump
    -sass``; predicates dropped, NOPs left out), keyed by ``short_name``."""
    from tpuao_torch.ops import _build

    tool = pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out: dict[str, list[str]] = {}
    ops = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            ops = out.setdefault(short_name(m.group(1)), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if m and ops is not None and not m.group(1).startswith("NOP"):
            ops.append(m.group(1))
    return out


def pair_sass(funcs: dict[str, list[str]]) -> dict[str, dict[str, float]]:
    """Instructions of one pair test in each of ``PAIR_INSTANCES``, by
    kind: FADD, FMUL and FFMA with and without ``.SAT``, FMNMX, LDS,
    MUFU, FCHK, branches, and all."""
    def kinds(ops):
        c = collections.Counter()
        for op in ops:
            base = op.split(".")[0]
            if base in ("FADD", "FMUL", "FFMA"):
                c[base + (".SAT" if ".SAT" in op else "")] += 1
            elif base in ("FMNMX", "LDS", "MUFU", "FCHK"):
                c[base] += 1
            elif base in ("BRA", "BRX", "JMP", "CALL", "RET", "BSSY",
                          "BSYNC", "WARPSYNC"):
                c["branch"] += 1
            c["all"] += 1
        return c

    out = {}
    for big, small in PAIR_INSTANCES:
        a, b = kinds(funcs[big]), kinds(funcs[small])
        out[big] = {k: round((a[k] - b[k]) / 24, 2)
                    for k in sorted(set(a) | set(b))}
    return out


def tangent_ranges(widths=(1920, 3840), levels=(1, 2, 3, 4)):
    """The tangent term's operands at the ULTRA parameters and the default
    camera: (m2, x_max) of every pair of both tables at each level of
    each frame width, with x_max = 20 * texel_scale * (|dx| + |dy|), the
    largest |x| the slope clamp n_z >= 0.05 leaves a unit normal."""
    import numpy as np

    from tpuao_torch.models.presets import preset
    from tpuao_torch.ops import kernels as K
    from tpuao_torch.ops import render as R
    from tpuao_torch.params import CameraParams

    cam = CameraParams()
    m2s, x_maxs = [], []
    for w in widths:
        for ex in (True, False):
            par = preset("ULTRA").replace(exhaustive=ex)
            offs = [abs(dx) + abs(dy) for dx, dy, _, _ in
                    R._pair_constants(par)]
            for level in levels:
                ts = R.texel_scale(level, w, cam.tan_half_fov_h)
                m2s.extend(K.tangent_m2(par, level, w, cam))
                x_maxs.extend(20.0 * ts * o for o in offs)
    return (np.asarray(m2s, np.float32), np.asarray(x_maxs, np.float32))


def check_division(lib, dev) -> None:
    """The branch-free reciprocal and division against the IEEE operations
    (csrc/selftest.cu): every float with a normal reciprocal, 2^30
    quotients, and the tangent term's two forms at 2^23 slopes for each
    m2 of ``tangent_ranges``.  Raises on any mismatch but that of a
    tangent term's rel where 1 + rel and 1 - rel agree."""
    import torch

    from tpuao_torch.ops import _build

    m2, x_max = (torch.as_tensor(a, device=dev) for a in tangent_ranges())
    bad = torch.zeros(4, dtype=torch.int64, device=dev)
    _build.check(lib, lib.tpuao_check_division(
        bad.data_ptr(), m2.data_ptr(), x_max.data_ptr(), m2.numel(), 0,
        torch.cuda.current_stream(dev).cuda_stream), "tpuao_check_division")
    n_rcp, n_div, n_e, n_rel = bad.tolist()
    print(f"  rcp_rn vs IEEE reciprocal, 2,113,929,216 floats: {n_rcp} "
          f"mismatches; div_rn vs IEEE division, 2^30 pairs: {n_div}")
    print(f"  tangent term, div_rn vs IEEE, {m2.numel()} m2 of 1080p and 4K "
          f"levels 1-4 x 2^23 slopes: {n_e} mismatches of 1 +- rel "
          f"({n_rel} of rel's own bits: zeros and subnormal quotients)")
    if n_rcp or n_div or n_e:
        raise RuntimeError("the branch-free division differs from IEEE")


class Checks:
    """Worst kernel-vs-plain error per kernel; raises on the first miss."""

    def __init__(self):
        self.worst: dict[str, float] = {}

    def close(self, kernel: str, label, got, want, tol=TOL,
              quiet=False) -> float:
        import torch

        if got.shape != want.shape:
            raise RuntimeError(f"{label}: shape {tuple(got.shape)} != "
                               f"{tuple(want.shape)}")
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"{label}: non-finite values")
        err = float((got.float() - want.float()).abs().max())
        if not quiet:
            print(f"  {label}: max_abs_err={err:.3e}", flush=True)
        if not err <= tol:
            raise RuntimeError(f"{label}: max_abs_err {err} > {tol}")
        if kernel:
            self.worst[kernel] = max(self.worst.get(kernel, 0.0), err)
        return err


def counts(**nonzero) -> dict:
    """A full launch-count dict: the named kernels, every other one 0."""
    out = dict.fromkeys(COUNT_KEYS, 0)
    out.update(nonzero)
    return out


def expect_counts(K, label: str, want: dict) -> None:
    got = K.launch_counts()
    if got != want:
        raise RuntimeError(f"{label}: launches {got} != {want}")


def same_bits(label: str, got, want) -> None:
    """Raise unless ``got`` equals ``want`` value for value with NaN at the
    same texels (a dense float32 output)."""
    import torch

    if (got.shape != want.shape or got.dtype != torch.float32
            or not got.is_contiguous()):
        raise RuntimeError(f"{label}: {got.dtype} {tuple(got.shape)} "
                           f"(contiguous {got.is_contiguous()}) against "
                           f"{tuple(want.shape)}")
    nan = torch.isnan(got)
    if not (torch.equal(nan, torch.isnan(want))
            and torch.equal(got[~nan], want[~nan])):
        raise RuntimeError(f"{label}: differs from the plain ops")


def phase_prologue(chk, dev, K, F, card):
    """5b. The prologue kernel (``csrc/prepare.cu``) against its plain ops,
    bit for bit, NaN positions too: hardware depth at 1080p, 8 x 1080p
    and 4K with channel-last normals (the cells' inputs), then special
    values (depth 0, 1 and NaN, n_z <= 0.05, NaN normals) in every depth
    mode and both normals layouts at 1000x1900; each cell shape timed by
    graph replay and events beside the plain ops and the byte bound.
    Returns ``{"prepare": (event ms, plain event ms, graph ms)}`` of the
    4K frame."""
    import numpy as np
    import torch

    from tpuao_torch.ops import prepare as P
    from tpuao_torch.params import CameraParams, padded_shape
    from tpuao_torch.utils.timing import cuda_graph_ms, cuda_time_ms

    print(f"prologue (csrc/prepare.cu) vs plain ops [{card}]:")
    cam = CameraParams()

    def scene(batch, h, w):
        zn = [F.spheres_on_plane(h, w, cam, seed=SEED + s, with_normals=True)
              for s in range(batch)]
        z = np.stack([F.to_hardware_depth(a, cam) for a, _ in zn])
        n = np.stack([b for _, b in zn])
        z = torch.as_tensor(z.astype(np.float32), device=dev)
        n = torch.as_tensor(n.astype(np.float32), device=dev)
        return (z[0], n[0]) if batch == 1 else (z, n)

    def check(label, z, c, d, nrm):
        hp, wp = padded_shape(*z.shape[-2:])
        K.reset_launch_counts()
        got = K.prepare_levels(z, c, d, hp, wp, nrm)
        expect_counts(K, f"prologue {label}", counts(prepare_levels=1))
        want = P.prepare_levels_plain(z, c, d, hp, wp, nrm)
        for l in range(d + 1):
            same_bits(f"{label} level {l}", got[0][l], want[0][l])
            if nrm is not None and l:
                for g, w in zip(got[1][l], want[1][l]):
                    same_bits(f"{label} slopes {l}", g, w)
        return hp, wp

    rows = []
    for label, batch, (h, w), normals in (
            ("1080p", 1, (1080, 1920), False),
            ("8x1080p", 8, (1080, 1920), False),
            ("4K normals", 1, (2160, 3840), True)):
        z, n = scene(batch, h, w)
        n = n if normals else None
        hp, wp = check(label, z, cam, 4, n)
        kern = lambda: K.prepare_levels(z, cam, 4, hp, wp, n)  # noqa: E731
        plain = lambda: P.prepare_levels_plain(  # noqa: E731
            z, cam, 4, hp, wp, n)
        b_ms, b_by = bound(*prepare_work(batch, h, w, 4, normals))
        r = {"shape": label, "ms": cuda_graph_ms(kern),
             "event_ms": cuda_time_ms(kern),
             "plain_ms": cuda_graph_ms(plain),
             "plain_event_ms": cuda_time_ms(plain), "bound_ms": b_ms,
             "bound_by": b_by,
             "bound_mb": prepare_work(batch, h, w, 4, normals)[1] / 1e6}
        # a call whose bytes fit in the 50 MB L2 finds them there, left by
        # the graph's previous rep: its time is no share of the HBM bound
        r["share_pct"] = (100.0 * b_ms / r["ms"] if r["bound_mb"] > 50.0
                          else None)
        rows.append(r)
        share = ("warm L2" if r["share_pct"] is None else
                 f"{r['share_pct']:.1f} % of it")
        print(f"  {label}: bit-equal; kernel {r['ms']:.4f} ms (device, "
              f"graph replay), {r['event_ms']:.4f} ms (events); plain ops "
              f"{r['plain_ms']:.4f} ms (device), {r['plain_event_ms']:.4f} "
              f"ms (events); bound {b_ms:.4f} ms ({r['bound_mb']:.2f} MB, "
              f"{b_by}), {share} [{card}]", flush=True)
        del z, n
    rng = np.random.default_rng(SEED)
    z = rng.uniform(0.0, 1.0, (2, 1000, 1900)).astype(np.float32)
    nrm = rng.uniform(-1.0, 1.0, (2, 1000, 1900, 3)).astype(np.float32)
    for v in (0.0, 1.0, np.nan):
        z.reshape(-1)[rng.integers(0, z.size, 11)] = v
    nrm.reshape(-1, 3)[rng.integers(0, z.size, 11), 2] = 0.05
    nrm.reshape(-1, 3)[rng.integers(0, z.size, 11),
                       rng.integers(0, 3, 11)] = np.nan
    z = torch.as_tensor(z, device=dev)
    ncl = torch.as_tensor(nrm, device=dev)
    ncf = ncl.movedim(-1, -3).contiguous()
    modes = {"reversed": cam,
             "forward": CameraParams(reversed_z=False, near=0.3, far=40.0),
             "linear": CameraParams(depth_mode="linear")}
    for mode, c in modes.items():
        for d in (1, 4):
            for layout, n in (("none", None), ("channel-last", ncl),
                              ("channel-first", ncf)):
                check(f"1000x1900 x2 {mode} d={d} normals {layout}", z, c,
                      d, n)
    print(f"  special values: depth 0, 1, NaN, n_z 0.05 and NaN normals, "
          f"{len(modes) * 6} cases bit-equal", flush=True)
    print(json.dumps({"prologue": rows}))
    chk.worst["prepare"] = 0.0  # every check above is bit for bit
    four_k = rows[-1]
    return {"prepare": (four_k["event_ms"], four_k["plain_event_ms"],
                        four_k["ms"])}


def phase_new_kernels(chk, dev, K, P, R, T, F, cam, h0, w0, hp, wp):
    """6. The normals render (both ABIs) and the windowed resolve against
    their plain versions at the shapes the 1080p paths give them."""
    import numpy as np
    import torch

    from tpuao_torch.params import AOParams

    print("normals and windowed kernels vs plain (seed %d):" % SEED)
    z, n = F.spheres_on_plane(h0, w0, cam, seed=SEED, with_normals=True)
    zt = torch.as_tensor(z, dtype=torch.float32, device=dev)
    nt = torch.as_tensor(n, dtype=torch.float32, device=dev)
    zp = torch.nn.functional.pad(zt[None], (0, wp - w0, 0, hp - h0),
                                 mode="replicate")[0]
    pyr = [lvl.contiguous() for lvl in P.build_pyramid(zp, 4)]
    spyr = R.slope_pyramid(nt, cam.tan_half_fov_h, hp, wp, 4, h0=h0, w0=w0)
    npyr = R.normals_pyramid(nt, hp, wp, 4)
    for ex in (True, False):
        par = AOParams(use_normals=True, exhaustive=ex)
        for abi, pyr_n in (("slopes", spyr), ("normals", npyr)):
            kw = [{"slopes_ds": g} if abi == "slopes" else {"normals_ds": g}
                  for g in pyr_n]
            for l in range(1, 5):
                chk.close("render_normals",
                          f"render_normals {abi} l{l} "
                          f"{tuple(pyr[l].shape)} exhaustive={ex}",
                          K.render_ao_level_normals(pyr[l], l, wp, cam, par,
                                                    **kw[l]),
                          K.render_ao_level_normals_plain(
                              pyr[l], l, wp, cam, par, **kw[l]),
                          tol=TOL_EXACT)
    pyr4, spyr4, npyr4, wp4 = normals_pyramid(dev, P, R, F, cam, 2160, 3840)
    par = AOParams(use_normals=True)
    for l in range(1, 5):
        for abi, kw in (("slopes", {"slopes_ds": spyr4[l]}),
                        ("normals", {"normals_ds": npyr4[l]})):
            chk.close("render_normals", f"render_normals {abi} 4K l{l} "
                      f"{tuple(pyr4[l].shape)}",
                      K.render_ao_level_normals(pyr4[l], l, wp4, cam, par,
                                                **kw),
                      K.render_ao_level_normals_plain(pyr4[l], l, wp4, cam,
                                                      par, **kw),
                      tol=TOL_EXACT)
    del pyr4, spyr4, npyr4
    rng = np.random.default_rng(SEED)
    for (h, w), r in (((h0, w0), 4), ((h0 // 2, w0 // 2), 2),
                      ((4320, 7680), 4)):
        ii = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        jj = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
        prev_ao = torch.as_tensor(rng.uniform(0.0, 1.0, (h, w)),
                                  dtype=torch.float32, device=dev)
        prev_d = torch.as_tensor(rng.uniform(0.05, 1.0, (h, w)),
                                 dtype=torch.float32, device=dev)
        ip = (ii + (torch.rand(h, w, device=dev) * 2 - 1) * (r + 2))
        jp = (jj + (torch.rand(h, w, device=dev) * 2 - 1) * (r + 2))
        ip[0, :4] = torch.tensor([-r - 1.5, r + 1.0, 0.0, r + 0.25])
        got = K.windowed_resolve(prev_ao, prev_d, ip, jp, r)
        want = K.windowed_resolve_plain(prev_ao, prev_d, ip, jp, r)
        for f, g, wv in zip(("ao", "depth"), got, want):
            chk.close("windowed", f"windowed {f} ({h}, {w}) r={r}", g, wv)
        null_ao, null_d = T.initial_state(h, w, device=dev)
        got = K.windowed_resolve(null_ao, null_d, ip, jp, r)
        want = K.windowed_resolve_plain(null_ao, null_d, ip, jp, r)
        chk.close("windowed", f"windowed null-history ao ({h}, {w}) r={r}",
                  got[0], want[0])
        rel = float(((got[1] - want[1]).abs() / want[1].abs().clamp(min=1.0)
                     ).max())
        print(f"  windowed null-history depth ({h}, {w}) r={r}: "
              f"max_rel_err={rel:.3e}", flush=True)
        if not rel <= RTOL_NULL_DEPTH:
            raise RuntimeError(f"null-history depth rel err {rel}")
        del prev_ao, prev_d, ip, jp, got, want, null_ao, null_d
    torch.cuda.empty_cache()
    return pyr, spyr


def phase_engine(chk, dev, K, F, cam, h0, w0):
    """7. The ULTRA engine on four 1080p frames; returns the inputs the
    timing phase reuses and the main path's launch counts."""
    import numpy as np
    import torch

    from tpuao_torch.models.pipeline import AmbientOcclusionEngine
    from tpuao_torch.models.presets import preset
    from tpuao_torch.ops import _build

    print("engine (ULTRA, normals):")
    zn = [F.spheres_on_plane(h0, w0, cam, seed=s, with_normals=True)
          for s in range(4)]
    z4 = torch.as_tensor(np.stack([a for a, _ in zn]), dtype=torch.float32,
                         device=dev)
    n4 = torch.as_tensor(np.stack([b for _, b in zn]), dtype=torch.float32,
                         device=dev)
    engines = {impl: AmbientOcclusionEngine(cam, preset("ULTRA"), impl=impl)
               for impl in ("auto", "pallas", "jnp")}
    torch.cuda.synchronize()
    K.reset_launch_counts()
    out_auto = engines["auto"].render(z4, normals=n4)
    torch.cuda.synchronize()
    main_counts = K.launch_counts()
    print(f"  main path, batch (4, {h0}, {w0}) ULTRA auto: launches "
          f"{main_counts}")
    expect_counts(K, "ULTRA auto", counts(prepare_levels=1,
                                          render_ao_level_normals=4,
                                          blur_upsample_step=4))
    if K.render_ao_level_normals.raw_launches != 0:
        raise RuntimeError("ULTRA auto took the raw-normals ABI")
    K.reset_launch_counts()
    out_pallas = engines["pallas"].render(z4, normals=n4)
    expect_counts(K, "ULTRA pallas", counts(prepare_levels=1,
                                            render_ao_level_normals=4,
                                            blur_upsample_step=4))
    if K.render_ao_level_normals.raw_launches != 4:
        raise RuntimeError("ULTRA pallas did not take the raw-normals ABI "
                           f"({K.render_ao_level_normals.raw_launches})")
    K.reset_launch_counts()
    out_jnp = engines["jnp"].render(z4, normals=n4)
    expect_counts(K, "ULTRA jnp", counts())
    chk.close("", "ULTRA batch 4x1080p auto vs jnp", out_auto, out_jnp)
    chk.close("", "ULTRA batch 4x1080p pallas vs jnp", out_pallas, out_jnp)
    plain = AmbientOcclusionEngine(cam, preset("HIGH")).render(z4)
    diff = float((out_auto - plain).abs().max())
    print(f"  normals vs depth-only: max diff {diff:.3e}")
    if not diff > 1e-3:
        raise RuntimeError(f"normals output equals depth-only ({diff})")
    z4k, n4k = F.spheres_on_plane(2160, 3840, cam, seed=SEED,
                                  with_normals=True)
    d4k = torch.as_tensor(z4k, dtype=torch.float32, device=dev)
    n4k_cl = torch.as_tensor(n4k, dtype=torch.float32, device=dev)
    n4k_cf = n4k_cl.permute(2, 0, 1).contiguous()
    want4k = engines["jnp"].render(d4k, normals=n4k_cl)
    for layout, nn in (("channel-last", n4k_cl), ("channel-first", n4k_cf)):
        chk.close("", f"ULTRA 4K {layout} auto vs jnp",
                  engines["auto"].render(d4k, normals=nn), want4k)
    lib = _build.load()
    built = sorted(_build.BUILD_DIR.glob("*.so"))
    eng, ref = engines["auto"], engines["jnp"]
    for s_, r_, b_ in ((0.5, 1.5, -7.0), (2.0, 5.0, -3.0), (4.0, 9.0, -1.5)):
        for e in (eng, ref):
            e.strength, e.rejection_falloff, e.blur_tolerance = s_, r_, b_
        chk.close("", f"ULTRA sweep strength={s_} falloff={r_} blur={b_}",
                  eng.render(z4[0], normals=n4[0]),
                  ref.render(z4[0], normals=n4[0]))
    if _build.load() is not lib or sorted(_build.BUILD_DIR.glob("*.so")) \
            != built:
        raise RuntimeError("the tunable sweep rebuilt the library")
    print("  tunable sweep: 3 settings, no rebuild")
    return z4, n4, d4k, n4k_cl, main_counts


def dolly_frames(F, cam, h0, w0, t_n):
    """1080p frames of a static world from an eye moving along x and z,
    with normals, and the world->eye view matrix of each."""
    import numpy as np

    frames, views = [], []
    for t in range(t_n):
        eye = (0.05 * t, 0.0, 0.04 * t)
        z, n = F.spheres_on_plane(h0, w0, cam, seed=SEED, with_normals=True,
                                  eye=eye)
        v = np.eye(4)
        v[:3, 3] = [-e for e in eye]
        frames.append((z.astype(np.float32), n.astype(np.float32)))
        views.append(v)
    return frames, views


def phase_temporal(chk, dev, K, F, cam, h0, w0):
    """8. TemporalAOEngine over 1080p sequences against impl="jnp", with
    every frame's launch counts; returns what the timing phase reuses and
    the launch counts of the main temporal run (HIGH, moving camera,
    resolve_level 0)."""
    import numpy as np
    import torch

    from tpuao_torch.models.pipeline import (TemporalAOEngine, render_frame,
                                             render_frame_temporal)
    from tpuao_torch.models.presets import preset
    from tpuao_torch.params import TemporalParams

    print("temporal (TemporalAOEngine, 1080p dolly):")
    t_n = 8
    frames, views = dolly_frames(F, cam, h0, w0, t_n)
    dz = [torch.as_tensor(z, device=dev) for z, _ in frames]
    dn = [torch.as_tensor(n, device=dev) for _, n in frames]
    high = {0: counts(prepare_levels=1, render_ao_level=1,
                      blur_upsample_step=1, fused_render_upsample_step=3),
            1: counts(prepare_levels=1, render_ao_level=2,
                      blur_upsample_step=2, fused_render_upsample_step=2)}
    ultra = counts(prepare_levels=1, render_ao_level_normals=4,
                   blur_upsample_step=4)
    main_total = None
    # a static camera over a noisy depth buffer, and a 1.5-pixel pan given
    # as motion vectors
    gen = torch.Generator(device=dev).manual_seed(SEED)
    noisy = [(dz[0] + 2e-3 * torch.randn(dz[0].shape, generator=gen,
                                         device=dev)).clamp(1e-3, 1.0)
             for _ in range(3)]
    mv = torch.zeros(h0, w0, 2, device=dev)
    mv[..., 1] = -1.5
    cases = [  # (label, preset, resolve_level, motion kind, frames)
        ("HIGH moving", "HIGH", 0, "view", dz),
        ("HIGH moving", "HIGH", 1, "view", dz),
        ("ULTRA moving", "ULTRA", 0, "view", dz),
        ("ULTRA moving", "ULTRA", 1, "view", dz),
        ("HIGH static", "HIGH", 0, None, noisy),
        ("HIGH static", "HIGH", 1, None, noisy),
        ("HIGH motion vectors", "HIGH", 0, "mv", dz[:3]),
    ]
    for label, name, rl, kind, seq in cases:
        par = preset(name)
        eng = TemporalAOEngine(cam, par, resolve_level=rl)
        ref = TemporalAOEngine(cam, par, impl="jnp", resolve_level=rl)
        base = ultra if name == "ULTRA" else high[rl]
        worst, total = 0.0, counts()
        for t, depth in enumerate(seq):
            kw = {"normals": dn[t]} if name == "ULTRA" else {}
            if kind == "view":
                kw["view"] = views[t]
            elif kind == "mv" and t > 0:
                kw["motion"] = mv
            torch.cuda.synchronize()
            K.reset_launch_counts()
            got = eng.render(depth, **kw)
            torch.cuda.synchronize()
            moving = kind is not None and t > 0
            expect_counts(K, f"{label} rl={rl} frame {t}",
                          {**base, "windowed_resolve": int(moving)})
            total = {k: total[k] + v for k, v in K.launch_counts().items()}
            want = ref.render(depth, **kw)
            worst = max(worst, chk.close("", None, got, want, quiet=True))
            if t > 0:  # the history is used: not the single-frame AO
                single = render_frame(depth, cam, par,
                                      normals=kw.get("normals"))
                if not float((got - single).abs().max()) > 1e-4:
                    raise RuntimeError(f"{label} rl={rl} frame {t}: equals "
                                       "the single-frame AO (no history)")
        print(f"  {label} resolve_level={rl}, {len(seq)} frames: "
              f"auto vs jnp max_abs_err={worst:.3e}, launches {total}",
              flush=True)
        if (label, rl) == ("HIGH moving", 0):
            main_total = total
    # unbounded motion: the history sample is a plain gather, no kernel
    tp = TemporalParams(max_displacement=None)
    m = np.eye(4)
    m[0, 3] = 0.3
    st = (torch.rand(h0, w0, device=dev), dz[0].clone())
    K.reset_launch_counts()
    a, _ = render_frame_temporal(dz[1], st, cam, preset("HIGH"), tp, motion=m)
    expect_counts(K, "max_displacement=None", high[0])
    b, _ = render_frame_temporal(dz[1], st, cam, preset("HIGH"), tp,
                                 motion=m, impl="jnp")
    chk.close("", "max_displacement=None frame auto vs jnp", a, b)
    # the null history: the resolved AO is the frame's own, exactly
    a, _ = render_frame_temporal(dz[1], None, cam, preset("HIGH"), motion=m)
    chk.close("", "null-history frame == single-frame AO (exact)", a,
              render_frame(dz[1], cam, preset("HIGH")), tol=0.0)
    return dz, dn, views, main_total


def phase_times_new(card, K, cam, wp, pyr, spyr, z4, n4, d4k, n4k, dz, dn,
                    views):
    """9. ms per frame of the new paths and the new kernels beside their
    plain versions at the shapes the paths give them."""
    import torch

    from tpuao_torch.models.pipeline import (AmbientOcclusionEngine,
                                             render_frame_temporal)
    from tpuao_torch.models.presets import preset
    from tpuao_torch.params import AOParams, TemporalParams
    from tpuao_torch.utils.camera import relative_motion
    from tpuao_torch.utils.timing import cuda_graph_ms, cuda_time_ms

    print(f"times, new paths [{card}]:")
    ultra = AmbientOcclusionEngine(cam, preset("ULTRA"))
    ms = {}
    ms["ULTRA 1080p, 1 frame per call"] = cuda_time_ms(
        lambda: ultra.render(z4[:1], normals=n4[:1]))
    ms["ULTRA 1080p, 4 frames per call (per frame)"] = cuda_time_ms(
        lambda: ultra.render(z4, normals=n4)) / 4
    ms["ULTRA 4K (2160x3840)"] = cuda_time_ms(
        lambda: ultra.render(d4k, normals=n4k))
    m = relative_motion(views[0], views[1])
    tp = TemporalParams()
    for rl in (0, 1):
        prev_d = (dz[0] if rl == 0 else dz[0][::2, ::2]).contiguous()
        st = (torch.full_like(prev_d, 0.9), prev_d)
        for name in ("HIGH", "ULTRA"):
            nrm = dn[1] if name == "ULTRA" else None
            ms[f"temporal {name} 1080p moving, resolve_level={rl}"] = \
                cuda_time_ms(lambda st=st, rl=rl, name=name, nrm=nrm:
                             render_frame_temporal(
                                 dz[1], st, cam, preset(name), tp, motion=m,
                                 normals=nrm, resolve_level=rl))
    for k, v in ms.items():
        print(f"  {k}: {v:.4f} ms/frame [{card}]", flush=True)
    par = AOParams(use_normals=True)

    def normals_levels(fn):  # one ULTRA frame's four renders
        for l in range(1, 5):
            fn(pyr[l], l, wp, cam, par, slopes_ds=spyr[l])

    def coords(x, di, dj):  # (ip, jp) displaced by (di, dj) texels
        h, w = x.shape
        ii = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
        jj = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
        return ((ii + di).expand(h, w).contiguous(),
                (jj + dj).expand(h, w).contiguous())

    ip, jp = coords(dz[0], 1.3, -2.7)
    half = [x[::2, ::2].contiguous() for x in (dz[0], dz[1])]
    iph, jph = coords(half[0], 0.6, -1.3)
    big = [torch.rand(4320, 7680, device=dz[0].device) for _ in range(2)]
    ipb, jpb = coords(big[0], 1.3, -2.7)
    timed = {
        "render_normals": (
            lambda: normals_levels(K.render_ao_level_normals),
            lambda: normals_levels(K.render_ao_level_normals_plain)),
        "windowed": (
            lambda: K.windowed_resolve(dz[0], dz[1], ip, jp, 4),
            lambda: K.windowed_resolve_plain(dz[0], dz[1], ip, jp, 4)),
        "windowed half-res (r=2)": (
            lambda: K.windowed_resolve(half[0], half[1], iph, jph, 2),
            lambda: K.windowed_resolve_plain(half[0], half[1], iph, jph, 2)),
        "windowed 8K (4320x7680, r=4)": (
            lambda: K.windowed_resolve(big[0], big[1], ipb, jpb, 4),
            lambda: K.windowed_resolve_plain(big[0], big[1], ipb, jpb, 4)),
    }
    kms = {}
    for name, (kern, plain) in timed.items():
        kms[name] = (cuda_time_ms(kern), cuda_time_ms(plain),
                     cuda_graph_ms(kern))
        print(f"  {name}: kernel {kms[name][0]:.4f} ms (events), "
              f"{kms[name][2]:.4f} ms (device, graph replay), plain "
              f"{kms[name][1]:.4f} ms (events) [{card}]", flush=True)
    # the windowed kernel's library yardstick on the same inputs
    lib = grid_sample_resolve(dz[0], dz[1], ip, jp)
    err = library_error(lib, K.windowed_resolve(dz[0], dz[1], ip, jp, 4))
    kms["windowed library"] = cuda_graph_ms(lib)
    print(f"  windowed library call (grid_sample): "
          f"{kms['windowed library']:.4f} ms (device, graph replay), "
          f"max |library - kernel| {err:.3e} [{card}]", flush=True)
    return kms


def normals_pyramid(dev, P, R, F, cam, h0, w0, batch=1):
    """Levels 0-4 of a sphere scene with normals, padded to 64, with the
    slope planes and the raw normals of each level; ``batch`` copies of
    the frame along a leading axis."""
    import torch

    from tpuao_torch.params import padded_shape

    hp, wp = padded_shape(h0, w0)
    z, n = F.spheres_on_plane(h0, w0, cam, seed=SEED, with_normals=True)
    zt = torch.as_tensor(z, dtype=torch.float32, device=dev)
    nt = torch.as_tensor(n, dtype=torch.float32, device=dev)
    zp = torch.nn.functional.pad(zt[None], (0, wp - w0, 0, hp - h0),
                                 mode="replicate")[0]
    pyr = P.build_pyramid(zp, 4)
    spyr = R.slope_pyramid(nt, cam.tan_half_fov_h, hp, wp, 4, h0=h0, w0=w0)
    npyr = R.normals_pyramid(nt, hp, wp, 4)

    def rep(x):
        return (torch.stack([x] * batch) if batch > 1 else x).contiguous()

    return ([rep(x) for x in pyr], [tuple(rep(g) for g in gs) for gs in spyr],
            [rep(x) for x in npyr], wp)


def level_pyramid(dev, P, F, cam, h0, w0):
    """Levels 0-4 of a sphere scene's linear depth, padded to 64."""
    import torch

    from tpuao_torch.params import padded_shape

    hp, wp = padded_shape(h0, w0)
    z = torch.as_tensor(F.spheres_on_plane(h0, w0, cam, seed=SEED),
                        dtype=torch.float32, device=dev)
    zp = torch.nn.functional.pad(z[None], (0, wp - w0, 0, hp - h0),
                                 mode="replicate")[0]
    return [lvl.contiguous()
            for lvl in P.build_pyramid(P.linearize_depth(zp, cam), 4)], wp


def chain_inputs(K, cam, par, pyr, wp):
    """The combined AO from below at levels 3, 2, 1 of a depth-only
    pyramid (what the fused steps 3->2, 2->1, 1->0 take), by the
    kernels."""
    c = {3: K.blur_upsample_step(K.render_ao_level(pyr[4], 4, wp, cam, par),
                                 pyr[4], pyr[3], par, wp)}
    for l in (3, 2):
        c[l - 1] = K.fused_render_upsample_step(pyr[l], c[l], pyr[l - 1], l,
                                                wp, cam, par)
    return c


def phase_variants(chk, dev, K, P, F, cam, card, pyr1080, c_in1080):
    """10. The two kernels without an impl of their own, through their
    entry points: the double-buffered render at level 1 of 1080p, 4K and
    8K, the zero-copy step at the 1080p steps 2->1 and 1->0 and the 4K
    and 8K steps 1->0.  Held against their sibling kernels (bit for bit),
    which are held against their plain versions there too, and against
    their plain versions; returns the entry-point run's launch counts and
    the times."""
    import torch

    from tpuao_torch.params import AOParams
    from tpuao_torch.utils.timing import cuda_graph_ms, cuda_time_ms

    print(f"variants (render_ao_level_dma, fused_render_upsample_step_zc) "
          f"[{card}]:")
    par = AOParams()
    pyr4k, wp4k = level_pyramid(dev, P, F, cam, 2160, 3840)
    pyr8k, wp8k = level_pyramid(dev, P, F, cam, 4320, 7680)
    c = chain_inputs(K, cam, par, pyr4k, wp4k)[1]
    c8 = chain_inputs(K, cam, par, pyr8k, wp8k)[1]
    dma_in = {"1080p": (pyr1080[1], 1920), "4K": (pyr4k[1], wp4k),
              "8K": (pyr8k[1], wp8k)}
    zc_in = {"1080p 2->1": (pyr1080[2], c_in1080[2], pyr1080[1], 2, 1920,
                            None),
             "1080p 1->0": (pyr1080[1], c_in1080[1], pyr1080[0], 1, 1920,
                            (1080, 1920)),
             "4K 1->0": (pyr4k[1], c, pyr4k[0], 1, wp4k, (2160, 3840)),
             "8K 1->0": (pyr8k[1], c8, pyr8k[0], 1, wp8k, (4320, 7680))}
    torch.cuda.synchronize()
    K.reset_launch_counts()
    dma_out = {k: K.render_ao_level_dma(d, 1, fw, cam, par)
               for k, (d, fw) in dma_in.items()}
    zc_out = {k: K.fused_render_upsample_step_zc(ds, c1, hi, l, fw, cam, par,
                                                 crop_hw=crop)
              for k, (ds, c1, hi, l, fw, crop) in zc_in.items()}
    torch.cuda.synchronize()
    run = K.launch_counts()
    print(f"  entry-point run: launches {run}")
    expect_counts(K, "variants", counts(render_ao_level_dma=3,
                                        fused_render_upsample_step_zc=4))
    ms, graph = {}, {}
    for k, (d, fw) in dma_in.items():
        label = f"dma {k} level 1 {tuple(d.shape)}"
        rk = K.render_ao_level(d, 1, fw, cam, par)
        chk.close("", f"{label} vs render kernel", dma_out[k], rk,
                  tol=TOL_SIBLING)
        chk.close("render", f"render {k} level 1 {tuple(d.shape)} vs plain",
                  rk, K.render_ao_level_plain(d, 1, fw, cam, par),
                  tol=TOL_EXACT)
        chk.close("dma", f"{label} vs plain", dma_out[k],
                  K.render_ao_level_plain(d, 1, fw, cam, par), tol=TOL_EXACT)
        for rt in (1, 16, 37, 4096):
            chk.close("", f"{label} row_tile={rt} vs row_tile=128",
                      K.render_ao_level_dma(d, 1, fw, cam, par, row_tile=rt),
                      dma_out[k], tol=0.0, quiet=True)
        fns = {"dma": lambda: K.render_ao_level_dma(d, 1, fw, cam, par),
               "render": lambda: K.render_ao_level(d, 1, fw, cam, par)}
        ms[k] = tuple(cuda_time_ms(f) for f in (
            fns["dma"], fns["render"],
            lambda: K.render_ao_level_plain(d, 1, fw, cam, par)))
        g = {}
        for which in ("render", "dma", "dma", "render"):  # in turns
            g.setdefault(which, []).append(cuda_graph_ms(fns[which]))
        graph[k] = sum(g["dma"]) / 2
        b_ms, b_by = bound(*render_work(d.shape))
        h, w = d.shape
        seg = K.dma_rows(128, 1, h, w)
        print(f"  {label}: dma {g['dma'][0]:.4f} / {g['dma'][1]:.4f} ms, "
              f"render kernel {g['render'][0]:.4f} / {g['render'][1]:.4f} "
              f"ms (device, graph replay), dma / render "
              f"{sum(g['dma']) / sum(g['render']):.3f}x, bound {b_ms:.4f} "
              f"ms ({b_by}), roofline share {b_ms / graph[k]:.1%}; "
              f"{seg}-row segments, {K.dma_nt(seg)} texels a thread, "
              f"{-(-w // 64) * -(-h // seg)} blocks; events: dma "
              f"{ms[k][0]:.4f}, render {ms[k][1]:.4f}, plain {ms[k][2]:.4f} "
              f"ms [{card}]", flush=True)
    for k, (ds, c1, hi, l, fw, crop) in zc_in.items():
        label = f"zc {k} {tuple(ds.shape)} crop={crop}"
        args = (ds, c1, hi, l, fw, cam, par)
        fk = K.fused_render_upsample_step(*args, crop_hw=crop)
        chk.close("", f"{label} vs fused kernel", zc_out[k], fk,
                  tol=TOL_SIBLING)
        want = K.fused_render_upsample_step_plain(*args, crop_hw=crop)
        chk.close("zc", f"{label} vs plain", zc_out[k], want)
        chk.close("fused", f"fused {k} {tuple(ds.shape)} vs plain", fk, want)
        del fk, want
        for rt in (40, 100, 4096):
            chk.close("", f"{label} row_tile={rt} vs row_tile=64",
                      K.fused_render_upsample_step_zc(*args, row_tile=rt,
                                                      crop_hw=crop),
                      zc_out[k], tol=0.0, quiet=True)
        ms[k] = tuple(cuda_time_ms(f) for f in (
            lambda: K.fused_render_upsample_step_zc(*args, crop_hw=crop),
            lambda: K.fused_render_upsample_step(*args, crop_hw=crop),
            lambda: K.fused_render_upsample_step_plain(*args,
                                                       crop_hw=crop)))
        print(f"  {label}: zc {ms[k][0]:.4f} ms, fused kernel "
              f"{ms[k][1]:.4f} ms, plain {ms[k][2]:.4f} ms [{card}]",
              flush=True)
    print("  row_tile invariance: dma 4 settings, zc 3, exact")
    ds, c1, hi, l, fw1, crop = zc_in["1080p 1->0"]
    graph["zc"] = cuda_graph_ms(
        lambda: K.fused_render_upsample_step_zc(ds, c1, hi, l, fw1, cam, par,
                                                crop_hw=crop))
    print(f"  1080p 1->0 zc {graph['zc']:.4f} ms (device, graph replay) "
          f"[{card}]")
    del pyr4k, pyr8k, c, c8, dma_in, zc_in, dma_out, zc_out, d, ds, c1, hi
    torch.cuda.empty_cache()
    return run, {"dma": (ms["1080p"][0], ms["1080p"][2], graph["1080p"]),
                 "zc": (ms["1080p 1->0"][0], ms["1080p 1->0"][2],
                        graph["zc"])}


def phase_serving(chk, dev, K, F, cam, card):
    """11. The port's HTTP server on the card, in-process on 127.0.0.1:0,
    batch_size=4, warmed for 1080p normals/temporal/temporal_l1, driven
    through the port's client.  Every response is held against the same
    frame rendered directly on the card (exact: same kernels, same
    inputs, float32 PFM round-trips exactly); the launch counts around
    the requests show the kernels ran.  Returns the serving run's counts."""
    import statistics
    import threading

    import numpy as np
    import torch

    from tpuao_torch.client import AOClient
    from tpuao_torch.models.pipeline import (AmbientOcclusionEngine,
                                             TemporalAOEngine, render_frame)
    from tpuao_torch.models.presets import preset
    from tpuao_torch.params import AOParams
    from tpuao_torch.serving import make_server, warm_server
    from tpuao_torch.utils.batching import to_host
    from tpuao_torch.utils.frameio import dumps_pfm, loads_pfm_multi
    from tpuao_torch.utils.io import encode_ao_png

    print(f"serving (tpuao_torch.serving on cuda, batch_size=4) [{card}]:")
    h0, w0 = 1080, 1920
    srv = make_server(0, batch_size=4, device="cuda")
    t0 = time.perf_counter()
    warmed = warm_server(srv, (h0, w0), ["normals", "temporal",
                                         "temporal_l1"])
    print(f"  warm_server: {len(warmed)} paths in "
          f"{time.perf_counter() - t0:.2f} s: {', '.join(warmed)}",
          flush=True)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        client = AOClient(f"http://127.0.0.1:{srv.server_address[1]}",
                          retries=0)
        client.wait_ready(timeout=30.0, interval=0.1)
        scenes = [F.spheres_on_plane(h0, w0, cam, seed=s, with_normals=True)
                  for s in range(4)]
        zs = [z.astype(np.float32) for z, _ in scenes]
        nrm = scenes[0][1].astype(np.float32)
        on = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        frames, views = dolly_frames(F, cam, h0, w0, 8)
        mv = np.zeros((h0, w0, 2), np.float32)
        mv[..., 1] = -1.5
        torch.cuda.synchronize()
        K.reset_launch_counts()
        # 4 stateless requests on the direct route, with tunables
        tun = [{"strength": 1.0 + 0.5 * i, "rejection_falloff": 2.0 + i}
               for i in range(4)]
        direct = [client.render(z, **t) for z, t in zip(zs, tun)]
        batched = client.render_many(zs, workers=4)  # 4 concurrent
        ultra = client.render(zs[0], normals=nrm)
        png = client.render(zs[1], out="png")
        dolly = {}
        for rl in (0, 1):
            with client.session(f"dolly{rl}", resolve_level=rl) as ses:
                dolly[rl] = [ses.render(z, view=v)
                             for (z, _), v in zip(frames, views)]
                if ses.last_frame_index != 7:
                    raise RuntimeError(f"dolly rl={rl}: last frame index "
                                       f"{ses.last_frame_index}")
        ses = client.session("mv")
        mv_out = [ses.render(z, mv=None if t == 0 else mv)
                  for t, (z, _) in enumerate(frames[:3])]
        if client.stats()["sessions"] != 1:
            raise RuntimeError("the mv session is not in the table")
        ses.close()  # DELETE /session/mv
        torch.cuda.synchronize()
        run = K.launch_counts()
        print(f"  serving run (4 direct, 4 batched, 1 ULTRA, 1 png, 2x8 "
              f"dolly, 3 mv, 1 DELETE): launches {run}", flush=True)
        need = ("render_ao_level", "blur_upsample_step",
                "fused_render_upsample_step", "render_ao_level_normals",
                "windowed_resolve")
        if any(run[k] < 1 for k in need):
            raise RuntimeError(f"the serving path skipped a kernel: {run}")
        stats = client.stats()
        if (stats["sessions"], stats["errors"], stats["ok"]) != (0, 0, 29):
            raise RuntimeError(f"server stats {stats}")
        b = stats["batcher"]
        if b["frames"] + b["padded"] != sum(int(r) * n for r, n in
                                            b["rung_flushes"].items()):
            raise RuntimeError(f"batcher stats {b}")
        # every response against the direct render on the card
        eng = AmbientOcclusionEngine(cam)
        for i, (z, t) in enumerate(zip(zs, tun)):
            want = render_frame(on(z), cam, AOParams(**t))
            chk.close("", f"direct request {i} {t}", on(direct[i]), want,
                      tol=0.0, quiet=i > 0)
            chk.close("", f"batched request {i}", on(batched[i]),
                      eng.render(on(z)), tol=0.0, quiet=i > 0)
        want = AmbientOcclusionEngine(cam, preset("ULTRA")).render(
            on(zs[0]), normals=on(nrm))
        chk.close("", "ULTRA normals request", on(ultra), want, tol=0.0)
        if png != encode_ao_png(to_host(eng.render(on(zs[1])))):
            raise RuntimeError("out=png bytes differ from the direct render")
        print("  out=png request: bytes equal the direct render's")
        for rl in (0, 1):
            ref = TemporalAOEngine(cam, resolve_level=rl)
            worst = max(float((on(got) - ref.render(on(z), view=v)).abs()
                              .max())
                        for got, (z, _), v in zip(dolly[rl], frames, views))
            print(f"  dolly session, 8 frames, resolve_level={rl}: "
                  f"max_abs_err={worst:.3e}")
            if worst != 0.0:
                raise RuntimeError(f"dolly rl={rl} differs: {worst}")
        ref = TemporalAOEngine(cam)
        for t, (z, _) in enumerate(frames[:3]):
            chk.close("", f"mv session frame {t}", on(mv_out[t]),
                      ref.render(on(z), motion=None if t == 0 else on(mv)),
                      tol=0.0)
        lat = stats["latency_ms"]
        print(f"  /stats latency over {lat['count']} requests: p50 "
              f"{lat['p50']} ms, p95 {lat['p95']} ms, max {lat['max']} ms; "
              f"batcher {b} [{card}]", flush=True)
        # one 1080p request's host split, measured around the calls
        body = dumps_pfm(zs[2])
        split = {"decode": [], "render": [], "encode": [], "request": []}
        for _ in range(7):
            t0 = time.perf_counter()
            (depth,) = loads_pfm_multi(body)
            t1 = time.perf_counter()
            ao = to_host(render_frame(srv.to_device(depth), cam,
                                      AOParams(strength=1.5)))
            t2 = time.perf_counter()
            dumps_pfm(ao)
            t3 = time.perf_counter()
            client.render(zs[2], strength=1.5)
            t4 = time.perf_counter()
            for k, v in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                split[k].append(v * 1e3)
        med = {k: statistics.median(v) for k, v in split.items()}
        print(f"  one 1080p request, median of 7: decode "
              f"{med['decode']:.3f} ms, upload+render+download "
              f"{med['render']:.3f} ms, encode {med['encode']:.3f} ms; "
              f"whole request through the client {med['request']:.3f} ms "
              f"[{card}]", flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    torch.cuda.empty_cache()
    return run


def run_cli(argv) -> None:
    """``tpuao_torch.cli.main`` in-process, as ``python -m tpuao_torch``
    runs it; raises unless it exits 0."""
    from tpuao_torch import cli

    rc = cli.main([str(a) for a in argv])
    if rc != 0:
        raise RuntimeError(f"tpuao_torch {' '.join(map(str, argv))}: "
                           f"exit {rc}")


def cli_counts(K, label, want, argv) -> float:
    """Run the CLI with the launch counts set to 0 just before and read
    just after; returns its host-clock seconds."""
    import torch

    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    run_cli(argv)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    expect_counts(K, label, want)
    print(f"  {label}: launches {K.launch_counts()}, {sec:.3f} s",
          flush=True)
    return sec


def phase_cli(chk, dev, K, F, card, tmp):
    """13a. ``python -m tpuao_torch`` (in-process) on 1080p files in
    ``tmp``: the single frame (PFM, PNG, colour, ULTRA normals), the debug
    dump under auto, pallas and fused, an 8-frame sequence at --batch 4,
    the temporal sequence along a camera path, and ``info``; every output
    held against the port's entry points on the card."""
    import io

    import numpy as np
    import torch
    from PIL import Image

    from tpuao_torch.models.pipeline import TemporalAOEngine, render_frame
    from tpuao_torch.models.presets import preset
    from tpuao_torch.params import AOParams, CameraParams, padded_shape
    from tpuao_torch.utils.debug_dump import _flatten, load_debug_buffers
    from tpuao_torch.utils.frameio import load_pfm, load_pfm_batch, save_pfm
    from tpuao_torch.utils import native
    from tpuao_torch.utils.io import encode_ao_png

    h0, w0 = 1080, 1920
    print(f"cli (python -m tpuao_torch, in-process, {h0}x{w0}) [{card}]:")
    cam_hw, cam = CameraParams(), CameraParams(depth_mode="linear")
    z, n = F.spheres_on_plane(h0, w0, cam_hw, seed=SEED, with_normals=True)
    zh = F.to_hardware_depth(z, cam_hw).astype(np.float32)
    n = n.astype(np.float32)
    rgb = np.random.default_rng(SEED).integers(0, 256, (h0, w0, 3),
                                               dtype=np.uint8)
    depth, nrm, col = tmp / "depth.pfm", tmp / "normals.pfm", tmp / "c.png"
    save_pfm(str(depth), zh)
    save_pfm(str(nrm), n)
    Image.fromarray(rgb).save(col)
    frames, views = dolly_frames(F, cam, h0, w0, 8)
    seq = tmp / "seq"
    seq.mkdir()
    for t, (zt, _) in enumerate(frames):
        save_pfm(str(seq / f"f{t}.pfm"), zt)
    path = tmp / "path.json"
    path.write_text(json.dumps([v.ravel().tolist() for v in views]))
    on = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    d = on(zh)
    high = counts(prepare_levels=1, render_ao_level=1, blur_upsample_step=1,
                  fused_render_upsample_step=3)

    cli_counts(K, "frame (depth.pfm -> ao.pfm)", high,
               ["render", depth, tmp / "ao.pfm"])
    want = render_frame(d, cam_hw, AOParams())
    chk.close("", "cli frame vs render_frame", on(load_pfm(str(
        tmp / "ao.pfm"))), want, tol=0.0)
    run_cli(["render", depth, tmp / "ao.png"])
    if (tmp / "ao.png").read_bytes() != encode_ao_png(want.cpu().numpy()):
        raise RuntimeError("cli PNG bytes differ from encode_ao_png of "
                           "render_frame")
    print("  ao.png: bytes equal encode_ao_png(render_frame)")
    run_cli(["render", depth, tmp / "aoc.pfm", "--color", col])
    chk.close("", "cli --color vs render_frame",
              on(load_pfm(str(tmp / "aoc.pfm"))),
              render_frame(d, cam_hw, AOParams(),
                           color=on(rgb.astype(np.float32) / 255.0)),
              tol=0.0)
    cli_counts(K, "ULTRA --normals", counts(prepare_levels=1,
                                            render_ao_level_normals=4,
                                            blur_upsample_step=4),
               ["render", depth, tmp / "aon.pfm", "--preset", "ULTRA",
                "--normals", nrm])
    chk.close("", "cli ULTRA --normals vs render_frame",
              on(load_pfm(str(tmp / "aon.pfm"))),
              render_frame(d, cam_hw, preset("ULTRA"), normals=on(n)),
              tol=0.0)

    for impl, c in (("auto", counts(prepare_levels=1, render_ao_level=4,
                                    blur_upsample_step=1,
                                    fused_render_upsample_step=3)),
                    ("pallas", counts(prepare_levels=1, render_ao_level=4,
                                      blur_upsample_step=4)),
                    ("fused", high)):
        dump = tmp / f"dbg_{impl}.npz"
        cli_counts(K, f"--debug-dump, impl={impl}", c,
                   ["render", depth, tmp / "aod.pfm", "--impl", impl,
                    "--debug-dump", dump])
        got = load_debug_buffers(str(dump))
        _, dbg = render_frame(d, cam_hw, AOParams(), impl=impl,
                              debug_outputs=True)
        mem = _flatten(dbg)
        if sorted(got) != sorted(mem):
            raise RuntimeError(f"dump {impl}: keys {sorted(got)} != "
                               f"{sorted(mem)}")
        for k, v in mem.items():
            if got[k].shape != v.shape or not np.array_equal(got[k], v):
                raise RuntimeError(f"dump {impl} {k}: {got[k].shape} vs "
                                   f"the in-memory {v.shape}")
        c0 = got["combined_0"]
        if c0.shape != (padded_shape(h0, w0) if impl != "auto"
                        else (h0, w0)):
            raise RuntimeError(f"dump {impl}: combined_0 {c0.shape}")
        chk.close("", f"dump {impl}: {len(got)} leaves equal the in-memory "
                  f"dict; combined_0 {c0.shape} interior vs the cropped "
                  "step", on(c0[:h0, :w0]),
                  render_frame(d, cam_hw, AOParams(), impl=impl), tol=0.0)

    out = tmp / "out"
    sec = cli_counts(K, "sequence, 8 frames --batch 4",
                     {k: 2 * v for k, v in high.items()},
                     ["render", seq / "f*.pfm", out, "--batch", "4",
                      "--depth-mode", "linear"])
    zs = [on(zt) for zt, _ in frames]
    batch_err = single_err = 0.0
    for b in (0, 4):
        ref = render_frame(torch.stack(zs[b:b + 4]), cam, AOParams())
        for j in range(4):
            got = on(load_pfm(str(out / f"f{b + j}_ao.pfm")))
            batch_err = max(batch_err, chk.close(
                "", None, got, ref[j], tol=0.0, quiet=True))
            single_err = max(single_err, chk.close(
                "", None, got, render_frame(zs[b + j], cam, AOParams()),
                tol=0.0, quiet=True))
    print(f"  sequence files vs render_frame: batch of 4 max_abs_err="
          f"{batch_err:.3e}, one frame a call {single_err:.3e}")
    # where the sequence's host time goes, by the same calls one at a time
    paths = [str(seq / f"f{t}.pfm") for t in range(4)]
    split = {"decode": [], "render": [], "encode": []}
    for _ in range(3):
        t0 = time.perf_counter()
        arr = load_pfm_batch(paths)
        t1 = time.perf_counter()
        ao = render_frame(arr, cam, AOParams()).cpu().numpy()
        t2 = time.perf_counter()
        for j in range(4):
            save_pfm(str(tmp / f"enc{j}.pfm"), ao[j])
        t3 = time.perf_counter()
        for k, v in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[k].append(v / 4)
    print(f"  sequence host clock: {sec / 8 * 1e3:.2f} ms/frame through the "
          f"CLI (8 frames, --batch 4, process already warm); per frame, "
          f"best of 3 batches of 4: decode {min(split['decode']) * 1e3:.2f}"
          f" ms, upload+render+download {min(split['render']) * 1e3:.2f} "
          f"ms, encode {min(split['encode']) * 1e3:.2f} ms; PFM codec: "
          f"{'native' if native.get_lib() is not None else 'NumPy'} "
          f"[{card}]", flush=True)

    tout = tmp / "tout"
    cli_counts(K, "--temporal --camera-path, 8 frames",
               {**{k: 8 * v for k, v in high.items()},
                "windowed_resolve": 7},
               ["render", seq / "f*.pfm", tout, "--temporal",
                "--camera-path", path, "--depth-mode", "linear"])
    eng = TemporalAOEngine(cam)
    worst = max(chk.close("", None, on(load_pfm(str(tout / f"f{t}_ao.pfm"))),
                          eng.render(zs[t], view=views[t]), tol=0.0,
                          quiet=True) for t in range(8))
    print(f"  temporal files vs TemporalAOEngine: max_abs_err={worst:.3e}")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_cli(["info"])
    info = json.loads(buf.getvalue())
    if info["devices"][:1] != [torch.cuda.get_device_name(0)] or \
            not info["cuda_available"]:
        raise RuntimeError(f"info: {info}")
    print(f"  info: {json.dumps(info)}")


def phase_rigs(chk, dev, K, F, card):
    """13b. ``render_views_sharded`` on 8 1080p views: a uniform rig and a
    rig of 4 distinct (FOV, strength) pairs each used twice, their launch
    counts, every view against ``render_frame`` with its own scalars (and
    colour + uint8), and their time beside ``render_frame`` on the same 8
    views as one batch."""
    import math

    import numpy as np
    import torch

    from tpuao_torch.models.pipeline import render_frame
    from tpuao_torch.params import AOParams, CameraParams
    from tpuao_torch.parallel.sharding import render_views_sharded
    from tpuao_torch.utils.timing import cuda_time_ms

    h0, w0, v = 1080, 1920, 8
    print(f"views (render_views_sharded, 8 x {h0}x{w0}, per_view rigs) "
          f"[{card}]:")
    cam = CameraParams(depth_mode="linear")
    z = torch.as_tensor(np.stack([F.spheres_on_plane(h0, w0, cam, seed=s)
                                  for s in range(v)]).astype(np.float32),
                        device=dev)
    rgb = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, 256, (v, h0, w0, 3), dtype=np.uint8), device=dev)
    fovs = [50.0, 60.0, 75.0, 90.0] * 2
    strengths = [0.7, 1.0, 1.5, 2.5] * 2

    def rig(fov, strength):
        tan = [math.tan(math.radians(f) / 2) for f in fov]
        c = cam.replace(near=np.full(v, cam.near), far=np.full(v, cam.far),
                        tan_half_fov_h=np.asarray(tan))
        p = AOParams(strength=np.asarray(strength, np.float64),
                     **{k: np.full(v, getattr(AOParams(), k)) for k in (
                         "noise_filter_tolerance", "blur_tolerance",
                         "upsample_tolerance", "rejection_falloff")})
        own = [(cam.replace(tan_half_fov_h=tan[i]),
                AOParams(strength=strength[i])) for i in range(v)]
        return c, p, own

    rigs = {"uniform": (rig([60.0] * v, [1.0] * v), counts(
                prepare_levels=1, render_ao_level=1, blur_upsample_step=1,
                fused_render_upsample_step=3)),
            "4 pairs": (rig(fovs, strengths), counts(
                prepare_levels=4, render_ao_level=4, blur_upsample_step=4,
                fused_render_upsample_step=12))}
    fns = {}
    for name, ((c, p, own), want) in rigs.items():
        torch.cuda.synchronize()
        K.reset_launch_counts()
        out = render_views_sharded(z, c, p, per_view=True)
        torch.cuda.synchronize()
        expect_counts(K, f"rig {name}", want)
        q = render_views_sharded(z, c, p, per_view=True, color=rgb,
                                 out_dtype="uint8")
        err = qerr = 0.0
        for i, (ci, pi) in enumerate(own):
            err = max(err, chk.close("", None, out[i],
                                     render_frame(z[i], ci, pi), tol=0.0,
                                     quiet=True))
            qi = render_frame(z[i], ci, pi, color=rgb[i], out_dtype="uint8")
            qerr = max(qerr, chk.close("", None, q[i], qi, tol=0.0,
                                       quiet=True))
        print(f"  rig {name}: launches {sum(want.values())} {want}; every "
              f"view vs render_frame with its own scalars max_abs_err="
              f"{err:.3e}, colour uint8 codes {qerr:.0f}", flush=True)
        fns[f"rig {name}"] = (lambda c=c, p=p:
                              render_views_sharded(z, c, p, per_view=True))
    fns["render_frame, one batch"] = lambda: render_frame(z, cam, AOParams())
    for name, fn in fns.items():
        ev = cuda_time_ms(fn)
        device, _, nk = device_profile(fn)
        print(f"  {name}: {ev / v:.4f} ms/view by events, {device / v:.4f} "
              f"ms/view device (torch.profiler, {nk:.0f} kernels a call), "
              f"idle share {1 - device / ev:.2f} [{card}]", flush=True)
    del z, rgb
    torch.cuda.empty_cache()


def phase_autodiff(chk, dev, K, F, card):
    """14. Autodiff on the card at 1080p (linear-depth spheres on a
    plane): ``ao_loss`` with tunables that require grad is the plain
    path's MSE bit for bit and launches no kernel; ``ao_grads`` is finite
    with a non-zero strength gradient, and agrees with the CPU at
    270x480; the calibration of examples/calibrate.py (hidden strength 1.8
    and rejection_falloff 4.0, both fitted from the defaults, lr 0.08, 40
    steps) cuts the loss at least 10x, with its step time, device time,
    idle share and peak memory; ``"pallas"``/``"fused"`` and every kernel
    wrapper refuse what requires grad.  Returns the launch counts of the
    autodiff calls (all 0)."""
    import numpy as np
    import torch

    from tpuao_torch.models import autodiff as A
    from tpuao_torch.models.pipeline import render_frame
    from tpuao_torch.params import AOParams, CameraParams

    h0, w0 = 1080, 1920
    print(f"autodiff (models.autodiff on the card, {h0}x{w0}) [{card}]:")
    cam = CameraParams(depth_mode="linear")
    z_np = F.spheres_on_plane(h0, w0, cam, seed=SEED).astype(np.float32)
    z = torch.as_tensor(z_np, device=dev)
    target = render_frame(z, cam, AOParams(strength=1.4))

    def leaves(p):
        return p.replace(**{n: torch.tensor(float(getattr(p, n)),
                                            device=dev, requires_grad=True)
                            for n in A.TRACED_TUNABLES})

    par_t = leaves(AOParams())
    torch.cuda.synchronize()
    K.reset_launch_counts()
    with torch.enable_grad():
        loss = A.ao_loss(par_t, z, target, cam)
        d = render_frame(z, cam, par_t, impl="jnp") - target
        want = torch.mean(d * d)
    torch.cuda.synchronize()
    run = K.launch_counts()
    expect_counts(K, "ao_loss with tunables that require grad", counts())
    if not torch.equal(loss, want):
        raise RuntimeError(f"ao_loss {float(loss)} != the plain path's MSE "
                           f"{float(want)}")
    print(f"  ao_loss, tensor tunables, impl=auto: "
          f"{float(loss.detach()):.9e}, bit-equal to "
          f"render_frame(impl='jnp')'s MSE; launches {run}")
    loss, gp, gd = A.ao_grads(AOParams(), z, target, cam, wrt_depth=True)
    g = {n: float(getattr(gp, n)) for n in A.TRACED_TUNABLES}
    if not (all(np.isfinite(list(g.values())))
            and bool(torch.isfinite(gd).all())):
        raise RuntimeError(f"non-finite gradients {g}")
    if g["strength"] == 0.0:
        raise RuntimeError("zero strength gradient against a 1.4 target")
    print(f"  ao_grads wrt_depth: loss {float(loss):.6e}, tunables {g}, "
          f"|grad depth| max {float(gd.abs().max()):.3e}")
    # the same call at 270x480 on the card and on the CPU
    zs = F.spheres_on_plane(270, 480, cam, seed=SEED).astype(np.float32)
    ts = render_frame(zs, cam, AOParams(strength=1.4), device="cpu").numpy()
    res = {where: A.ao_grads(AOParams(), zs, ts, cam, wrt_depth=True,
                             device=where) for where in ("cuda", "cpu")}
    (lc, gc, dc), (lh, gh, dh) = res["cuda"], res["cpu"]
    loss_rel = abs(float(lc) - float(lh)) / abs(float(lh))
    vc = np.array([float(getattr(gc, n)) for n in A.TRACED_TUNABLES])
    vh = np.array([float(getattr(gh, n)) for n in A.TRACED_TUNABLES])
    tun_rel = float(np.abs(vc - vh).max() / np.abs(vh).max())
    dep_rel = float((dc.cpu() - dh).abs().max() / dh.abs().max())
    print(f"  270x480 card vs CPU: loss rel {loss_rel:.2e}, tunable "
          f"gradients {tun_rel:.2e} and depth gradient {dep_rel:.2e} of "
          f"their largest element")
    if not (loss_rel <= 1e-6 and tun_rel <= 1e-4 and dep_rel <= 1e-4):
        raise RuntimeError("the card's gradients disagree with the CPU's")
    # the calibration of examples/calibrate.py
    hidden = AOParams(strength=1.8, rejection_falloff=4.0)
    target = render_frame(z, cam, hidden)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fitted, losses = A.fit_tunables(z, target, cam, lr=0.08, steps=40)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 40
    peak = torch.cuda.max_memory_allocated(dev)
    first, last = float(losses[0]), float(losses[-1])
    fit_vals = {n: round(float(getattr(fitted, n)), 4)
                for n in ("strength", "rejection_falloff")}
    print(f"  calibration, 40 steps at lr 0.08 from the defaults to hidden "
          f"strength 1.8, rejection_falloff 4.0: loss {first:.4e} -> "
          f"{last:.4e} ({first / last:.1f}x), fitted {fit_vals}")
    if not last * 10 <= first:
        raise RuntimeError(f"the fit cut the loss only {first / last:.2f}x")
    device, _, nk = device_profile(
        lambda: A.fit_tunables(z, target, cam, lr=0.08, steps=2), calls=2)
    print(f"  fit step: {step_ms:.2f} ms host clock (40 steps, "
          f"synchronised), {device / 2:.3f} ms device (torch.profiler, "
          f"{nk / 2:.0f} kernels a step), idle share "
          f"{1 - device / 2 / step_ms:.3f}; peak memory "
          f"{peak / 2**30:.3f} GiB [{card}]", flush=True)
    # what cannot differentiate refuses
    for impl in ("pallas", "fused"):
        try:
            A.ao_grads(AOParams(), z, target, cam, impl=impl)
        except ValueError:
            continue
        raise RuntimeError(f"impl={impl!r} gave gradients")
    for impl in ("auto", "pallas", "fused"):  # the pipeline swaps nothing
        try:
            render_frame(z, cam, par_t, impl=impl)
        except ValueError:
            continue
        raise RuntimeError(f"render_frame(impl={impl!r}) took tunables "
                           "that require grad")
    lo = torch.rand(32, 48, device=dev) * 0.4 + 0.3
    hi = torch.rand(64, 96, device=dev) * 0.4 + 0.3
    strong = AOParams().replace(
        strength=torch.tensor(1.5, device=dev, requires_grad=True))
    calls = {
        "render_ao_level": lambda p: K.render_ao_level(lo, 1, 96, cam, p),
        "render_ao_level_normals": lambda p: K.render_ao_level_normals(
            lo, 1, 96, cam, p.replace(use_normals=True),
            slopes_ds=(lo * 0, lo * 0)),
        "render_ao_level_dma": lambda p: K.render_ao_level_dma(lo, 1, 96,
                                                               cam, p),
        "blur_upsample_step": lambda p: K.blur_upsample_step(
            lo, hi[::2, ::2].contiguous(), hi, p, 96),
        "fused_render_upsample_step": lambda p:
            K.fused_render_upsample_step(lo, lo, hi, 1, 96, cam, p),
        "fused_render_upsample_step_zc": lambda p:
            K.fused_render_upsample_step_zc(lo, lo, hi, 1, 96, cam, p),
    }
    for name, call in calls.items():
        try:
            call(strong)
        except ValueError:
            continue
        raise RuntimeError(f"{name} took a tunable that requires grad")
    print("  ao_grads under impl='pallas'/'fused', render_frame under "
          "'auto'/'pallas'/'fused' with tunables that require grad, and "
          "all six wrappers with a strength that requires grad: ValueError")
    del z, target, gd
    torch.cuda.empty_cache()
    return run


def phase_mesh(chk, dev, K, F, card):
    """15. The mesh on one card, ``(cuda:0, cuda:0)`` (and ``make_mesh()``
    where there are more cards): 8 1080p views (10 launches, bit-equal to
    one batch), 9 views padded to 10, a 4-pair rig, the temporal fleet
    of 4 sequences x 4 frames at resolve_level 0 and 1 (launches, each
    sequence bit-equal to render_sequence_temporal), the mesh server
    answering 4 concurrent requests in flushes of 2, the caller's current
    device unchanged throughout, and device ms per view beside one
    batch's.  Returns each path's launch counts."""
    import threading

    import numpy as np
    import torch

    from tpuao_torch.client import AOClient
    from tpuao_torch.models.pipeline import (render_frame,
                                             render_sequence_temporal)
    from tpuao_torch.params import AOParams, CameraParams, TemporalParams
    from tpuao_torch.parallel.sharding import (make_mesh,
                                               render_sequences_temporal_sharded,
                                               render_views_sharded)
    from tpuao_torch.serving import make_server, warm_server
    from tpuao_torch.utils.camera import relative_motion
    from tpuao_torch.utils.timing import cuda_time_ms

    h0, w0 = 1080, 1920
    meshes = [(dev, dev)]
    if torch.cuda.device_count() > 1:
        meshes.append(make_mesh())
    cam, par = CameraParams(depth_mode="linear"), AOParams()
    z = torch.as_tensor(np.stack([F.spheres_on_plane(h0, w0, cam, seed=s)
                                  for s in range(9)]).astype(np.float32),
                        device=dev)
    home = torch.cuda.current_device()

    def same_device(label):
        torch.cuda.synchronize()
        if torch.cuda.current_device() != home:
            raise RuntimeError(f"{label} left the current device at "
                               f"{torch.cuda.current_device()}, not {home}")

    def run(label, fn, want):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        out = fn()
        same_device(label)
        expect_counts(K, label, want)
        return out, K.launch_counts()

    paths = {}
    fovs, strengths = [50.0, 60.0, 75.0, 90.0] * 2, [0.7, 1.0, 1.5, 2.5] * 2
    tan = np.tan(np.radians(fovs) / 2)
    rig_c = cam.replace(near=np.full(8, cam.near), far=np.full(8, cam.far),
                        tan_half_fov_h=tan)
    rig_p = AOParams(strength=np.asarray(strengths),
                     **{k: np.full(8, getattr(par, k)) for k in (
                         "noise_filter_tolerance", "blur_tolerance",
                         "upsample_tolerance", "rejection_falloff")})
    one8 = render_views_sharded(z[:8], cam, par)
    one9 = render_views_sharded(z, cam, par)
    one_rig = render_views_sharded(z[:8], rig_c, rig_p, per_view=True)
    for mesh in meshes:
        n = len(mesh)
        tag = f"mesh {tuple(str(d) for d in mesh)}"
        print(f"{tag}, 1080p [{card}]:")
        per = counts(prepare_levels=1, render_ao_level=1,
                     blur_upsample_step=1, fused_render_upsample_step=3)
        shards = {k: v * n for k, v in per.items()}
        out, paths[f"{tag} views"] = run(
            f"{tag} 8 views", lambda: render_views_sharded(z[:8], cam, par,
                                                           mesh=mesh),
            shards)
        chk.close("", f"  8 views vs one batch, launches "
                  f"{sum(shards.values())}", out, one8, tol=0.0)
        out, _ = run(f"{tag} 9 views",
                     lambda: render_views_sharded(z, cam, par, mesh=mesh),
                     shards)
        if tuple(out.shape) != (9, h0, w0):
            raise RuntimeError(f"9 views gave {tuple(out.shape)}")
        chk.close("", f"  9 views (padded to {-(-9 // n) * n}) vs one "
                  f"batch", out, one9, tol=0.0)
        groups = sum(len(set(list(zip(fovs, strengths))[i * 8 // n:
                                                         (i + 1) * 8 // n]))
                     for i in range(n))
        out, _ = run(f"{tag} rig", lambda: render_views_sharded(
            z[:8], rig_c, rig_p, per_view=True, mesh=mesh),
            {k: v * groups for k, v in per.items()})
        chk.close("", f"  4-pair rig ({groups} shard groups) vs one batch",
                  out, one_rig, tol=0.0)
    # the fleet: 4 sequences x 4 frames, each moving its own way
    t_n, v_n = 4, 4
    depths, motions = [], []
    for i in range(v_n):
        eyes = [(0.03 * (i + 1) * t, 0.01 * i * t, 0.04 * t)
                for t in range(t_n)]
        views = []
        for e in eyes:
            vm = np.eye(4)
            vm[:3, 3] = [-c for c in e]
            views.append(vm)
        depths.append([F.spheres_on_plane(h0, w0, cam, seed=SEED + i, eye=e)
                       for e in eyes])
        motions.append([np.eye(4)] + [relative_motion(views[t - 1], views[t])
                                      for t in range(1, t_n)])
    depths = torch.as_tensor(np.asarray(depths, np.float32), device=dev)
    motions = np.asarray(motions)
    tp = TemporalParams()
    frames = v_n * t_n
    for rl, per_frame in ((0, (1, 1, 3)), (1, (2, 2, 2))):
        want = counts(prepare_levels=frames,
                      render_ao_level=frames * per_frame[0],
                      blur_upsample_step=frames * per_frame[1],
                      fused_render_upsample_step=frames * per_frame[2],
                      windowed_resolve=v_n * (t_n - 1))
        out, paths[f"fleet l{rl}"] = run(
            f"fleet resolve_level={rl}",
            lambda: render_sequences_temporal_sharded(
                depths, cam, par, tp, motions=motions, mesh=meshes[0],
                resolve_level=rl), want)
        err = 0.0
        for i in range(v_n):
            err = max(err, chk.close("", "", out[i], render_sequence_temporal(
                depths[i], cam, par, tp, motions=motions[i],
                resolve_level=rl), tol=0.0, quiet=True))
        print(f"  fleet {v_n} sequences x {t_n} frames, resolve_level={rl}, "
              f"mesh of 2: launches {sum(want.values())} "
              f"{ {k: v for k, v in want.items() if v} }; each sequence vs "
              f"render_sequence_temporal max_abs_err={err:.3e}", flush=True)
    del depths
    # the mesh server: flushes of 2, one view a mesh entry
    srv = make_server(0, mesh=meshes[0], device="cuda:0")
    warm_server(srv, (h0, w0), [])
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        client = AOClient(f"http://127.0.0.1:{srv.server_address[1]}",
                          retries=0)
        client.wait_ready(timeout=30.0, interval=0.1)
        zs = [z[i].cpu().numpy() for i in range(4)]
        torch.cuda.synchronize()
        K.reset_launch_counts()
        got = client.render_many(zs, workers=4)
        torch.cuda.synchronize()
        paths["mesh server"] = K.launch_counts()
        st = client.stats()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    same_device("the mesh server")
    for i in range(4):
        chk.close("", "", torch.as_tensor(got[i], device=dev),
                  render_frame(z[i], cam, par), tol=0.0, quiet=True)
    if st["batched"] < 4 or paths["mesh server"]["render_ao_level"] < 1:
        raise RuntimeError(f"mesh server stats {st} launches "
                           f"{paths['mesh server']}")
    print(f"  mesh server (batch 2 over 2 entries): 4 concurrent requests "
          f"each bit-equal to render_frame; batcher {st['batcher']}; "
          f"launches {paths['mesh server']}")
    if torch.cuda.device_count() > 1:
        with torch.cuda.device(0):
            K.render_ao_level(z[0, ::2, ::2].contiguous().to("cuda:1"), 1,
                              w0, cam, par)
            torch.cuda.synchronize(1)
            if torch.cuda.current_device() != 0:
                raise RuntimeError("a launch on cuda:1 moved the thread")
        print("  a launch on cuda:1 with cuda:0 current: cuda:0 still "
              "current")
    else:
        print("  one card: the launch on cuda:1 with cuda:0 current could "
              "not run; every call above left the current device as it "
              "was")
    # device time per view: the mesh of two beside one batch, in turns
    fns = {"one batch": lambda: render_views_sharded(z[:8], cam, par),
           "mesh of 2": lambda: render_views_sharded(z[:8], cam, par,
                                                     mesh=meshes[0])}
    for name in ("one batch", "mesh of 2", "mesh of 2", "one batch"):
        ev = cuda_time_ms(fns[name])
        device, _, nk = device_profile(fns[name])
        print(f"  8 views, {name}: {ev / 8:.4f} ms/view by events, "
              f"{device / 8:.4f} ms/view device ({nk:.0f} kernels a call), "
              f"idle share {1 - device / ev:.2f} [{card}]", flush=True)
    del z
    torch.cuda.empty_cache()
    return paths


def phase_spatial(chk, dev, K, F, card):
    """16. The spatial and grid modes on one card (meshes that name
    ``cuda:0`` several times, and ``make_row_mesh()`` where there are more
    cards): an 8K HIGH frame on 2 and 4 row bands and a 4K ULTRA frame on
    2 (normals, uint8 colour, every debug leaf), each bit-equal to the
    frame program on the halo-padded frame, cropped; the kernels at the
    8K band's shapes against their plain versions; a 2x2 grid of 4K views
    (and a rig of 2 distinct value sets, 2 views a block), each view
    bit-equal to its own spatial run; a 1080p frame on 2 bands under
    ``impl="auto"`` and ``"jnp"``, each bit-equal to its padded
    monolithic frame, and the kernels at its band's shapes; the engine's
    ``render_spatial``;
    launch counts and the caller's current device after every call; then
    event ms, graph-replay device ms and idle share of the 8K frame on 2
    and 4 bands and of the 4K grid beside the monolithic frame.  Returns
    each path's launch counts."""
    import math

    import numpy as np
    import torch

    from tpuao_torch.models.pipeline import (AmbientOcclusionEngine,
                                             render_frame)
    from tpuao_torch.models.presets import preset
    from tpuao_torch.ops import prepare as P
    from tpuao_torch.params import AOParams, CameraParams
    from tpuao_torch.parallel.grid import make_grid_mesh, render_views_spatial
    from tpuao_torch.parallel.spatial import (halo_extend_rows,
                                              make_row_mesh,
                                              pad_rows_aligned,
                                              render_frame_spatial,
                                              stencil_halo_rows)
    from tpuao_torch.utils.timing import cuda_graph_ms, cuda_time_ms

    cam, par = CameraParams(depth_mode="linear"), AOParams()
    halo = stencil_halo_rows(par)
    home = torch.cuda.current_device()
    per = counts(prepare_levels=1, render_ao_level=1, blur_upsample_step=1,
                 fused_render_upsample_step=3)
    times = lambda c, n: {k: v * n for k, v in c.items()}
    paths = {}

    def run(label, fn, want):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        if torch.cuda.current_device() != home:
            raise RuntimeError(f"{label} left the current device at "
                               f"{torch.cuda.current_device()}, not {home}")
        expect_counts(K, label, want)
        paths[label] = K.launch_counts()
        return out

    def halo_padded(x, n):
        """``x`` as the spatial mode sees it on n bands: aligned by
        pad_rows_aligned, then edge-replicated by the halo rows."""
        x = pad_rows_aligned(x, n, 0)
        edge = lambda r: r.expand((halo,) + tuple(x.shape[1:]))
        return torch.cat([edge(x[:1]), x, edge(x[-1:])])

    def crop(leaf, rows):  # a padded-frame leaf to the frame's rows
        scale = (rows + 2 * halo) // leaf.shape[0]
        return leaf[halo // scale: (halo + rows) // scale]

    def band_kernels(z, label):
        """Each kernel of the HIGH path at band 0's shapes on 2 bands (its
        halo-extended input) against its plain version on the same
        inputs: the render bit for bit, the chain steps within
        TOL_CHAIN_STEP."""
        zp = pad_rows_aligned(z, 2, 0)
        hb = zp.shape[0] // 2
        ext = halo_extend_rows([zp[:hb], zp[hb:]], halo, 0)[0]
        pyr = [lvl.contiguous() for lvl in
               P.build_pyramid(P.linearize_depth(ext, cam), 4)]
        eh, ew = ext.shape
        a4 = K.render_ao_level_plain(pyr[4], 4, ew, cam, par)
        chk.close("render", f"render l4 {tuple(pyr[4].shape)} ({label} "
                  f"band, ext {eh})", K.render_ao_level(pyr[4], 4, ew, cam,
                                                        par), a4,
                  tol=TOL_EXACT)
        c = K.blur_upsample_step_plain(a4, pyr[4], pyr[3], par, ew)
        chk.close("upsample", f"upsample 4->3 ({label} band)",
                  K.blur_upsample_step(a4, pyr[4], pyr[3], par, ew), c,
                  tol=TOL_CHAIN_STEP)
        for l in (3, 2, 1):
            crop_hw = (eh, ew) if l == 1 else None
            want = K.fused_render_upsample_step_plain(
                pyr[l], c, pyr[l - 1], l, ew, cam, par, crop_hw=crop_hw)
            chk.close("fused", f"fused {l}->{l - 1} {tuple(pyr[l].shape)} "
                      f"({label} band)", K.fused_render_upsample_step(
                          pyr[l], c, pyr[l - 1], l, ew, cam, par,
                          crop_hw=crop_hw), want, tol=TOL_CHAIN_STEP)
            c = want

    # 8K HIGH on 2 and 4 bands
    h8, w8 = 4320, 7680
    z8 = torch.as_tensor(F.spheres_on_plane(h8, w8, cam, seed=SEED),
                         dtype=torch.float32, device=dev)
    meshes = [(dev,) * 2, (dev,) * 4]
    if torch.cuda.device_count() > 1:
        meshes.append(make_row_mesh())
    print(f"spatial and grid (halo {halo} rows) [{card}]:")
    refs = {}
    for mesh in meshes:
        n = len(mesh)
        ha = -(-h8 // (64 * n)) * 64 * n
        label = f"spatial 8K {n} bands" + (
            "" if len(set(mesh)) == 1 else " (cards)")
        out = run(label, lambda: render_frame_spatial(z8, cam, par,
                                                      mesh=mesh),
                  times(per, n))
        if ha not in refs:
            refs[ha] = render_frame(halo_padded(z8, n), cam,
                                    par)[halo: halo + h8]
        chk.close("", f"8K HIGH on {n} bands (padded to {ha}, bands of "
                  f"{ha // n}, ext {ha // n + 2 * halo}), launches "
                  f"{6 * n}, vs the padded monolithic frame", out,
                  refs[ha], tol=0.0)
    band_kernels(z8, "8K")
    # 4K ULTRA on 2 bands: normals, uint8 colour, every debug leaf
    ultra = preset("ULTRA")
    if stencil_halo_rows(ultra) != halo:
        raise RuntimeError("ULTRA's halo differs from HIGH's")
    h4, w4 = 2160, 3840
    z4, n4 = (torch.as_tensor(a.astype(np.float32), device=dev)
              for a in F.spheres_on_plane(h4, w4, cam, seed=SEED + 1,
                                          with_normals=True))
    rgb = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, 256, (h4, w4, 3), dtype=np.uint8), device=dev)
    out, dbg = run("spatial ULTRA 4K 2 bands", lambda: render_frame_spatial(
        z4, cam, ultra, mesh=(dev, dev), normals=n4, color=rgb,
        out_dtype="uint8", debug_outputs=True),
        counts(prepare_levels=2, render_ao_level_normals=8,
               blur_upsample_step=8))
    ref, rdbg = render_frame(halo_padded(z4, 2), cam, ultra,
                             normals=halo_padded(n4, 2),
                             color=halo_padded(rgb, 2), out_dtype="uint8",
                             debug_outputs=True)
    if out.dtype != torch.uint8 or tuple(out.shape) != (h4, w4, 3):
        raise RuntimeError(f"ULTRA spatial gave {out.dtype} {out.shape}")
    chk.close("", "4K ULTRA on 2 bands, uint8 colour, launches 18, vs "
              "the padded monolithic frame", out, ref[halo: halo + h4],
              tol=0.0)
    leaves = 0
    ha = pad_rows_aligned(z4, 2, 0).shape[0]
    for key, group in dbg.items():
        for sub, leaf in (group.items() if isinstance(group, dict)
                          else ((None, group),)):
            want = rdbg[key] if sub is None else rdbg[key][sub]
            chk.close("", "", leaf, crop(want, ha), tol=0.0, quiet=True)
            leaves += 1
    print(f"  4K ULTRA debug dict: {leaves} leaves bit-equal to the padded "
          f"monolithic frame's, cropped", flush=True)
    del z4, n4, rgb, out, dbg, ref, rdbg
    # the 4K grid: 2 views x 2 bands, and a rig of 2 value sets
    grid = make_grid_mesh(2, 2, [dev] * 4)
    zs = torch.as_tensor(np.stack([F.spheres_on_plane(h4, w4, cam, seed=s)
                                   for s in range(4)]).astype(np.float32),
                         device=dev)
    out = run("grid 4K 2x2", lambda: render_views_spatial(
        zs[:2], cam, par, mesh=grid), times(per, 4))
    err = max(chk.close("", "", out[i], render_frame_spatial(
        zs[i], cam, par, mesh=(dev, dev)), tol=0.0, quiet=True)
        for i in range(2))
    print(f"  grid 2x2, 2 4K views: launches 24; each view vs its own "
          f"spatial run max_abs_err={err:.3e}", flush=True)
    fovs, strengths = [60.0, 80.0] * 2, [1.0, 2.0] * 2
    tan = [math.tan(math.radians(f) / 2) for f in fovs]
    rig_c = cam.replace(near=np.full(4, cam.near), far=np.full(4, cam.far),
                        tan_half_fov_h=np.asarray(tan))
    rig_p = AOParams(strength=np.asarray(strengths),
                     **{k: np.full(4, getattr(par, k)) for k in (
                         "noise_filter_tolerance", "blur_tolerance",
                         "upsample_tolerance", "rejection_falloff")})
    out = run("grid 4K 2x2 rig", lambda: render_views_spatial(
        zs, rig_c, rig_p, mesh=grid, per_view=True), times(per, 8))
    err = max(chk.close("", "", out[i], render_frame_spatial(
        zs[i], cam.replace(tan_half_fov_h=tan[i]),
        par.replace(strength=strengths[i]), mesh=(dev, dev)), tol=0.0,
        quiet=True) for i in range(4))
    print(f"  grid 2x2 rig, 4 4K views of 2 value sets (2 a block): "
          f"launches 48 (2 batches a device); each view vs its own spatial "
          f"run max_abs_err={err:.3e}", flush=True)
    # the kernels against the plain ops on this path, and the engine
    z1 = torch.as_tensor(F.spheres_on_plane(1080, 1920, cam, seed=SEED + 2),
                         dtype=torch.float32, device=dev)
    got = run("spatial 1080p 2 bands", lambda: render_frame_spatial(
        z1, cam, par, mesh=(dev, dev)), times(per, 2))
    plain = render_frame_spatial(z1, cam, par, mesh=(dev, dev), impl="jnp")
    for impl, out in (("auto", got), ("jnp", plain)):
        chk.close("", f"1080p on 2 bands (1152 rows, bands of 576) {impl} "
                  f"vs the padded monolithic frame {impl}", out,
                  render_frame(halo_padded(z1, 2), cam, par,
                               impl=impl)[halo: halo + 1080], tol=0.0)
    chk.close("", "1080p on 2 bands auto vs jnp (the frame program's own "
              "difference: four chained steps)", got, plain)
    band_kernels(z1, "1080p")
    eng = AmbientOcclusionEngine(cam, par, device=dev)
    chk.close("", "engine.render_spatial vs render_frame_spatial",
              run("engine render_spatial",
                  lambda: eng.render_spatial(z1, mesh=(dev, dev)),
                  times(per, 2)), got, tol=0.0)
    # times, in turns: the monolithic frame beside its bands
    fns = {"8K monolithic": lambda: render_frame(z8, cam, par),
           "8K 2 bands": lambda: render_frame_spatial(z8, cam, par,
                                                      mesh=meshes[0]),
           "8K 4 bands": lambda: render_frame_spatial(z8, cam, par,
                                                      mesh=meshes[1]),
           "4K 2 views monolithic": lambda: render_frame(zs[:2], cam, par),
           "4K 2 views 2x2 grid": lambda: render_views_spatial(
               zs[:2], cam, par, mesh=grid)}
    rows = {"8K monolithic": -(-h8 // 64) * 64,
            "8K 2 bands": 2 * (-(-h8 // 128) * 64 + 2 * halo),
            "8K 4 bands": 4 * (-(-h8 // 256) * 64 + 2 * halo),
            "4K 2 views monolithic": -(-h4 // 64) * 64,
            "4K 2 views 2x2 grid": 2 * (-(-h4 // 128) * 64 + 2 * halo)}
    order = ["8K monolithic", "8K 2 bands", "8K 4 bands", "8K 4 bands",
             "8K 2 bands", "8K monolithic", "4K 2 views monolithic",
             "4K 2 views 2x2 grid", "4K 2 views 2x2 grid",
             "4K 2 views monolithic"]
    dev_ms = {}
    for name in order:
        ev, dv = cuda_time_ms(fns[name]), cuda_graph_ms(fns[name])
        dev_ms.setdefault(name, []).append(dv)
        print(f"  {name}: event {ev:.4f} ms, device {dv:.4f} ms (graph "
              f"replay), idle share {1 - dv / ev:.2f} [{card}]", flush=True)
    for name, base in (("8K 2 bands", "8K monolithic"),
                       ("8K 4 bands", "8K monolithic"),
                       ("4K 2 views 2x2 grid", "4K 2 views monolithic")):
        ratio = min(dev_ms[name]) / min(dev_ms[base])
        work = rows[name] / rows[base]
        print(f"  {name} / {base}: device {ratio:.3f}x against rows "
              f"{rows[name]}/{rows[base]} = {work:.3f}x ({ratio / work:.3f} "
              f"of the work ratio)", flush=True)
    del z8, zs, z1, refs
    torch.cuda.empty_cache()
    return paths


# Crops of the >= 4K golden check as bench.py cuts them (crop_origins,
# golden_err_sampled): 64-aligned 256 x 256 interiors with 320 texels of
# margin on every side, evaluated with the frame's padded width
CROP_S, CROP_M = 256, 320


def crop_origins(h, w, k=3):
    """k deterministic 64-aligned interior crop origins with CROP_M margin
    (bench.py's rule)."""
    lo_r = (CROP_M + 63) // 64 * 64
    hi_r = (h - CROP_M - CROP_S) // 64 * 64
    lo_c = (CROP_M + 63) // 64 * 64
    hi_c = (w - CROP_M - CROP_S) // 64 * 64
    outs = []
    for i in range(k):
        f = (i + 1) / (k + 1)
        r = (lo_r + int(f * (hi_r - lo_r))) // 64 * 64
        c = (lo_c + int((1 - f) * (hi_c - lo_c))) // 64 * 64
        outs.append((r, c))
    return outs


def validity_band(ip, jp, ii, jj, h0, w0, r):
    """Texels whose previous-frame coordinate (full-res units) lies within
    BAND_EPS texels of a validity boundary of the resolve: the frame
    rectangle's edges and, with ``r``, the displacement window's.  These
    are the spec's only discontinuities; float32 rounding of the
    coordinate may put such a texel on either side (the boundary masking
    of tests/test_temporal.py)."""
    band = ((ip + 0.5).abs() < BAND_EPS) | ((ip - (h0 - 0.5)).abs()
                                            < BAND_EPS)
    band |= ((jp + 0.5).abs() < BAND_EPS) | ((jp - (w0 - 0.5)).abs()
                                             < BAND_EPS)
    if r is not None:
        band |= ((ip - ii).abs() - r).abs() < BAND_EPS
        band |= ((jp - jj).abs() - r).abs() < BAND_EPS
    return band


def phase_golden(dev, K, F, card):
    """17. Each path on the card against the port's float64 golden
    (``tpuao_torch.golden``) computed on the card from the same inputs,
    full frame at every size; returns the records of the ``golden`` line.
    """
    import numpy as np
    import torch

    from tpuao_torch.golden import reference as G
    from tpuao_torch.golden import temporal as GT
    from tpuao_torch.models.pipeline import (TemporalAOEngine, render_frame,
                                             single_scale_ao)
    from tpuao_torch.models.presets import preset
    from tpuao_torch.ops import prepare as P
    from tpuao_torch.params import (AOParams, CameraParams, TemporalParams,
                                    padded_shape)

    print(f"golden (tpuao_torch.golden, float64 on the card) [{card}]:")
    cam, cam_hw = CameraParams(depth_mode="linear"), CameraParams()
    records = []

    def golden(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def hold(path, got, want, secs, mask=None, **extra):
        """max |got - want| over the texels (outside ``mask``), in float64;
        fails above TOL_GOLDEN."""
        if tuple(got.shape) != tuple(want.shape):
            raise RuntimeError(f"golden {path}: shape {tuple(got.shape)} "
                               f"!= {tuple(want.shape)}")
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"golden {path}: non-finite values")
        diff = (got.double() - want).abs()
        if mask is not None:
            diff = diff[~mask]
        err = float(diff.max())
        rec = {"path": path, "shape": list(got.shape), "max_abs_err": err,
               "golden_s": secs, "full_err": True, **extra}
        records.append(rec)
        print(f"  {path} {tuple(got.shape)}: max_abs_err={err:.3e}, golden "
              f"{secs:.3f} s" + "".join(f", {k} {v}" for k, v in
                                        extra.items()), flush=True)
        if not err <= TOL_GOLDEN:
            raise RuntimeError(f"golden {path}: max_abs_err {err} > "
                               f"{TOL_GOLDEN}")
        return err

    def launched(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in K.launch_counts().items() if v}

    def frame(h, w, c, normals=False):
        """A sphere scene as the card's float32 input (hardware depth
        under ``cam_hw``), with raw (H, W, 3) normals."""
        z, n = F.spheres_on_plane(h, w, c, seed=SEED, with_normals=True)
        if c.depth_mode == "hardware":
            z = F.to_hardware_depth(z, c)
        d = torch.as_tensor(z.astype(np.float32), device=dev)
        return (d, torch.as_tensor(n.astype(np.float32), device=dev)
                if normals else None)

    S = GOLDEN_SIZES
    # the card's float64 against the CPU's
    d, n = frame(*S["check"], cam_hw, normals=True)
    for name in ("HIGH", "ULTRA"):
        par = preset(name)
        g, secs = golden(lambda: G.render_frame_golden(d, cam_hw, par, n))
        c = G.render_frame_golden(d.cpu(), cam_hw, par, n.cpu())
        diff = float((g.cpu() - c).abs().max())
        records.append({"path": f"golden cuda vs cpu, {name}",
                        "shape": list(g.shape), "max_abs_err": diff,
                        "golden_s": secs, "full_err": True})
        print(f"  golden on cuda vs cpu, {name} {S['check']}: max |diff| "
              f"{diff:.3e}", flush=True)
        if not diff <= TOL_GOLDEN_DEVICES:
            raise RuntimeError(f"golden cuda vs cpu {name}: {diff}")

    # the frame paths at 1080p: HIGH under auto and pallas ([BJ] config
    # 2), ULTRA with normals ([BJ] config 3), and the quality ladder
    h0, w0 = S["1080p"]
    d, _ = frame(h0, w0, cam_hw)
    for name in ("VERY_LOW", "LOW", "MEDIUM", "HIGH"):
        par = preset(name)
        want, secs = golden(lambda: G.render_frame_golden(d, cam_hw, par))
        for impl in ("auto", "pallas") if name == "HIGH" else ("auto",):
            got, run = launched(lambda: render_frame(d, cam_hw, par,
                                                     impl=impl))
            hold(f"{name} 1080p hardware depth impl={impl}", got, want,
                 secs, launches=run)
    du, nu = frame(h0, w0, cam, normals=True)
    par = preset("ULTRA")
    want, secs = golden(lambda: G.render_frame_golden(du, cam, par, nu))
    got, run = launched(lambda: render_frame(du, cam, par, normals=nu))
    hold("ULTRA 1080p normals impl=auto", got, want, secs, launches=run)

    # [BJ] config 1: single scale at 720p against the golden's level-1
    # render of the pick-one half-res plane (bench.py's config 1)
    h, w = S["720p"]
    d7, _ = frame(h, w, cam)
    p1 = AOParams(hierarchy_depth=1, enable_blur=False)
    dbg, secs = golden(lambda: G.render_frame_golden(
        d7, cam, p1, return_debug=True)[1])
    got, run = launched(lambda: single_scale_ao(d7, cam, p1))
    hold("single_scale_ao 720p", got,
         dbg["ao_levels"][1][:-(-h // 2), :-(-w // 2)], secs, launches=run)

    # 4K and 8K, full frame; the sampled crops of the >= 4K golden check
    # against the same crops of the full-frame golden
    crops = []
    for label, name, c in (("4K", "HIGH", cam_hw), ("4K", "ULTRA", cam),
                           ("8K", "HIGH", cam_hw)):
        (h, w), par = S[label], preset(name)
        d, n = frame(h, w, c, normals=par.use_normals)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        want, secs = golden(lambda: G.render_frame_golden(d, c, par, n))
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        got, run = launched(lambda: render_frame(d, c, par, normals=n))
        hold(f"{name} {label} impl=auto", got, want, secs, launches=run,
             golden_peak_gib=round(peak, 3))
        del got
        if name == "HIGH":
            wp = padded_shape(h, w)[1]
            worst, t_crops = 0.0, 0.0
            for r0, c0 in crop_origins(h, w):
                zc = d[r0 - CROP_M:r0 + CROP_S + CROP_M,
                       c0 - CROP_M:c0 + CROP_S + CROP_M]
                g, s = golden(lambda: G.render_frame_golden(
                    zc, c, par, full_width=wp))
                t_crops += s
                inner = g[CROP_M:CROP_M + CROP_S, CROP_M:CROP_M + CROP_S]
                worst = max(worst, float((inner - want[
                    r0:r0 + CROP_S, c0:c0 + CROP_S]).abs().max()))
            crops.append({"path": f"{name} {label}", "crops": 3,
                          "origins": crop_origins(h, w),
                          "max_diff_vs_full_frame": worst,
                          "golden_s": t_crops})
            print(f"  {name} {label} sampled crops ({CROP_S} + {CROP_M} "
                  f"margin, 3 at {crop_origins(h, w)}) vs the full-frame "
                  f"golden: max |diff| {worst:.3e}, {t_crops:.3f} s",
                  flush=True)
        del d, n, want
        torch.cuda.empty_cache()

    # the temporal path: TemporalAOEngine on a 1080p hardware-depth dolly
    # (HIGH, 6 frames) at resolve_level 0 and 1, and driven by per-pixel
    # motion vectors at level 0.  Each frame is held against the golden
    # step from the engine's own history (the validity band masked, see
    # validity_band); the whole sequence against the sequence oracle is
    # printed beside it, band and all
    t_n = 6
    frames, views = dolly_frames(F, cam_hw, h0, w0, t_n)
    depths = torch.stack([torch.as_tensor(F.to_hardware_depth(z, cam_hw)
                                          .astype(np.float32), device=dev)
                          for z, _ in frames])
    motions = [None] + [views[t - 1] @ np.linalg.inv(views[t])
                        for t in range(1, t_n)]
    mv = torch.zeros(h0, w0, 2, device=dev)
    mv[..., 1] = -1.5
    par, tp = preset("HIGH"), TemporalParams()
    r = tp.max_displacement
    ii = torch.arange(h0, dtype=torch.float64, device=dev)[:, None]
    jj = torch.arange(w0, dtype=torch.float64, device=dev)[None, :]
    h1, w1 = -(-h0 // 2), -(-w0 // 2)
    for label, rl, kind in (("dolly", 0, "view"), ("dolly", 1, "view"),
                            ("motion vectors", 0, "mv")):
        eng = TemporalAOEngine(cam_hw, par, resolve_level=rl)
        outs, states, total = [], [], {}
        for t in range(t_n):
            kw = ({"view": views[t]} if kind == "view" else
                  {"motion": mv} if t else {})
            got, run = launched(lambda: eng.render(depths[t], **kw))
            outs.append(got)
            states.append(eng._state)
            total = {k: total.get(k, 0) + v for k, v in run.items()}
        mot = ([None] + [mv] * (t_n - 1) if kind == "mv" else motions)
        secs, step_err, band_err, seq_err, n_band = 0.0, 0.0, 0.0, 0.0, 0
        seq_state = None
        for t in range(t_n):
            prev = states[t - 1] if t else None
            if rl == 0:
                (ao, linz), s = golden(lambda: (
                    G.render_frame_golden(depths[t], cam_hw, par),
                    G.linearize_depth(depths[t], cam_hw)))
                null = (torch.ones_like(linz),
                        torch.full_like(linz, GT.NULL_DEPTH))
                (want, seq_out), s2 = golden(lambda: tuple(
                    GT.temporal_resolve_golden(ao, linz, *hist, cam_hw, tp,
                                               mot[t])
                    for hist in (prev or null, seq_state or null)))
                seq_state = (seq_out, linz)
                band = None
                if mot[t] is not None:
                    ip, jp = (GT.mv_coords(mot[t]) if kind == "mv" else
                              GT.reproject_coords(linz, cam_hw, mot[t])[:2])
                    band = validity_band(ip, jp, ii, jj, h0, w0, r)
            else:
                (want, _), s = golden(
                    lambda: GT.render_frame_l1_temporal_golden(
                        depths[t], prev, cam_hw, par, tp, mot[t]))
                (seq_out, seq_state), s2 = golden(
                    lambda: GT.render_frame_l1_temporal_golden(
                        depths[t], seq_state, cam_hw, par, tp, mot[t]))
                band = None
                if mot[t] is not None:
                    d1 = G.build_pyramid(G.linearize_depth(
                        depths[t], cam_hw), 1)[1]
                    ip, jp, _, _ = GT.reproject_coords_l1(d1, h0, w0, cam_hw,
                                                          mot[t])
                    b1 = validity_band(ip, jp, 2.0 * ii[:h1], 2.0 * jj[:, :w1],
                                       h0, w0, r)
                    # a half-res texel reaches the full-res texels of the
                    # lift's 3x3 filter and 2x2 taps: two texels around it
                    b1 = torch.nn.functional.max_pool2d(
                        b1[None, None].float(), 5, 1, 2)[0, 0] > 0
                    band = b1.repeat_interleave(2, 0).repeat_interleave(
                        2, 1)[:h0, :w0]
            secs += s + s2
            got = outs[t]
            diff = (got.double() - want).abs()
            if band is not None and bool(band.any()):
                n_band += int(band.sum())
                band_err = max(band_err, float(diff[band].max()))
                diff = diff[~band]
            step_err = max(step_err, float(diff.max()))
            seq_err = max(seq_err, float((got.double() - seq_out).abs()
                                         .max()))
        path = f"temporal {label} resolve_level={rl}"
        records.append({"path": path, "shape": [t_n, h0, w0],
                        "max_abs_err": step_err, "golden_s": secs,
                        "full_err": True, "sequence_err": seq_err,
                        "band_texels": n_band, "band_err": band_err,
                        "launches": total})
        print(f"  {path}, {t_n} frames: each step vs the golden step from "
              f"the engine's history max_abs_err={step_err:.3e} "
              f"({n_band} texels in the validity band, masked, their max "
              f"|diff| {band_err:.3e}); whole sequence vs the sequence "
              f"oracle {seq_err:.3e}; golden {secs:.3f} s; launches "
              f"{total}", flush=True)
        if not step_err <= TOL_GOLDEN:
            raise RuntimeError(f"golden {path}: {step_err} > {TOL_GOLDEN}")
    del depths, frames, outs, states
    torch.cuda.empty_cache()

    # the two kernels no impl reaches, through their entry points at
    # level 1 of 1080p (linear depth)
    d, _ = frame(h0, w0, cam)
    hp, wp = padded_shape(h0, w0)
    zp = torch.nn.functional.pad(d[None], (0, wp - w0, 0, hp - h0),
                                 mode="replicate")[0]
    pyr = [x.contiguous() for x in P.build_pyramid(P.linearize_depth(zp, cam),
                                                   4)]
    (_, dbg), secs = golden(lambda: G.render_frame_golden(
        d, cam, par, return_debug=True))
    got, run = launched(lambda: K.render_ao_level_dma(pyr[1], 1, wp, cam,
                                                      par))
    hold("render_ao_level_dma 1080p level 1", got, dbg["ao_levels"][1], secs,
         launches=run)
    c1 = chain_inputs(K, cam, par, pyr, wp)[1]
    want, s = golden(lambda: G.blur_upsample_step(
        c1, dbg["pyramid"][1], dbg["pyramid"][0], par, wp,
        lo_ao2=dbg["ao_levels"][1])[:h0, :w0])
    got, run = launched(lambda: K.fused_render_upsample_step_zc(
        pyr[1], c1, pyr[0], 1, wp, cam, par, crop_hw=(h0, w0)))
    hold("fused_render_upsample_step_zc 1080p 1->0", got, want, secs + s,
         launches=run)
    del d, zp, pyr, dbg, c1, want, got
    torch.cuda.empty_cache()
    return records, crops


def frame_peak(rows: int, w: int) -> tuple[int, int]:
    """Predicted peak bytes of one HIGH ``auto`` frame program call
    (``ao_pipeline``) on (rows, w) float32 hardware depth, beyond its
    input, and the bytes it still holds when its last step has written.
    Every launch, the prologue's too (``csrc/prepare.cu``: no padded copy,
    no linearising temporaries), allocates its outputs and nothing else,
    and the call holds them all to its end, so the two are one: the
    linear depth, pyramid levels 1-4, the level-4 AO, the chain's outputs
    at levels 3-1 and the cropped result."""
    rp, wp = -(-rows // 64) * 64, -(-w // 64) * 64
    plane = 4 * rp * wp
    end = plane + plane * (85 + 1 + 4 + 16 + 64) // 256 + 4 * rows * w
    return end, end


def sections_peak(h: int, w: int, k: int, halo: int) -> int:
    """Predicted peak bytes of ``render_frame_sections`` beyond its input:
    the output (allocated when the first section's result is in hand,
    beside it) plus the largest section's ``frame_peak``; sections that
    keep no row are not rendered."""
    from tpuao_torch.parallel.sections import section_plan

    out, peak, first = 4 * h * w, 0, True
    for a, b, off in section_plan(h, k, halo)[2]:
        if a + off >= h:
            continue
        rows = min(b, h) - a
        p = frame_peak(rows, w)[0]
        peak = max(peak, p, 4 * rows * w + out) if first else max(peak,
                                                                   out + p)
        first = False
    return peak


def section_rows(h: int, k: int, halo: int) -> int:
    """Rows the frame program runs on over a plan: each rendered section's
    rows, padded to 64 as the program pads them."""
    from tpuao_torch.parallel.sections import section_plan

    return sum(-(-(min(b, h) - a) // 64) * 64
               for a, b, off in section_plan(h, k, halo)[2] if a + off < h)


def phase_sections(chk, dev, K, F, card):
    """18. Sequential sections on one card (``tpuao_torch.parallel.
    sections``): 8K HIGH ``auto`` at k = 2, 4, 8 and fused at k = 2, 4,
    each bit-equal to the monolithic frame, within TOL_GOLDEN of the
    golden, launching k times the frame's kernels, with its peak memory
    beside the prediction; device ms by graph replay and event ms beside
    the monolithic frame's and the work ratio, in turns; 4K ULTRA with
    normals and uint8 colour at k = 3; 1080p at k = 8 (a clamped plan:
    the separate form equals the frame, the fused form raises); a
    16K-class frame's peak memory at k = 1 (monolithic), 2, 4, 8, each
    against the golden; ``render --sections 4`` on an 8K PFM bit-equal to
    ``render_frame_sections``.  Returns each path's launch counts."""
    import numpy as np
    import torch

    from tpuao_torch.golden import reference as G
    from tpuao_torch.models.pipeline import AmbientOcclusionEngine, render_frame
    from tpuao_torch.models.presets import preset
    from tpuao_torch.params import AOParams, CameraParams
    from tpuao_torch.parallel.sections import (render_frame_sections,
                                               render_frame_sections_fused,
                                               section_plan)
    from tpuao_torch.parallel.spatial import stencil_halo_rows
    from tpuao_torch.utils.frameio import load_pfm, save_pfm
    from tpuao_torch.utils.timing import cuda_graph_ms, cuda_time_ms

    cam_hw, par = CameraParams(), AOParams()
    halo = stencil_halo_rows(par)
    per = counts(prepare_levels=1, render_ao_level=1, blur_upsample_step=1,
                 fused_render_upsample_step=3)
    times = lambda c, n: {k: v * n for k, v in c.items()}
    paths, records = {}, []
    S = SECTION_SIZES
    print(f"sections (one card, halo {halo} rows) [{card}]:")

    def run(label, fn, want):
        """``fn()`` with its launches counted and its peak memory read:
        (output, peak allocated and reserved bytes beyond what was
        allocated and reserved just before)."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        base_r = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        expect_counts(K, label, want)
        paths[label] = K.launch_counts()
        if out.device != dev:
            raise RuntimeError(f"{label} ran on {out.device}, not {dev}")
        return (out, torch.cuda.max_memory_allocated() - base,
                torch.cuda.max_memory_reserved() - base_r)

    def hold(label, got, want, gold, peak, predicted, **extra):
        """``got`` against the monolithic frame ``want`` (bit for bit; None
        for the monolithic frame itself) and the float64 golden
        (TOL_GOLDEN), with its peak memory beside the prediction; one
        record."""
        rec = {"path": label, "shape": list(got.shape)}
        line = f"  {label}:"
        if want is not None:
            rec["vs_monolithic"] = chk.close("", label, got, want, tol=0.0,
                                             quiet=True)
            line += f" vs the monolithic frame {rec['vs_monolithic']:.3e},"
        g = float((got.double() - gold).abs().max())
        rec.update(vs_golden=g, **extra)
        line += f" vs the golden {g:.3e}"
        rec.update(peak_alloc_mb=peak[0] / 1e6, peak_reserved_mb=peak[1] /
                   1e6, predicted_mb=predicted / 1e6)
        line += (f"; peak allocated {peak[0] / 1e6:.1f} MB (predicted "
                 f"{predicted / 1e6:.1f}), reserved {peak[1] / 1e6:.1f} MB, "
                 "beyond what was allocated before")
        records.append(rec)
        print(line + "".join(f", {k} {v}" for k, v in extra.items()),
              flush=True)
        if not g <= TOL_GOLDEN:
            raise RuntimeError(f"{label}: vs the golden {g} > {TOL_GOLDEN}")

    def depth(h, w, seed=SEED):
        z = F.to_hardware_depth(F.spheres_on_plane(h, w, cam_hw, seed=seed),
                                cam_hw)
        return torch.as_tensor(z.astype(np.float32), device=dev)

    # 8K HIGH auto, depth only: the separate and fused forms
    h8, w8 = S["8K"]
    d8 = depth(h8, w8)
    mono, *pk = run("sections 8K monolithic", lambda: render_frame(
        d8, cam_hw, par), per)
    gold = G.render_frame_golden(d8, cam_hw, par)
    hold("8K monolithic", mono, None, gold, pk, frame_peak(h8, w8)[0],
         rows=section_rows(h8, 1, halo))
    forms = {"separate": render_frame_sections,
             "fused": render_frame_sections_fused}
    fns = {"8K monolithic": lambda: render_frame(d8, cam_hw, par)}
    outs8 = {}
    for form, k in (("separate", 2), ("separate", 4), ("separate", 8),
                    ("fused", 2), ("fused", 4)):
        label = f"8K k={k} {form}"
        fn = (lambda f=forms[form], k=k: f(d8, cam_hw, par, n_sections=k))
        out, *pk = run(f"sections {label}", fn, times(per, k))
        outs8[k] = out
        hold(label, out, mono, gold, pk, sections_peak(h8, w8, k, halo),
             launches=6 * k, rows=section_rows(h8, k, halo))
        fns[label] = fn
    del gold
    # times, in turns: the monolithic frame beside its sections
    base_rows = section_rows(h8, 1, halo)
    order = list(fns) + list(fns)[::-1]
    dev_ms = {}
    for name in order:
        ev, dv = cuda_time_ms(fns[name]), cuda_graph_ms(fns[name])
        dev_ms.setdefault(name, []).append((dv, ev))
        print(f"  {name}: event {ev:.4f} ms, device {dv:.4f} ms (graph "
              f"replay) [{card}]", flush=True)
    mono_dv = min(d for d, _ in dev_ms["8K monolithic"])
    for name in list(fns)[1:]:
        k = int(name.split("k=")[1].split()[0])
        rows = section_rows(h8, k, halo)
        ratio = min(d for d, _ in dev_ms[name]) / mono_dv
        print(f"  {name} / 8K monolithic: device {ratio:.3f}x against rows "
              f"{rows}/{base_rows} = {rows / base_rows:.3f}x", flush=True)
        for rec in records:
            if rec["path"] == name:
                rec.update(device_ms=[d for d, _ in dev_ms[name]],
                           event_ms=[e for _, e in dev_ms[name]])
    records[0].update(device_ms=[d for d, _ in dev_ms["8K monolithic"]],
                      event_ms=[e for _, e in dev_ms["8K monolithic"]])

    # the CLI: render --sections 4 on an 8K PFM
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = pathlib.Path(tmp) / "d8k.pfm", pathlib.Path(tmp) / "o.pfm"
        save_pfm(str(src), d8.cpu().numpy())
        cli_counts(K, "render --sections 4, 8K PFM", times(per, 4),
                   ["render", src, dst, "--sections", 4])
        got = torch.as_tensor(load_pfm(str(dst)))
        chk.close("", "render --sections 4 (8K PFM) vs "
                  "render_frame_sections", got, outs8[4].cpu(), tol=0.0)
    del d8, mono, outs8, fns
    torch.cuda.empty_cache()

    # 4K ULTRA with normals and uint8 colour, 3 sections
    ultra = preset("ULTRA")
    h4, w4 = S["4K"]
    z4, n4 = F.spheres_on_plane(h4, w4, cam_hw, seed=SEED + 1,
                                with_normals=True)
    d4 = torch.as_tensor(F.to_hardware_depth(z4, cam_hw).astype(np.float32),
                         device=dev)
    n4 = torch.as_tensor(n4.astype(np.float32), device=dev)
    rgb = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, 256, (h4, w4, 3), dtype=np.uint8), device=dev)
    want = render_frame(d4, cam_hw, ultra, normals=n4, color=rgb,
                        out_dtype="uint8")
    eng = AmbientOcclusionEngine(cam_hw, ultra, out_dtype="uint8")
    got, *_ = run("sections ULTRA 4K k=3", lambda: eng.render_sections(
        d4, 3, normals=n4, color=rgb),
        counts(prepare_levels=3, render_ao_level_normals=12,
               blur_upsample_step=12))
    if got.dtype != torch.uint8 or tuple(got.shape) != (h4, w4, 3):
        raise RuntimeError(f"ULTRA sections gave {got.dtype} {got.shape}")
    err = chk.close("", "4K ULTRA, normals, uint8 colour, k=3 "
                    "(engine.render_sections), launches 3/12/12, vs the "
                    "monolithic frame (codes)", got, want, tol=1)
    records.append({"path": "4K ULTRA k=3 uint8 colour",
                    "shape": list(got.shape), "vs_monolithic": err})
    del d4, n4, rgb, want, got

    # 1080p on 8 sections: a clamped plan (band 192 < halo 320)
    h1, w1 = S["1080p"]
    d1 = depth(h1, w1)
    want = render_frame(d1, cam_hw, par)
    kept = sum(a + off < h1 for a, _, off in section_plan(h1, 8, halo)[2])
    got, *_ = run("sections 1080p k=8 (clamped)", lambda:
                  render_frame_sections(d1, cam_hw, par, n_sections=8),
                  times(per, kept))
    err = chk.close("", f"1080p k=8 (clamped plan, {kept} sections keep "
                    f"rows, launches {6 * kept}) vs the monolithic frame",
                    got, want, tol=0.0)
    records.append({"path": "1080p k=8 clamped", "shape": list(got.shape),
                    "vs_monolithic": err, "launches": 6 * kept})
    try:
        render_frame_sections_fused(d1, cam_hw, par, n_sections=8)
    except ValueError as e:
        print(f"  1080p k=8 fused: raises ValueError ({e})", flush=True)
    else:
        raise RuntimeError("the fused form took a clamped plan")
    del d1, want, got
    torch.cuda.empty_cache()

    # the 16K-class frame: peak memory at k = 1, 2, 4, 8, each vs the
    # golden (and the sections vs the monolithic frame)
    h16, w16 = S["16K"]
    d16 = depth(h16, w16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gold = G.render_frame_golden(d16, cam_hw, par)
    torch.cuda.synchronize()
    print(f"  16K golden: peak "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB",
          flush=True)
    mono, *pk = run("sections 16K monolithic", lambda: render_frame(
        d16, cam_hw, par), per)
    hold("16K monolithic", mono, None, gold, pk, frame_peak(h16, w16)[0],
         rows=section_rows(h16, 1, halo))
    mono_peak = pk[0]
    for k in (2, 4, 8):
        out, *pk = run(f"sections 16K k={k}", lambda k=k:
                       render_frame_sections(d16, cam_hw, par,
                                             n_sections=k), times(per, k))
        hold(f"16K k={k} separate", out, mono, gold, pk,
             sections_peak(h16, w16, k, halo), launches=6 * k,
             rows=section_rows(h16, k, halo))
        if k >= 4 and not pk[0] < mono_peak:
            raise RuntimeError(f"16K k={k}: peak {pk[0]} B not below the "
                               f"monolithic frame's {mono_peak} B")
        del out
    del d16, gold, mono
    torch.cuda.empty_cache()
    return paths, records


def tile_cases(K, cam, par, pn, pyr, spyr, npyr, wp, h0, w0):
    """Phase 19a's launches of one frame (batch): (kernel, Checks key,
    label, (lh, lw), crop, call, plain call, tolerance) for the render at
    levels 1-4 (depth-only, slopes, raw normals), the upsample steps 4->3
    .. 1->0 (pre-min below the coarsest, the last cropped) and the fused
    steps 3->2 .. 1->0, each on the combined AO the kernels make below
    it."""
    aos = {l: K.render_ao_level(pyr[l], l, wp, cam, par) for l in range(1, 5)}
    up = {4: aos[4]}
    for l in (4, 3, 2, 1):
        up[l - 1] = K.blur_upsample_step(
            up[l], pyr[l], pyr[l - 1], par, wp,
            lo_ao2=None if l == 4 else aos[l],
            crop_hw=(h0, w0) if l == 1 else None)
    c = {3: up[3]}
    for l in (3, 2):
        c[l - 1] = K.fused_render_upsample_step(pyr[l], c[l], pyr[l - 1], l,
                                                wp, cam, par)
    cases = []
    for l in range(1, 5):
        d, lo = pyr[l], tuple(pyr[l].shape[-2:])
        cases.append(("render_ao_level", "render", f"render l{l}", lo, None,
                      lambda d=d, l=l: K.render_ao_level(d, l, wp, cam, par),
                      lambda d=d, l=l: K.render_ao_level_plain(d, l, wp, cam,
                                                               par),
                      TOL_EXACT))
        for mode, kw in (("slopes", {"slopes_ds": spyr[l]}),
                         ("raw normals", {"normals_ds": npyr[l]})):
            cases.append((
                "render_ao_level_normals", "render_normals",
                f"normals ({mode}) l{l}", lo, None,
                lambda d=d, l=l, kw=kw: K.render_ao_level_normals(
                    d, l, wp, cam, pn, **kw),
                lambda d=d, l=l, kw=kw: K.render_ao_level_normals_plain(
                    d, l, wp, cam, pn, **kw), TOL_EXACT))
    for l in (4, 3, 2, 1):
        crop = (h0, w0) if l == 1 else None
        kw = {"lo_ao2": None if l == 4 else aos[l], "crop_hw": crop}
        cases.append((
            "blur_upsample_step", "upsample", f"upsample {l}->{l - 1}",
            tuple(pyr[l].shape[-2:]), crop,
            lambda l=l, kw=kw: K.blur_upsample_step(
                up[l], pyr[l], pyr[l - 1], par, wp, **kw),
            lambda l=l, kw=kw: K.blur_upsample_step_plain(
                up[l], pyr[l], pyr[l - 1], par, wp, **kw), TOL))
    for l in (3, 2, 1):
        crop = (h0, w0) if l == 1 else None
        cases.append((
            "fused_render_upsample_step", "fused", f"fused {l}->{l - 1}",
            tuple(pyr[l].shape[-2:]), crop,
            lambda l=l, crop=crop: K.fused_render_upsample_step(
                pyr[l], c[l], pyr[l - 1], l, wp, cam, par, crop_hw=crop),
            lambda l=l, crop=crop: K.fused_render_upsample_step_plain(
                pyr[l], c[l], pyr[l - 1], l, wp, cam, par, crop_hw=crop),
            TOL))
    return cases


def tune_cli(argv) -> dict:
    """``python -m tpuao_torch tune ...`` in-process; its JSON."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_cli(["tune", *argv])
    return json.loads(buf.getvalue())


def phase_tune(chk, dev, K, P, R, F, card, tmp):
    """19. The tile rows of the tiled kernels (``utils/launch_opts``):
    (a) the render (depth-only, and with normals in both modes), the
    upsample and the fused steps at every instance of their texels a
    thread, at every level of 1080p, 4K and 8K frames at one and four
    frames a call: each output bit-equal to the rule's, the rule's within
    its bound of the plain version, a value with no instance refused by
    the table and by the launcher (0, which the table reads as no entry,
    at the C entry point), and the graph-replay ms of each instance
    beside the rule's;
    (b) ``tune`` through the CLI (1080p at one and four frames, 1440p,
    1080p with normals) into one cache file, then a fresh process
    rendering a 1440p PFM with ``--autotune-cache``, bit-equal to the
    untuned render with the same launches; (c) ``stage_times_ms`` of HIGH
    and ULTRA 1080p, each stage beside its bound and the frame beside
    ``roofline.floors_ms``.  Returns ({path: launch counts}, records)."""
    import os

    import numpy as np
    import torch

    from tpuao_torch.models.presets import preset
    from tpuao_torch.ops import _build
    from tpuao_torch.params import AOParams, CameraParams
    from tpuao_torch.utils import launch_opts as L
    from tpuao_torch.utils import roofline
    from tpuao_torch.utils.frameio import load_pfm, save_pfm
    from tpuao_torch.utils.profiling import stage_times_ms
    from tpuao_torch.utils.timing import cuda_graph_ms

    lib = _build.load()
    cam = CameraParams(depth_mode="linear")
    par, pn = AOParams(), AOParams(use_normals=True)
    L.clear_tuned_tiles()
    records = {"sweep": [], "tune": [], "stages": {}}

    # (a) every instance of every launch against the rule's output
    print(f"tile rows (a): each instance against the rule, graph-replay "
          f"device ms [{card}]:")
    for size, (h0, w0) in TUNE_SIZES.items():
        for batch in (1, 4):
            pyr, spyr, npyr, wp = normals_pyramid(dev, P, R, F, cam, h0, w0,
                                                  batch)
            cases = tile_cases(K, cam, par, pn, pyr, spyr, npyr, wp, h0, w0)
            for kernel, key, label, (lh, lw), crop, fn, plain, tol in cases:
                h_out, w_out = crop or (2 * lh, 2 * lw)
                rule = L.rule_nt(kernel, batch, lh, lw, h_out, w_out)
                ref = fn()
                chk.close(key, f"{size} x{batch} {label} rule vs plain", ref,
                          plain(), tol=tol, quiet=True)
                ms = {}
                for nt in L.VALID_NT[kernel]:
                    L.set_tuned_tiles(kernel, batch, lh, lw, nt)
                    got = fn()
                    if not torch.equal(got, ref):
                        raise RuntimeError(
                            f"{size} x{batch} {label}: nt={nt} differs from "
                            f"the rule's output by "
                            f"{float((got - ref).abs().max())}")
                    ms[nt] = cuda_graph_ms(fn)
                L.clear_tuned_tiles()
                best = min(ms, key=ms.get)
                print(f"  {size} x{batch} {label} ({lh}x{lw}): rule nt={rule};"
                      f" " + ", ".join(f"nt={nt} {t:.4f}"
                                       for nt, t in ms.items()) +
                      f" ms; fastest nt={best}, rule / fastest "
                      f"{ms[rule] / ms[best]:.3f}x [{card}]", flush=True)
                records["sweep"].append({
                    "size": size, "batch": batch, "launch": label,
                    "kernel": kernel, "lo": [lh, lw], "rule": rule,
                    "ms": {str(k): v for k, v in ms.items()}})
            if (size, batch) == ("1080p", 1):
                # a value with no instance: the table refuses it, and the
                # launcher refuses it where it gets past the table
                refused = set()
                for kernel, _, label, (lh, lw), _, fn, _, _ in cases:
                    if kernel in refused:
                        continue
                    bad = TUNE_INVALID[kernel]
                    try:
                        L.set_tuned_tiles(kernel, 1, lh, lw, bad)
                    except ValueError:
                        pass
                    else:
                        raise RuntimeError(f"set_tuned_tiles took {kernel} "
                                           f"nt={bad}")
                    L._TUNED[(kernel, 1, lh, lw)] = bad
                    try:
                        fn()
                    except RuntimeError as e:
                        if "CUDA error" not in str(e):
                            raise
                    else:
                        raise RuntimeError(f"{label}: nt={bad} launched")
                    finally:
                        L.clear_tuned_tiles()
                    # 0 is no entry to the table (the launch takes the
                    # rule): the C entry point gets it directly, with the
                    # arguments the wrapper passes
                    launched, saved = [], K._launch
                    K._launch = lambda entry, *args: launched.append(
                        (entry, args))
                    try:
                        kept = fn()
                    finally:
                        K._launch = saved
                    [(entry, args)] = launched
                    err = getattr(lib, entry)(*args[:-3], 0, *args[-2:])
                    torch.cuda.synchronize()
                    if err != 1:  # cudaErrorInvalidValue
                        raise RuntimeError(f"{label}: nt=0 gave {err}")
                    del kept
                    refused.add(kernel)
                print(f"  {sorted(refused)}: a value with no instance, 0 "
                      f"among them, raises (ValueError in the table, "
                      f"cudaErrorInvalidValue from the launcher)",
                      flush=True)
            del pyr, spyr, npyr, cases
            torch.cuda.empty_cache()

    # (b) tune through the CLI into one cache, then a fresh process
    cache = tmp / "autotune.json"
    print(f"tile rows (b): tune through the CLI into {cache.name} [{card}]:")
    for argv in (["1080x1920"], ["1080x1920", "--batch", "4"],
                 ["1440x2560"], ["1080x1920", "--normals"]):
        res = tune_cli([*argv, "--save", str(cache)])
        for launch, sweep in res["sweep_ms"].items():
            rule, best = res["default"][launch], res["best"][launch]
            print(f"  tune {' '.join(argv)}: {launch}: rule nt={rule}; " +
                  ", ".join(f"nt={nt} {t:.4f}" for nt, t in sweep.items()) +
                  f" ms; tuned nt={best} [{card}]")
        fm = res["frame_ms"]
        gain = fm["default"] / fm["tuned"]
        print(f"  tune {' '.join(argv)}: frame {fm['default']:.4f} ms at the "
              f"rule, {fm['tuned']:.4f} ms tuned ({gain:.3f}x) [{card}]",
              flush=True)
        records["tune"].append({"argv": argv, **res})
    saved = json.loads(cache.read_text())
    keys = {(e["kernel"], e["batch"], e["h"], e["w"])
            for e in saved["entries"]}
    swept = {k for k in L._TUNED}
    if saved["device_kind"] != torch.cuda.get_device_name() or keys != swept:
        raise RuntimeError(f"{cache.name} holds {sorted(keys)} on "
                           f"{saved['device_kind']!r}, the tuned table "
                           f"{sorted(swept)}")
    L.clear_tuned_tiles()
    cam_hw = CameraParams()
    z = F.to_hardware_depth(F.spheres_on_plane(1440, 2560, cam_hw, seed=SEED),
                            cam_hw).astype(np.float32)
    src, untuned, tuned = (str(tmp / n) for n in ("d1440.pfm", "u.pfm",
                                                   "t.pfm"))
    save_pfm(src, z)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    with K.record_launches() as record:
        run_cli(["render", src, untuned])
    torch.cuda.synchronize()
    want = K.launch_counts()
    frame_keys = {launch.key for launch in record}
    if not frame_keys <= keys:
        raise RuntimeError(f"the 1440p render's launches "
                           f"{sorted(frame_keys - keys)} are not in the cache")
    code = ("import json, sys\n"
            "from tpuao_torch import cli\n"
            "from tpuao_torch.ops import kernels as K\n"
            "from tpuao_torch.utils import launch_opts as L\n"
            "rc = cli.main(sys.argv[1:])\n"
            "print(json.dumps({'counts': K.launch_counts(), 'table': "
            "len(L._TUNED)}))\n"
            "sys.exit(rc)\n")
    root = pathlib.Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", code, "render", src, tuned,
         "--autotune-cache", str(cache)], cwd=root, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(root)})
    sec = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"render --autotune-cache: exit {proc.returncode}"
                           f"\n{proc.stdout}{proc.stderr}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    same = np.array_equal(load_pfm(tuned), load_pfm(untuned))
    print(f"  fresh process: render 1440p --autotune-cache ({got['table']} "
          f"entries loaded): launches {got['counts']}, bit-equal to the "
          f"untuned render: {same}, {sec:.2f} s", flush=True)
    if got["counts"] != want or not same or got["table"] != len(keys):
        raise RuntimeError(f"the tuned 1440p render: {got}, untuned "
                           f"launches {want}, bit-equal {same}")

    # (c) stage times beside their bounds
    print(f"stage times (c): graph-replay device ms, bound and share "
          f"[{card}]:")
    zn, nn = F.spheres_on_plane(1080, 1920, cam, seed=SEED, with_normals=True)
    zt = torch.as_tensor(zn, dtype=torch.float32, device=dev)
    nt_ = torch.as_tensor(nn, dtype=torch.float32, device=dev)
    for name in ("HIGH", "ULTRA"):
        p = preset(name)
        st = stage_times_ms(zt, cam, p, normals=nt_ if p.use_normals else None)
        work = roofline.stage_work(1080, 1920, p)
        for stage, ms in st.items():
            if stage == "full_pipeline":
                ops = sum(o for o, _ in work.values())
                fl = roofline.floors_ms(ms, 1080, 1920, ops=ops,
                                        use_normals=p.use_normals)
                print(f"  {name} {stage}: {ms:.4f} ms; floors_ms: memory "
                      f"{fl['mem_floor_ms']:.4f}, operations "
                      f"{fl['flop_floor_ms']:.4f}, {fl['pct_of_roofline']:.1f}"
                      f"% of the roofline [{card}]")
                records["stages"][name] = {"ms": st, "floors": fl}
            else:
                b_ms, b_by = roofline.bound(*work[stage])
                print(f"  {name} {stage}: {ms:.4f} ms, bound {b_ms:.4f} ms "
                      f"({b_by}), share {b_ms / ms:.1%} [{card}]")
    return {"tuned 1440p render": got["counts"]}, records


@contextlib.contextmanager
def kernel_library(lib):
    """Every wrapper launches from ``lib`` (a library built from another
    tree's kernels, with the same entry points) inside the block."""
    from tpuao_torch.ops import _build

    saved = _build.load
    _build.load = lambda *a: lib
    try:
        yield
    finally:
        _build.load = saved


def phase_parent(dev, K, P, R, F, cam, card, parent):
    """12. The kernels at the 1080p, 4K and 8K shapes -- the render in its
    depth-only and slope modes, the DMA render beside it, the upsample
    step (the ULTRA chain of four steps at four 1080p frames, the 4K step
    1->0 with pre-min, HIGH's 4->3 at one frame), the fused and zero-copy
    steps side by side, the windowed resolve beside its library yardstick
    (grid_sample, never called by the port) -- and the HIGH and ULTRA
    paths end to end at four 1080p frames a call: device ms per call from
    CUDA-graph replay, with each kernel's computed bound and roofline
    share, beside the kernels of ``parent`` (a ``tpuao_torch/csrc``
    directory of an older tree, or None), timed in turns: parent, new,
    new, parent; each kernel's output is held against the parent's
    (max |new - parent|)."""
    import numpy as np
    import torch

    from tpuao_torch.ops import _build
    from tpuao_torch.params import AOParams
    from tpuao_torch.utils.timing import cuda_graph_ms

    libs = {"new": _build.load()}
    if parent is not None:
        t0 = time.perf_counter()
        libs["parent"] = _build.load(pathlib.Path(parent))
        print(f"parent kernels ({parent}) built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    else:
        print(f"no parent kernels ({PARENT_CSRC} absent, no --parent): "
              "new times only")
    print(f"device ms per call: kernels by CUDA-graph replay, paths by "
          f"torch.profiler [{card}]:")
    par, pn = AOParams(), AOParams(use_normals=True)
    pyr = {k: level_pyramid(dev, P, F, cam, *hw) for k, hw in
           (("1080p", (1080, 1920)), ("4K", (2160, 3840)),
            ("8K", (4320, 7680)))}
    chains = {k: chain_inputs(K, cam, par, *v) for k, v in pyr.items()}
    npyr = {"1080p x4": normals_pyramid(dev, P, R, F, cam, 1080, 1920, 4),
            "4K": normals_pyramid(dev, P, R, F, cam, 2160, 3840)}

    def render(k, l):
        d, wp = pyr[k][0][l], pyr[k][1]
        return (lambda: K.render_ao_level(d, l, wp, cam, par),
                render_work(d.shape))

    def dma(k):
        d, wp = pyr[k][0][1], pyr[k][1]
        return (lambda: K.render_ao_level_dma(d, 1, wp, cam, par),
                render_work(d.shape))

    def normals(k):
        z, sl, _, wp = npyr[k]

        def fn():
            return [K.render_ao_level_normals(z[l], l, wp, cam, pn,
                                              slopes_ds=sl[l])
                    for l in range(1, 5)][-1]
        works = [render_work(z[l].shape, planes=2) for l in range(1, 5)]
        return fn, tuple(map(sum, zip(*works)))

    full = {"1080p": (1080, 1920), "4K": (2160, 3840), "8K": (4320, 7680)}

    def fused(k, levels):
        (z, wp), c = pyr[k], chains[k]
        hw = full[k]

        def fn():
            for l in levels:
                out = K.fused_render_upsample_step(
                    z[l], c[l], z[l - 1], l, wp, cam, par,
                    crop_hw=hw if l == 1 else None)
            return out
        works = [chain_work(z[l].shape, *(hw if l == 1 else
                                          tuple(z[l - 1].shape)),
                            npairs=34) for l in levels]
        return fn, tuple(map(sum, zip(*works)))

    def zc(k):
        (z, wp), c = pyr[k], chains[k]
        return (lambda: K.fused_render_upsample_step_zc(
                    z[1], c[1], z[0], 1, wp, cam, par, crop_hw=full[k]),
                chain_work(z[1].shape, *full[k], npairs=34))

    # the upsample step's inputs: each level's AO (the render kernel's;
    # the ULTRA chain's come from the normals render, at the same shapes)
    zu, _, _, wpu = npyr["1080p x4"]
    aos = {l: K.render_ao_level(zu[l], l, wpu, cam, par) for l in range(1, 5)}
    ao4k1 = K.render_ao_level(pyr["4K"][0][1], 1, pyr["4K"][1], cam, par)
    ao1080_4 = K.render_ao_level(pyr["1080p"][0][4], 4, pyr["1080p"][1], cam,
                                 par)

    def upsample_chain():  # the ULTRA path's chain, pipeline.py's calls
        def fn():
            c = aos[4]
            for l in (4, 3, 2, 1):
                c = K.blur_upsample_step(
                    c, zu[l], zu[l - 1], par, wpu,
                    lo_ao2=None if l == 4 else aos[l],
                    crop_hw=full["1080p"] if l == 1 else None)
            return c
        works = [chain_work(zu[l].shape, *(full["1080p"] if l == 1 else
                                           tuple(zu[l - 1].shape[-2:])),
                            lo_inputs=2 if l == 4 else 3)
                 for l in (4, 3, 2, 1)]
        return fn, tuple(map(sum, zip(*works)))

    def upsample_4k():  # the step 1->0 with pre-min, as the pallas path
        (z, wp), c = pyr["4K"], chains["4K"]
        return (lambda: K.blur_upsample_step(c[1], z[1], z[0], par, wp,
                                             lo_ao2=ao4k1,
                                             crop_hw=full["4K"]),
                chain_work(z[1].shape, *full["4K"], lo_inputs=3))

    def upsample_43():  # HIGH's one upsample launch, one frame
        z, wp = pyr["1080p"]
        return (lambda: K.blur_upsample_step(ao1080_4, z[4], z[3], par, wp),
                chain_work(z[4].shape, *z[3].shape))

    rng = np.random.default_rng(SEED)
    wins = {}  # the windowed cases' inputs, for the library yardstick

    def windowed(h, w, r, di=1.3, dj=-2.7):
        ii = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        jj = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
        f = [torch.as_tensor(rng.uniform(lo, hi, (h, w)), dtype=torch.float32,
                             device=dev) for lo, hi in ((0, 1), (0.05, 1))]
        ip = (ii + di).expand(h, w).contiguous()
        jp = (jj + dj).expand(h, w).contiguous()
        wins[(h, w, r)] = (f[0], f[1], ip, jp)
        return (lambda: K.windowed_resolve(f[0], f[1], ip, jp, r),
                (h * w * WINDOWED_OPS, 4 * 6 * h * w))

    cases = {
        ("render", "1080p level 4"): render("1080p", 4),
        ("render", "1080p level 1"): render("1080p", 1),
        ("dma", "1080p level 1"): dma("1080p"),
        ("render", "4K level 1"): render("4K", 1),
        ("dma", "4K level 1"): dma("4K"),
        ("render", "8K level 1"): render("8K", 1),
        ("dma", "8K level 1"): dma("8K"),
        ("render_normals", "1080p levels 1-4 x4"): normals("1080p x4"),
        ("render_normals", "4K levels 1-4"): normals("4K"),
        ("upsample", "ULTRA 1080p chain x4 (4->3 .. 1->0)"):
            upsample_chain(),
        ("upsample", "4K step 1->0, pre-min"): upsample_4k(),
        ("upsample", "HIGH 1080p 4->3, 1 frame"): upsample_43(),
        ("fused", "1080p steps 3->2, 2->1, 1->0"): fused("1080p", (3, 2, 1)),
        ("fused", "1080p step 1->0"): fused("1080p", (1,)),
        ("zc", "1080p step 1->0"): zc("1080p"),
        ("fused", "4K step 1->0"): fused("4K", (1,)),
        ("zc", "4K step 1->0"): zc("4K"),
        ("fused", "8K step 1->0"): fused("8K", (1,)),
        ("zc", "8K step 1->0"): zc("8K"),
        ("windowed", "1080p r=4"): windowed(1080, 1920, 4),
        ("windowed", "half-res r=2"): windowed(540, 960, 2, 0.6, -1.3),
        ("windowed", "8K r=4"): windowed(4320, 7680, 4),
    }
    # end to end: the main path and the ULTRA path, four frames a call
    from tpuao_torch.models.pipeline import (AmbientOcclusionEngine,
                                             render_frame)
    from tpuao_torch.models.presets import preset
    from tpuao_torch.params import CameraParams

    cam_hw = CameraParams()
    frames = torch.stack([torch.as_tensor(F.to_hardware_depth(
        F.spheres_on_plane(1080, 1920, cam_hw, seed=s), cam_hw),
        dtype=torch.float32, device=dev) for s in range(4)])
    zn = [F.spheres_on_plane(1080, 1920, cam, seed=s, with_normals=True)
          for s in range(4)]
    z4, n4 = (torch.as_tensor(np.stack([x[i] for x in zn]),
                              dtype=torch.float32, device=dev)
              for i in (0, 1))
    ultra = AmbientOcclusionEngine(cam, preset("ULTRA"))
    # (their prologues copy host scalars, which a graph cannot capture:
    # device time from the profiler instead)
    cases[("render_frame", "HIGH auto 1080p, 4 frames a call")] = (
        lambda: render_frame(frames, cam_hw, par, impl="auto"), "profile")
    cases[("AmbientOcclusionEngine", "ULTRA 1080p, 4 frames a call")] = (
        lambda: ultra.render(z4, normals=n4), "profile")
    out = {}
    order = (["parent"] if "parent" in libs else []) + ["new", "new"] + \
        (["parent"] if "parent" in libs else [])
    # a frame path launches the prologue, which an older tree's library
    # may lack: then the path runs on this tree's kernels alone
    whole = "parent" in libs and hasattr(libs["parent"],
                                         "tpuao_prepare_levels")
    for (kern, shape), (fn, work) in cases.items():
        ms = {}
        sides = order if work != "profile" or whole else ["new", "new"]
        for which in sides:
            with kernel_library(libs[which]):
                ms.setdefault(which, []).append(
                    device_profile(fn)[0] if work == "profile" else
                    cuda_graph_ms(fn))
        new = sum(ms["new"]) / 2
        line = (f"  {kern} {shape}: new {ms['new'][0]:.4f} / "
                f"{ms['new'][1]:.4f} ms")
        if "parent" in ms:
            old = sum(ms["parent"]) / 2
            line += (f", parent {ms['parent'][0]:.4f} / {ms['parent'][1]:.4f}"
                     f" ms, speedup {old / new:.2f}x")
        elif "parent" in libs:
            line += ", parent: no prologue"
        if work != "profile":
            b_ms, b_by = bound(*work)
            line += (f", bound {b_ms:.4f} ms ({b_by}), roofline share "
                     f"{b_ms / new:.1%}")
            if "parent" in libs:
                line += f", max |new - parent| {parent_diff(libs, fn):.3e}"
        line += f" [{card}]"
        print(line, flush=True)
        out[(kern, shape)] = ms
    for k in full:  # the variants beside their siblings, same call
        ratio = (sum(out[("zc", f"{k} step 1->0")]["new"]) /
                 sum(out[("fused", f"{k} step 1->0")]["new"]))
        print(f"  zc / fused, {k} step 1->0: {ratio:.3f}x [{card}]")
        ratio = (sum(out[("dma", f"{k} level 1")]["new"]) /
                 sum(out[("render", f"{k} level 1")]["new"]))
        print(f"  dma / render, {k} level 1: {ratio:.3f}x [{card}]")
    # the windowed resolve's library yardstick (never called by the port)
    for (kern, shape), (h, w, r) in (
            (("windowed", "1080p r=4"), (1080, 1920, 4)),
            (("windowed", "half-res r=2"), (540, 960, 2)),
            (("windowed", "8K r=4"), (4320, 7680, 4))):
        f0, f1, ip, jp = wins[(h, w, r)]
        lib = grid_sample_resolve(f0, f1, ip, jp)
        err = library_error(lib, K.windowed_resolve(f0, f1, ip, jp, r))
        lib_ms = cuda_graph_ms(lib)
        new = sum(out[(kern, shape)]["new"]) / 2
        print(f"  windowed {shape}: library call (grid_sample) {lib_ms:.4f} "
              f"ms against the kernel's {new:.4f} ms, kernel / library "
              f"{new / lib_ms:.3f}x, max |library - kernel| {err:.3e} "
              f"[{card}]", flush=True)
    del wins
    # where the time goes: device time by kernel, and the idle share
    for label, fn in (("HIGH auto 1080p, 1 frame a call",
                       lambda: render_frame(frames[:1], cam_hw, par)),
                      ("HIGH auto 1080p, 4 frames a call",
                       lambda: render_frame(frames, cam_hw, par)),
                      ("ULTRA 1080p, 4 frames a call",
                       lambda: ultra.render(z4, normals=n4))):
        device_breakdown(label, fn, card)
    del pyr, chains, npyr, frames, z4, n4, aos, ao4k1, ao1080_4, cases
    torch.cuda.empty_cache()
    return out


def parent_diff(libs, fn) -> float:
    """Max |new - parent| of ``fn``'s output (a tensor or a tuple of
    them), run once with each library."""
    import torch

    got = {}
    for which in ("new", "parent"):
        with kernel_library(libs[which]):
            o = fn()
        got[which] = o if isinstance(o, tuple) else (o,)
    torch.cuda.synchronize()
    return max(float((a - b).abs().max())
               for a, b in zip(got["new"], got["parent"]))


def device_profile(fn, calls=20):
    """(device ms per call, {kernel: device ms over the calls}, kernels per
    call): the kernels' own time, by torch.profiler over ``calls`` calls
    (``roofline.launch_census``)."""
    census = launch_census(fn, calls)
    by = {name: ms for name, (_, ms) in census.items()}
    n = sum(k for k, _ in census.values())
    if n % calls:
        # every path here launches the same kernels each call: a count
        # that does not divide means the profiler dropped kernel records,
        # and the device time below is short by about the same share
        print(f"  note: torch.profiler saw {n} kernels over {calls} calls "
              f"({n / calls:.2f} a call): records were lost")
    return sum(by.values()) / calls, by, n / calls


def device_breakdown(label, fn, card, calls=20):
    """Device ms per call by kernel against the call's event time
    (``cuda_time_ms``): the device's idle share of a call is
    1 - device / event."""
    from tpuao_torch.utils.timing import cuda_time_ms

    wall = cuda_time_ms(fn)
    device, by, n = device_profile(fn, calls)
    print(f"  {label}: event {wall:.4f} ms, device {device:.4f} ms "
          f"({n:.0f} kernels), idle share {1 - device / wall:.2f} [{card}]")
    for name, t in sorted(by.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {t / calls:.4f} ms ({t / calls / device:.0%}) {name}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="an older tree's tpuao_torch/csrc, whose kernels "
                    f"phase 12 times beside these (default: {PARENT_CSRC} "
                    "where it exists)")
    args = ap.parse_args(argv)
    parent = args.parent
    if parent is None and pathlib.Path(PARENT_CSRC).is_dir():
        parent = PARENT_CSRC

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    import numpy as np

    from tpuao_torch.models import frame_graph
    from tpuao_torch.models.pipeline import render_frame
    from tpuao_torch.ops import _build
    from tpuao_torch.ops import kernels as K
    from tpuao_torch.ops import prepare as P
    from tpuao_torch.params import AOParams, CameraParams, padded_shape
    from tpuao_torch.utils import fixtures as F
    from tpuao_torch.utils.timing import cuda_graph_ms, cuda_time_ms

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # no matmul/conv on the
    torch.backends.cudnn.allow_tf32 = False        # path; stated anyway

    # 1. build
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib.name}", flush=True)
    for k in ptxas_report(lib.with_suffix(".log").read_text()):
        print(f"  {k['name']}: {k['regs']} registers, {k['smem']} B shared, "
              f"{k['spill']} B spilled")
        tiled = k["name"].startswith(("render_kernel", "fused_step_kernel",
                                      "upsample_kernel", "fused_zc_kernel",
                                      "render_dma_kernel"))
        if tiled and k["spill"]:
            raise RuntimeError(f"{k['name']} spills {k['spill']} bytes")
    for name, c in pair_sass(sass_ops(lib)).items():
        print(f"  {name}, SASS a pair: " + ", ".join(
            f"{k} {v:g}" for k, v in c.items()))
    check_division(_build.load(), dev)

    # 2. card
    card = _card()
    print(f"card: {card}", flush=True)

    # 3. kernels against their plain versions, 1080p main-path shapes
    print("kernels vs plain (1080p, linear depth, seed %d):" % SEED)
    chk = Checks()
    cam = CameraParams(depth_mode="linear")
    par = AOParams()
    h0, w0 = 1080, 1920
    hp, wp = padded_shape(h0, w0)
    z = torch.as_tensor(F.spheres_on_plane(h0, w0, cam, seed=SEED),
                        dtype=torch.float32, device=dev)
    zp = torch.nn.functional.pad(z[None], (0, wp - w0, 0, hp - h0),
                                 mode="replicate")[0]
    pyr = [lvl.contiguous()
           for lvl in P.build_pyramid(P.linearize_depth(zp, cam), 4)]
    aos = {}
    for ex in (True, False):
        p = par.replace(exhaustive=ex)
        for l in range(1, 5):
            got = K.render_ao_level(pyr[l], l, wp, cam, p)
            want = K.render_ao_level_plain(pyr[l], l, wp, cam, p)
            chk.close("render", f"render l{l} {tuple(pyr[l].shape)} "
                      f"exhaustive={ex}", got, want, tol=TOL_EXACT)
            aos[(l, ex)] = want
    a4, a3 = aos[(4, True)], aos[(3, True)]
    for lo2, blend in ((None, None), (aos[(4, False)], None),
                       (None, a3), (aos[(4, False)], a3)):
        got = K.blur_upsample_step(a4, pyr[4], pyr[3], par, wp, lo_ao2=lo2,
                                   hi_ao_blend=blend)
        want = K.blur_upsample_step_plain(a4, pyr[4], pyr[3], par, wp,
                                          lo_ao2=lo2, hi_ao_blend=blend)
        chk.close("upsample", f"upsample 4->3 lo_ao2={lo2 is not None} "
                  f"hi_ao_blend={blend is not None}", got, want)
    got = K.blur_upsample_step(a4, pyr[4], pyr[3], par, wp, lo_ao2=a4,
                               hi_ao_blend=a3, crop_hw=(135, 239))
    want = K.blur_upsample_step_plain(a4, pyr[4], pyr[3], par, wp, lo_ao2=a4,
                                      hi_ao_blend=a3, crop_hw=(135, 239))
    chk.close("upsample", "upsample 4->3 odd crop (135, 239)", got, want)
    c_in = {3: K.blur_upsample_step_plain(a4, pyr[4], pyr[3], par, wp)}
    for l in (3, 2, 1):
        crop = (h0, w0) if l == 1 else None
        got = K.fused_render_upsample_step(pyr[l], c_in[l], pyr[l - 1], l, wp,
                                           cam, par, crop_hw=crop)
        want = K.fused_render_upsample_step_plain(
            pyr[l], c_in[l], pyr[l - 1], l, wp, cam, par, crop_hw=crop)
        chk.close("fused", f"fused {l}->{l - 1} crop={crop}", got, want)
        c_in[l - 1] = want
    rng = np.random.default_rng(SEED)
    d44 = torch.as_tensor(rng.uniform(0.2, 0.8, (44, 64)), dtype=torch.float32,
                          device=dev)
    c44 = torch.as_tensor(rng.uniform(0.3, 1.0, (44, 64)), dtype=torch.float32,
                          device=dev)
    hi44 = torch.as_tensor(rng.uniform(0.2, 0.8, (88, 128)),
                           dtype=torch.float32, device=dev)
    chk.close("render", "render 44x64 (rows not a tile multiple)",
              K.render_ao_level(d44, 1, 128, cam, par),
              K.render_ao_level_plain(d44, 1, 128, cam, par), tol=TOL_EXACT)
    chk.close("fused", "fused 44x64 -> 88x128, odd crop (87, 127)",
              K.fused_render_upsample_step(d44, c44, hi44, 1, 128, cam, par,
                                           crop_hw=(87, 127)),
              K.fused_render_upsample_step_plain(d44, c44, hi44, 1, 128, cam,
                                                 par, crop_hw=(87, 127)))
    zoc = torch.full((32, 64), 0.2, device=dev)
    zoc[16, 32] = 0.95  # every tap far in front: vis == 0 there
    p01 = par.replace(strength=0.1)
    got = K.render_ao_level(zoc, 1, 128, cam, p01)
    chk.close("render", "render vis==0 pixel, strength 0.1", got,
              K.render_ao_level_plain(zoc, 1, 128, cam, p01))
    if float(got[16, 32]) != 0.0:
        raise RuntimeError(f"vis==0 pixel gave {float(got[16, 32])}, not 0")
    print("  vis==0 pixel: exactly 0.0")

    # 4. the slice, through render_frame
    print("slice (render_frame):")
    cam_hw = CameraParams()  # hardware depth, reversed-Z
    frames = np.stack([F.to_hardware_depth(
        F.spheres_on_plane(h0, w0, cam_hw, seed=s), cam_hw)
        for s in range(4)]).astype(np.float32)
    batch = torch.as_tensor(frames, device=dev)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    out_auto = render_frame(batch, cam_hw, par, impl="auto")
    torch.cuda.synchronize()
    main_counts = K.launch_counts()
    print(f"  main path, batch (4, {h0}, {w0}) auto: launches {main_counts}")
    want_counts = counts(prepare_levels=1, render_ao_level=1,
                         blur_upsample_step=1, fused_render_upsample_step=3)
    if main_counts != want_counts:
        raise RuntimeError(f"main path launches {main_counts} != "
                           f"{want_counts}")
    K.reset_launch_counts()
    out_jnp = render_frame(batch, cam_hw, par, impl="jnp")
    if K.launch_counts() != dict.fromkeys(want_counts, 0):
        raise RuntimeError(f"impl='jnp' launched {K.launch_counts()}")
    out_pallas = render_frame(batch, cam_hw, par, impl="pallas")
    pallas_counts = counts(prepare_levels=1, render_ao_level=4,
                           blur_upsample_step=4)
    if K.launch_counts() != pallas_counts:
        raise RuntimeError(f"impl='pallas' launched {K.launch_counts()}")
    if not bool(((out_auto >= 0) & (out_auto <= 1)).all()):
        raise RuntimeError("AO outside [0, 1]")
    chk.close("", "batch 4x1080p auto vs jnp", out_auto, out_jnp)
    chk.close("", "batch 4x1080p pallas vs jnp", out_pallas, out_jnp)
    # the replay path: the key's second call captures its CUDA graph and
    # replays it, later calls replay; a replay calls no wrapper, so its
    # launches are the card's own kernel records (torch.profiler)
    g0 = frame_graph.graph_counts()
    replayed = [render_frame(batch, cam_hw, par, impl="auto")
                for _ in range(2)]
    census = census_by_wrapper(launch_census(
        lambda: render_frame(batch, cam_hw, par, impl="auto"), calls=5))
    g1 = frame_graph.graph_counts()
    moved = (g1["captures"] - g0["captures"], g1["replays"] - g0["replays"])
    if moved != (1, 8):
        raise RuntimeError(f"replay path: {moved} captures and replays, "
                           "not (1, 8)")
    for r in replayed:
        if not torch.equal(r, out_auto):
            raise RuntimeError("a replayed frame differs from the eager one")
    chk.close("", "batch 4x1080p replayed vs jnp", replayed[1], out_jnp)
    replay_counts = counts(**{k: n // 5 for k, n in census.items()})
    if any(census.get(k, 0) > 5 * n for k, n in want_counts.items()) or \
            set(census) != {k for k, n in want_counts.items() if n}:
        raise RuntimeError(f"5 replays launched {census} (torch.profiler)")
    if replay_counts != want_counts:  # fewer: the profiler dropped some
        print(f"  note: torch.profiler saw {census} over 5 replays: "
              "records were lost")
    print(f"  replayed (capture on call 2): bit-equal to the eager call, "
          f"launches a call by the card's records {replay_counts}")
    K.reset_launch_counts()
    one = render_frame(batch[1], cam_hw, par, impl="auto")
    if K.launch_counts() != want_counts:
        raise RuntimeError(f"single frame launched {K.launch_counts()}")
    chk.close("", "single 1080p frame auto vs batch member", one, out_jnp[1])
    z4k = F.to_hardware_depth(F.spheres_on_plane(2160, 3840, cam_hw,
                                                 seed=SEED), cam_hw)
    d4k = torch.as_tensor(z4k.astype(np.float32), device=dev)
    chk.close("", "4K 2160x3840 auto vs jnp",
              render_frame(d4k, cam_hw, par, impl="auto"),
              render_frame(d4k, cam_hw, par, impl="jnp"))
    probe = batch[0, :100, :150].contiguous()
    chk.close("", "100x150 probe auto vs jnp",
              render_frame(probe, cam_hw, par, impl="auto"),
              render_frame(probe, cam_hw, par, impl="jnp"))
    flat = render_frame(torch.full((h0, w0), 0.3, device=dev), cam, par)
    chk.close("", "flat plane auto == 1", flat, torch.ones_like(flat))
    q = render_frame(batch, cam_hw, par, impl="auto", out_dtype="uint8")
    qj = render_frame(batch, cam_hw, par, impl="jnp", out_dtype="uint8")
    if q.dtype != torch.uint8:
        raise RuntimeError(f"uint8 output is {q.dtype}")
    chk.close("", "uint8 AO auto vs jnp (codes)", q, qj, tol=1)
    color = torch.as_tensor(rng.integers(0, 256, (4, h0, w0, 3),
                                         dtype=np.uint8), device=dev)
    qc = render_frame(batch, cam_hw, par, color=color, impl="auto",
                      out_dtype="uint8")
    qcj = render_frame(batch, cam_hw, par, color=color, impl="jnp",
                       out_dtype="uint8")
    if qc.dtype != torch.uint8 or qc.shape != color.shape:
        raise RuntimeError(f"uint8 composite is {qc.dtype} {qc.shape}")
    chk.close("", "uint8 colour composite auto vs jnp (codes)", qc, qcj,
              tol=1)

    # 5. times (CUDA events, median of 20 after 3 warm-up runs)
    print(f"times, 1080p, one frame per call [{card}]:")
    f1 = batch[:1]
    frame_ms = {}
    for impl in ("auto", "pallas", "jnp"):
        frame_ms[impl] = cuda_time_ms(
            lambda impl=impl: render_frame(f1, cam_hw, par, impl=impl))
        print(f"  render_frame impl={impl}: {frame_ms[impl]:.4f} ms/frame "
              f"[{card}]", flush=True)
    b4 = cuda_time_ms(lambda: render_frame(batch, cam_hw, par, impl="auto"))
    print(f"  render_frame impl=auto, batch 4: {b4 / 4:.4f} ms/frame "
          f"[{card}]")

    def fused_chain(fn):  # the three fused steps of one frame, 3->2..1->0
        for l in (3, 2, 1):
            fn(pyr[l], c_in[l], pyr[l - 1], l, wp, cam, par,
               crop_hw=(h0, w0) if l == 1 else None)

    # each kernel at the shapes the auto path gives it for one 1080p frame
    timed = {
        "render": (lambda: K.render_ao_level(pyr[4], 4, wp, cam, par),
                   lambda: K.render_ao_level_plain(pyr[4], 4, wp, cam, par)),
        "upsample": (
            lambda: K.blur_upsample_step(a4, pyr[4], pyr[3], par, wp),
            lambda: K.blur_upsample_step_plain(a4, pyr[4], pyr[3], par, wp)),
        "fused": (lambda: fused_chain(K.fused_render_upsample_step),
                  lambda: fused_chain(K.fused_render_upsample_step_plain)),
    }
    ms = {}
    for name, (kern, plain) in timed.items():
        ms[name] = (cuda_time_ms(kern), cuda_time_ms(plain),
                    cuda_graph_ms(kern))
        print(f"  {name}: kernel {ms[name][0]:.4f} ms (events), "
              f"{ms[name][2]:.4f} ms (device, graph replay), plain "
              f"{ms[name][1]:.4f} ms (events) [{card}]", flush=True)
    l1 = (cuda_time_ms(lambda: K.render_ao_level(pyr[1], 1, wp, cam, par)),
          cuda_time_ms(lambda: K.render_ao_level_plain(pyr[1], 1, wp, cam,
                                                       par)))
    print(f"  render at level 1 (544x960, the pallas path's largest): "
          f"kernel {l1[0]:.4f} ms, plain {l1[1]:.4f} ms [{card}]")
    ms.update(phase_prologue(chk, dev, K, F, card))

    # 6-9: the engine and temporal paths and their kernels
    from tpuao_torch.ops import render as R
    from tpuao_torch.ops import temporal as T

    pyr_n, spyr = phase_new_kernels(chk, dev, K, P, R, T, F, cam, h0, w0,
                                    hp, wp)
    z4, n4, d4k, n4k, ultra_counts = phase_engine(chk, dev, K, F, cam, h0,
                                                  w0)
    dz, dn, views, temporal_counts = phase_temporal(chk, dev, K, F, cam, h0,
                                                    w0)
    ms.update(phase_times_new(card, K, cam, wp, pyr_n, spyr, z4, n4, d4k,
                              n4k, dz, dn, views))
    del z4, n4, d4k, n4k, dz, dn, pyr_n, spyr
    torch.cuda.empty_cache()

    # 10-11: the two variants through their entry points, and serving
    variant_counts, variant_ms = phase_variants(chk, dev, K, P, F, cam, card,
                                                pyr, c_in)
    ms.update(variant_ms)
    serving_counts = phase_serving(chk, dev, K, F, cam, card)

    # 12: the redesigned kernels beside the parent's, bounds, shares
    phase_parent(dev, K, P, R, F, cam, card, parent)

    # 13: the CLI and one-card multi-view, each asserting its own counts
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli(chk, dev, K, F, card, pathlib.Path(tmp))
    phase_rigs(chk, dev, K, F, card)

    # 14-15: autodiff on the card, and the mesh / fleet / mesh server on
    # one card, each asserting its own counts
    autodiff_counts = phase_autodiff(chk, dev, K, F, card)
    mesh_paths = phase_mesh(chk, dev, K, F, card)

    # 16: the spatial and grid modes on one card, asserting their counts
    spatial_paths = phase_spatial(chk, dev, K, F, card)

    # 17: every path against the float64 golden on the card, full frame
    golden_records, golden_crops = phase_golden(dev, K, F, card)

    # 18: sequential sections on one card, asserting their counts
    section_paths, section_records = phase_sections(chk, dev, K, F, card)

    # 19: the tile rows: every instance, tune and its cache, stage times
    with tempfile.TemporaryDirectory() as tmp:
        tune_paths, tune_records = phase_tune(chk, dev, K, P, R, F, card,
                                              pathlib.Path(tmp))
    paths = {"frame": main_counts, "frame replay": replay_counts,
             "ultra engine": ultra_counts,
             "temporal": temporal_counts, "variants": variant_counts,
             "serving": serving_counts, **mesh_paths,
             "autodiff": autodiff_counts, **spatial_paths, **section_paths,
             **tune_paths}

    # each kernel's launches come from its own path's main run: the depth-
    # only frame (phase 4), the ULTRA engine (phase 7; the prologue's row
    # too, as it times the prologue with normals), the moving-camera
    # HIGH sequence at resolve_level 0 (phase 8); its bound is that of the
    # work its "ms" timed (phases 5, 9, 10)
    normals_work = [render_work(pyr[l].shape, planes=2) for l in range(1, 5)]
    fused_work = [chain_work(pyr[l].shape, *((h0, w0) if l == 1 else
                                             tuple(pyr[l - 1].shape)),
                             npairs=34) for l in (3, 2, 1)]
    work = {
        "prepare": prepare_work(1, 2160, 3840, 4, normals=True),
        "render": render_work(pyr[4].shape),
        "render_normals": tuple(map(sum, zip(*normals_work))),
        "upsample": chain_work(pyr[4].shape, *pyr[3].shape),
        "fused": tuple(map(sum, zip(*fused_work))),
        "windowed": (h0 * w0 * WINDOWED_OPS, 4 * 6 * h0 * w0),
        "dma": render_work(pyr[1].shape),
        "zc": chain_work(pyr[1].shape, h0, w0, npairs=34),
    }
    meta = {
        "prepare": ("prepare_levels", "tpuao_torch/csrc/prepare.cu",
                    "none (tpuao leaves prepare to XLA)", ultra_counts),
        "render": ("render_ao_level", "tpuao_torch/csrc/render.cu",
                   "tpuao/ops/pallas_kernels.py:660", main_counts),
        "render_normals": ("render_ao_level_normals",
                           "tpuao_torch/csrc/render.cu",
                           "tpuao/ops/pallas_kernels.py:80", ultra_counts),
        "upsample": ("blur_upsample_step", "tpuao_torch/csrc/upsample.cu",
                     "tpuao/ops/pallas_kernels.py:188", main_counts),
        "fused": ("fused_render_upsample_step", "tpuao_torch/csrc/fused.cu",
                  "tpuao/ops/pallas_kernels.py:461", main_counts),
        "windowed": ("windowed_resolve", "tpuao_torch/csrc/windowed.cu",
                     "tpuao/ops/pallas_kernels.py:767", temporal_counts),
        "dma": ("render_ao_level_dma", "tpuao_torch/csrc/render_dma.cu",
                "tpuao/ops/pallas_kernels.py:605", variant_counts),
        "zc": ("fused_render_upsample_step_zc", "tpuao_torch/csrc/fused_zc.cu",
               "tpuao/ops/pallas_kernels.py:351", variant_counts),
    }
    kernels = []
    for key, (fn, src, rep, run) in meta.items():
        b_ms, b_by = bound(*work[key])
        kernels.append({"name": fn, "route": "cuda", "source": src,
                        "replaces": rep, "launches": run[fn],
                        "max_abs_err": chk.worst[key], "ms": ms[key][2],
                        "event_ms": ms[key][0], "plain_ms": ms[key][1],
                        "bound_ms": b_ms,
                        "bound_by": b_by,
                        "library_ms": ms.get(f"{key} library"),
                        "launches_by_path": {p: c[fn] for p, c in
                                             paths.items()}})
    print(f"library calls: {LIBRARY}")
    for k in kernels:
        if k["launches"] < 1:
            raise RuntimeError(f"{k['name']} never launched on its path")
    print(json.dumps({"golden": golden_records, "crops": golden_crops}))
    print(json.dumps({"sections": section_records}))
    print(json.dumps({"tile_rows": tune_records}))
    print(json.dumps({"kernels": kernels}))
    print(_card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

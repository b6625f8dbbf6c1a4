#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``tpuao_torch``) on one GPU.

    python3 chip_smoke.py [--parent DIR]

Phases, one or more lines each:

1. build   -- compile ``tpuao_torch/csrc`` with nvcc (sm_90a) and print the
              build time and each kernel's registers, shared memory and
              spills (a spill in the tiled render, upsample, fused,
              zero-copy or DMA kernel fails);
2. card    -- the card's name and power limit, from nvidia-smi;
3. kernels -- each CUDA kernel against its plain PyTorch version on the
              card, at the 1080p main path's shapes (max_abs_err <= 1e-5);
4. slice   -- ``render_frame`` on a batch of four 1080p frames under
              ``impl="auto"`` (the main path; its launch counts must be
              render 1, upsample 1, fused 3) and ``"pallas"``, held against
              ``impl="jnp"``; one 4K frame; uint8 output and composite;
5. times   -- ms per 1080p frame for auto / pallas / jnp, and each
              kernel's time beside its plain version's;
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
              one and four frames a call and of the ULTRA path.

Then a JSON line ``{"kernels": [...]}`` (each kernel's launches on its
path, worst error, device time by graph replay as ``ms`` with the event
time beside it as ``event_ms``, its plain version's event time, computed
bound and library call: grid_sample's device time for the windowed
resolve, none for the rest), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  With no CUDA device, or when any phase
fails, it exits non-zero before printing a result.  It imports neither JAX
nor the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import re
import subprocess
import sys
import time

TOL = 1e-5  # kernel vs plain version, both float32 on the card
RTOL_NULL_DEPTH = 1e-6  # history depth of a null history (1e6 in float32)
SEED = 7
COUNT_KEYS = ("render_ao_level", "render_ao_level_normals",
              "blur_upsample_step", "fused_render_upsample_step",
              "windowed_resolve", "render_ao_level_dma",
              "fused_render_upsample_step_zc")
TOL_SIBLING = 0.0  # the two variants against their sibling kernels: same
                   # arithmetic on the same tap values, so the same bits
TOL_EXACT = 0.0  # render kernels (all three modes) against their plain
                 # versions: every step rounded alike (csrc/common.cuh)
PARENT_CSRC = "tpuao_torch/_build/parent_csrc"

# The bound: the least time the card could take for a call's work, the
# larger of its operations at the FP32 peak and its bytes (each input read
# once, each output written once) at the HBM3 peak (NVIDIA H100 SXM data
# sheet, 700 W).  Operations counted from the kernels' code: a depth-only
# pair test is 23 FP32 operations (csrc/common.cuh), the tangent term 11
# more; a texel adds ~6 (1/z, clamp, pow) or ~8; the noise filter and 2x
# of a chain step ~153 a lo texel; the windowed resolve ~30 a texel.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
CHAIN_OPS = 153
WINDOWED_OPS = 30
LIBRARY = ("windowed: torch.nn.functional.grid_sample(bilinear, border, "
           "align_corners=True) on the stacked history, timed as a "
           "yardstick and called nowhere in the port; the rest: none, no "
           "single PyTorch call computes a per-texel 34-pair estimator or a "
           "depth-aware chain step")
# grid_sample against the windowed kernel: it takes (ip, jp) normalised to
# [-1, 1] in float32 and back, which moves a coordinate by up to ~5e-4
# texels at 8K; a texel's value moves by that times its neighbour's step
TOL_LIBRARY = 2e-3


def render_ops(npairs: int, tangent: bool = False) -> int:
    return (34 if tangent else 23) * npairs + (8 if tangent else 6)


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(bound in ms, "operations" or "bytes")."""
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
    expect_counts(K, "ULTRA auto", counts(render_ao_level_normals=4,
                                          blur_upsample_step=4))
    if K.render_ao_level_normals.raw_launches != 0:
        raise RuntimeError("ULTRA auto took the raw-normals ABI")
    K.reset_launch_counts()
    out_pallas = engines["pallas"].render(z4, normals=n4)
    expect_counts(K, "ULTRA pallas", counts(render_ao_level_normals=4,
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
    high = {0: counts(render_ao_level=1, blur_upsample_step=1,
                      fused_render_upsample_step=3),
            1: counts(render_ao_level=2, blur_upsample_step=2,
                      fused_render_upsample_step=2)}
    ultra = counts(render_ao_level_normals=4, blur_upsample_step=4)
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
    for (kern, shape), (fn, work) in cases.items():
        ms = {}
        for which in order:
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
    call): the kernels' own time, by torch.profiler over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by, n = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = re.sub(r"^void |\(.*$|^(?:at::native::|tpuao::)", "",
                          name)[:60]
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
            n += 1
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
    # the chain stages' branch-free reciprocal and division against the
    # IEEE operations (csrc/selftest.cu): every float with a normal
    # reciprocal, 2^30 quotients
    lib_ = _build.load()
    bad = torch.zeros(2, dtype=torch.int64, device=dev)
    _build.check(lib_, lib_.tpuao_check_division(
        bad.data_ptr(), 0, torch.cuda.current_stream(dev).cuda_stream),
        "tpuao_check_division")
    n_rcp, n_div = bad.tolist()
    print(f"  rcp_rn vs IEEE reciprocal, 2,113,929,216 floats: {n_rcp} "
          f"mismatches; div_rn vs IEEE division, 2^30 pairs: {n_div}")
    if n_rcp or n_div:
        raise RuntimeError("the chain stages' division differs from IEEE")

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
    want_counts = counts(render_ao_level=1, blur_upsample_step=1,
                         fused_render_upsample_step=3)
    if main_counts != want_counts:
        raise RuntimeError(f"main path launches {main_counts} != "
                           f"{want_counts}")
    K.reset_launch_counts()
    out_jnp = render_frame(batch, cam_hw, par, impl="jnp")
    if K.launch_counts() != dict.fromkeys(want_counts, 0):
        raise RuntimeError(f"impl='jnp' launched {K.launch_counts()}")
    out_pallas = render_frame(batch, cam_hw, par, impl="pallas")
    pallas_counts = counts(render_ao_level=4, blur_upsample_step=4)
    if K.launch_counts() != pallas_counts:
        raise RuntimeError(f"impl='pallas' launched {K.launch_counts()}")
    if not bool(((out_auto >= 0) & (out_auto <= 1)).all()):
        raise RuntimeError("AO outside [0, 1]")
    chk.close("", "batch 4x1080p auto vs jnp", out_auto, out_jnp)
    chk.close("", "batch 4x1080p pallas vs jnp", out_pallas, out_jnp)
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
    phase_serving(chk, dev, K, F, cam, card)  # asserts its own counts

    # 12: the redesigned kernels beside the parent's, bounds, shares
    phase_parent(dev, K, P, R, F, cam, card, parent)

    # each kernel's launches come from its own path's main run: the depth-
    # only frame (phase 4), the ULTRA engine (phase 7), the moving-camera
    # HIGH sequence at resolve_level 0 (phase 8); its bound is that of the
    # work its "ms" timed (phases 5, 9, 10)
    normals_work = [render_work(pyr[l].shape, planes=2) for l in range(1, 5)]
    fused_work = [chain_work(pyr[l].shape, *((h0, w0) if l == 1 else
                                             tuple(pyr[l - 1].shape)),
                             npairs=34) for l in (3, 2, 1)]
    work = {
        "render": render_work(pyr[4].shape),
        "render_normals": tuple(map(sum, zip(*normals_work))),
        "upsample": chain_work(pyr[4].shape, *pyr[3].shape),
        "fused": tuple(map(sum, zip(*fused_work))),
        "windowed": (h0 * w0 * WINDOWED_OPS, 4 * 6 * h0 * w0),
        "dma": render_work(pyr[1].shape),
        "zc": chain_work(pyr[1].shape, h0, w0, npairs=34),
    }
    meta = {
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
                        "library_ms": ms.get(f"{key} library")})
    print(f"library calls: {LIBRARY}")
    for k in kernels:
        if k["launches"] < 1:
            raise RuntimeError(f"{k['name']} never launched on its path")
    print(json.dumps({"kernels": kernels}))
    print(_card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

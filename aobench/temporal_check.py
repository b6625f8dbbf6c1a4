"""The temporal path judged by the sequence reference, on the card: the
port's ``TemporalAOEngine`` over a dolly (``high_1080p``'s tunables,
``TemporalParams()``'s defaults) at each resolve level and seed, against
``aobench/reference/temporal.py`` with its allowance.

    python3 aobench/temporal_check.py --seeds 11,12,13 --frames 32 \
        [--levels 0,1] [--shape 1080x1920] [--device cuda] \
        [--out chiprun_out/temporal_check.jsonl]

Each (level, seed) prints one JSON line:

* ``coord_gap``: the largest gap between the program's float32
  reprojected coordinates (``tpuao_torch.ops.temporal``'s, from its own
  linear depth) and the reference's float64 ones, full-res texels; the
  allowance's band needs ``4 * coord_gap <= temporal.EPS``;
* ``judged``: the widest ``|got - ref| - slack`` over every frame (the
  check's ``max_abs_err``); ``plain``: the widest ``|got - ref|``;
  ``loosened_pct``: the share of texels whose slack exceeds 1e-3;
  ``worst``: frame, row, column, gap and slack of the widest judged gap;
* ``carry``: the most frames a band's injection alone stays above 1e-3
  after the frame that made it (``open`` counts those still above it at
  the last frame);
* ``control``: the bfloat16 control's judged gap over every frame;
* ``judge_s``: seconds ``harness.judge`` takes for 8 samples drawn from
  the seed, the last frame among them, on a fresh pool.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import random
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

LIMIT = 1e-3
STEP = 0.05
N_SPHERES = 8
JUDGED = 8


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "unknown"


def _coord_gap(depth, level: int, cfg: dict, device) -> float:
    """The largest float32-vs-float64 reprojected coordinate gap over the
    frames 1.. of ``depth``, in full-res texels."""
    import torch

    from aobench.device import program_params
    from aobench.reference import temporal as RT
    from aobench.reference.golden import linearize_depth
    from aobench.reference.params import from_config
    from aobench.scenes import dolly_motion, dolly_view
    from tpuao_torch.models.pipeline import ao_pipeline
    from tpuao_torch.ops import temporal as PT
    from tpuao_torch.utils.camera import relative_motion

    camera, params = program_params(cfg)
    params64, camera64 = from_config(cfg)
    h0, w0 = depth.shape[-2:]
    h1, w1 = -(-h0 // 2), -(-w0 // 2)
    worst = 0.0
    for t in range(1, depth.shape[0]):
        motion = relative_motion(dolly_view(t - 1, STEP), dolly_view(t, STEP))
        lin64 = linearize_depth(depth[t].to(torch.float64), camera64)
        if level == 0:
            lin32 = ao_pipeline(depth[t], camera, params, impl=cfg["impl"])[
                1]["linear_z"][:h0, :w0]
            got = PT._reproject_coords(lin32, camera, motion)
            want = RT.reproject_coords(lin64, camera64, dolly_motion(STEP))
        else:
            d1 = ao_pipeline(depth[t], camera, params, impl=cfg["impl"],
                             stop_at_level1=True)[1]["pyramid"][1][:h1, :w1]
            got = PT._reproject_coords_l1(d1, h0, w0, camera, motion)
            want = RT.reproject_coords_l1(lin64[0::2, 0::2], h0, w0,
                                          camera64, dolly_motion(STEP))
        for g, w in zip(got[:2], want[:2]):
            worst = max(worst, float((g.double() - w).abs().max()))
    return worst


def check(level: int, seed: int, frames: int, shape, device) -> dict:
    import torch

    from aobench import control, harness
    from aobench.device import program_params
    from aobench.reference import temporal as RT
    from aobench.reference.params import from_config, temporal_from_config
    from aobench.scenes import dolly_motion, dolly_pool, dolly_view
    from tpuao_torch.models.pipeline import TemporalAOEngine
    from tpuao_torch.params import TemporalParams

    cfg = harness.load_cell("high_1080p.stream")[2]
    tp = TemporalParams()
    cfg["temporal"] = {"history_weight": tp.history_weight,
                       "depth_tolerance": tp.depth_tolerance,
                       "neighborhood_clamp": tp.neighborhood_clamp,
                       "max_displacement": tp.max_displacement,
                       "resolve_level": level}
    wl = {"dolly_step": STEP,
          "check": {"max_abs_err": LIMIT, "max_loosened_pct": 1.0}}
    h, w = shape or (cfg["frame"]["height"], cfg["frame"]["width"])
    depth = dolly_pool(h, w, frames, seed, cfg["camera"], device,
                       n_spheres=N_SPHERES, dolly_step=STEP)[0]
    camera, params = program_params(cfg)
    eng = TemporalAOEngine(camera, params, tp, impl=cfg["impl"],
                           resolve_level=level, device=device)
    outs = [eng.render(depth[t], view=dolly_view(t, STEP))
            for t in range(frames)]
    del eng
    row = {"level": level, "seed": seed, "frames": frames, "shape": [h, w],
           "coord_gap": _coord_gap(depth, level, cfg, device),
           "eps": RT.EPS}

    params64, camera64 = from_config(cfg)
    seq = RT.Sequence(depth, None, camera64, params64,
                      temporal_from_config(cfg),
                      [dolly_motion(STEP)] * frames, device)
    judged = plain = 0.0
    loosened = texels = band = 0
    worst, carry, open_ = None, 0, []
    for t, out in enumerate(outs):
        ref, slack = seq.at(t)
        err = (out.to(torch.float64) - ref).abs()
        excess = err - slack
        k = int(excess.argmax())
        if worst is None or float(excess.view(-1)[k]) > judged:
            judged = float(excess.view(-1)[k])
            worst = [t, k // w, k % w, float(err.view(-1)[k]),
                     float(slack.view(-1)[k])]
        plain = max(plain, float(err.max()))
        loosened += int((slack > LIMIT).sum())
        texels += slack.numel()
        band += int((seq.injected > 0).sum())
        kept = []
        for t0, f in open_:
            f = seq.carry(f)
            if float(f.max()) > LIMIT:
                kept.append((t0, f))
            else:
                carry = max(carry, t - 1 - t0)
        open_ = kept
        if float(seq.injected.max()) > LIMIT:
            open_.append((t, seq.injected.clone()))
    carry = max([carry] + [frames - 1 - t0 for t0, _ in open_])
    row.update(judged=judged, plain=plain,
               loosened_pct=100.0 * loosened / texels, band_texels=band,
               worst=worst, carry=carry, open=len(open_))
    del seq, open_

    row["control"] = control.control_gap(
        RT.Pool(depth), cfg, range(frames), device, workload=wl,
        reference=RT.reference)
    keys = sorted(random.Random(seed).sample(range(frames - 1),
                                             JUDGED - 1)) + [frames - 1]
    samples = [(t, outs[t].cpu()) for t in keys]
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    chk = harness.judge(samples, RT.Pool(depth), cfg, LIMIT, device,
                        reference=RT.reference, workload=wl)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    row["judge_s"] = time.perf_counter() - t0
    row["correct"] = harness.correct_of(chk)
    row["check"] = {k: v["value"] for k, v in chk.items()}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--levels", default="0,1")
    ap.add_argument("--shape", help="HxW in place of the 1080p frame")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "temporal_check.jsonl"))
    a = ap.parse_args(argv)
    from aobench.run import _environment

    _environment()
    import torch

    if a.device.startswith("cuda") and not torch.cuda.is_available():
        print("temporal_check: no CUDA device", file=sys.stderr)
        return 2
    shape = (tuple(int(v) for v in a.shape.split("x")) if a.shape
             else None)
    card = (f"{torch.cuda.get_device_name()}; {_card()}"
            if a.device.startswith("cuda") else "cpu")
    out = pathlib.Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for level in (int(v) for v in a.levels.split(",")):
        for seed in (int(s) for s in a.seeds.split(",")):
            row = {**check(level, seed, a.frames, shape, a.device),
                   "card": card}
            rows.append(row)
            print(json.dumps(row), flush=True)
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
    from aobench import harness

    print(json.dumps({
        "rows": len(rows), "all_correct": all(r["correct"] for r in rows),
        "coord_gap": max(r["coord_gap"] for r in rows),
        "judged": max(r["judged"] for r in rows),
        "plain": max(r["plain"] for r in rows),
        "loosened_pct": max(r["loosened_pct"] for r in rows),
        "carry": max(r["carry"] for r in rows),
        "control_min": min(r["control"] for r in rows),
        "judge_s": max(r["judge_s"] for r in rows),
        "forbidden": harness.forbidden_modules(), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

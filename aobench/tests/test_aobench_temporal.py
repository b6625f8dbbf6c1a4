"""The check of a temporal sequence, on the CPU at small frames.

* The five cells, whose kinds have no ``reference`` of their own, are
  judged as before: the check of each run equals the one-frame judge's,
  key for key and value for value.
* ``aobench/reference/temporal.py`` is the port's float64 spec
  (``tpuao_torch.golden.temporal``), bit for bit, and loads nothing of
  the program.
* The port's ``render_frame_temporal`` over a 16-frame dolly is correct
  under a kind's reference with its allowance, at levels 0 and 1; the
  planted faults and the bfloat16 control are not, and each fault shows
  on texels whose allowance is 0.
* The allowance bounds what flips inside the band do, carried through the
  history; under a static camera it is 0.

The dolly here moves 0.3 a frame: at 64 x 128 that carries texels past
the 3 texels that the r = 3 fault tests, as 0.05 does at 1080p.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from aobench import control, harness
from aobench.reference import golden
from aobench.reference import temporal as T
from aobench.reference.params import Temporal, from_config
from aobench.scenes import dolly_motion, dolly_pool

ROOT = pathlib.Path(__file__).resolve().parents[2]
SHAPE = (64, 128)
FRAMES = 16
STEP = 0.3
SEED = 2**31 + 61
LIMIT = 1e-3
CELLS = [c["name"] for c in harness.spec()["workloads"]]
CELL_SHAPES = {"high_16k.sections8": (4096, 64)}


def _parent_judge(samples, pool, config, limit, device):
    """The one-frame judge as it stood before kinds could bring their own
    reference, frozen here."""
    import math

    params, camera = from_config(config)
    depth, normals = pool
    refs, worst, missing, nonfinite = {}, 0.0, 0, 0
    for idx, out in samples:
        if out is None:
            missing += 1
            continue
        if idx not in refs:
            refs[idx] = golden.render_frame(
                depth[idx].to(device), camera, params,
                None if normals is None else normals[idx].to(device))
        got = torch.as_tensor(out).to(device=device, dtype=torch.float64)
        if got.shape != refs[idx].shape:
            missing += 1
            continue
        gap = float((got - refs[idx]).abs().max())
        if math.isfinite(gap):
            worst = max(worst, gap)
        else:
            nonfinite += 1
    return {"max_abs_err": {"value": worst, "limit": limit},
            "samples": {"value": len(samples) - missing - nonfinite,
                        "limit": 1},
            "missing": {"value": missing, "limit": 0},
            "nonfinite": {"value": nonfinite, "limit": 0}}


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_without_a_reference_is_judged_as_before(cell, monkeypatch):
    seen = []
    judge = harness.judge

    def spy(samples, pool, *a, **kw):
        seen.append((list(samples), pool))
        return judge(samples, pool, *a, **kw)

    monkeypatch.setattr(harness, "judge", spy)
    res, lines = harness.run_cell(cell, 2**31 + 5, 0.3, False, device="cpu",
                                  shape=CELL_SHAPES.get(cell, SHAPE))
    _, wl, cfg = harness.load_cell(cell)
    want = _parent_judge(*seen[0], cfg, wl["check"]["max_abs_err"], "cpu")
    assert res["check"] == want
    assert list(res["check"]) == list(want)
    assert res["correct"] is True
    assert lines[-len(want):] == [
        f"check {k} {v['value']!r} limit {v['limit']!r}"
        for k, v in want.items()]
    assert not any(line.startswith("plain") for line in lines)


# -- the reference: a copy of the spec ---------------------------------------

def _config(level: int, **temporal) -> dict:
    cfg = harness.load_cell("high_1080p.stream")[2]
    group = {"history_weight": 0.9, "depth_tolerance": 0.1,
             "neighborhood_clamp": True, "max_displacement": 4,
             "resolve_level": level}
    return {**cfg, "temporal": {**group, **temporal}}


@pytest.fixture(scope="module")
def depth():
    return dolly_pool(*SHAPE, FRAMES, SEED, _config(0)["camera"], "cpu",
                      dolly_step=STEP)[0]


@pytest.mark.parametrize("r", [4, None])
def test_reference_equals_the_ports_spec(depth, r):
    from tpuao_torch.golden import temporal as spec
    from tpuao_torch.params import AOParams, CameraParams, TemporalParams

    params, camera = from_config(_config(0))
    motions = np.array([dolly_motion(STEP)] * 6)
    ours = T.render_sequence_golden(depth[:6], camera, params,
                                    Temporal(max_displacement=r),
                                    torch.as_tensor(motions))
    theirs = spec.render_sequence_golden(
        depth[:6], CameraParams(), AOParams(),
        TemporalParams(max_displacement=r), motions, device="cpu")
    assert torch.equal(ours, theirs)
    s1 = s2 = None
    seq = T.Sequence(depth, None, camera, params,
                     Temporal(max_displacement=r, resolve_level=1),
                     [dolly_motion(STEP)] * 6, "cpu")
    for t in range(6):
        m = None if t == 0 else motions[t]
        o1, s1 = T.render_frame_l1_temporal_golden(
            depth[t], s1, camera, params, Temporal(max_displacement=r), m)
        o2, s2 = spec.render_frame_l1_temporal_golden(
            depth[t], s2, CameraParams(), AOParams(),
            TemporalParams(max_displacement=r), m, device="cpu")
        assert torch.equal(o1, o2) and torch.equal(s1[0], s2[0])
        assert torch.equal(seq.at(t)[0], o1)
    assert torch.equal(T.Sequence(depth, None, camera, params,
                                  Temporal(max_displacement=r),
                                  [dolly_motion(STEP)] * 6, "cpu").at(5)[0],
                       ours[5])


def test_reference_loads_nothing_of_the_program():
    code = (f"import json, sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import aobench.reference.temporal; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "tpuao", "tpuao_torch"}


@pytest.mark.parametrize("level", [0, 1])
def test_static_camera_has_no_allowance(depth, level):
    params, camera = from_config(_config(level))
    seq = T.Sequence(depth[:4], None, camera, params,
                     Temporal(resolve_level=level), None, "cpu")
    first, slack = seq.at(0)
    assert torch.equal(first, golden.render_frame(depth[0], camera, params))
    for t in range(4):
        ref, slack = seq.at(t)
        assert slack.shape == ref.shape == SHAPE
        assert not slack.any()
    # a moving camera's frame 0 is its one-frame reference too
    moving = T.Sequence(depth, None, camera, params,
                        Temporal(resolve_level=level),
                        [dolly_motion(STEP)] * FRAMES, "cpu")
    assert torch.equal(moving.at(0)[0], first)
    assert not moving.at(0)[1].any()


@pytest.mark.parametrize("level", [0, 1])
def test_the_allowance_bounds_flips_carried_through_the_history(depth,
                                                                level):
    """A window 0.04 texel wider flips texels only inside a band of 0.05:
    the whole sequence then stays within the allowance of the narrower
    one, frame by frame, though it differs."""
    params, camera = from_config(_config(level))
    motions = [dolly_motion(STEP)] * FRAMES
    narrow = T.Sequence(depth, None, camera, params,
                        Temporal(resolve_level=level), motions, "cpu",
                        eps=0.05)
    wide = T.Sequence(depth, None, camera, params,
                      Temporal(max_displacement=4.04, resolve_level=level),
                      motions, "cpu")
    moved = 0.0
    for t in range(FRAMES):
        ref, slack = narrow.at(t)
        gap = (wide.at(t)[0] - ref).abs()
        assert float((gap - slack).max()) <= 1e-12, t
        moved = max(moved, float(gap.max()))
    assert moved > 1e-4  # the flips moved something


# -- the port under the new judge -------------------------------------------

def _port(depth, level: int, fault: str | None = None, **tparams):
    """``[(frame, output)]`` of the port's ``render_frame_temporal`` over
    the dolly, with ``fault`` planted: ``drop`` the history every frame,
    ``stale`` one frame old."""
    from tpuao_torch.models.pipeline import render_frame_temporal
    from tpuao_torch.params import TemporalParams

    from aobench.device import program_params

    cfg = _config(level)
    camera, params = program_params(cfg)
    tp = {k: v for k, v in cfg["temporal"].items() if k != "resolve_level"}
    tp = TemporalParams(**{**tp, **tparams})
    motion = np.array(dolly_motion(STEP))
    states, out = [None], []
    for t in range(FRAMES):
        state = {"drop": None, "stale": states[max(t - 1, 0)]}.get(
            fault, states[t])
        ao, state = render_frame_temporal(
            depth[t], state, camera, params, tp,
            motion=None if t == 0 else motion, impl=cfg["impl"],
            resolve_level=level, device="cpu")
        states.append(state)
        out.append((t, ao))
    return out


def _judge(samples, depth, level, pool=None, **temporal):
    wl = {"dolly_step": STEP,
          "check": {"max_abs_err": LIMIT, "max_loosened_pct": 1.0}}
    notes = []
    check = harness.judge(samples, pool or T.Pool(depth), _config(
        level, **temporal), LIMIT, "cpu", reference=T.reference,
        workload=wl, notes=notes)
    return check, notes


@pytest.mark.parametrize("level", [0, 1])
def test_the_port_is_correct_under_the_sequence_reference(depth, level):
    check, notes = _judge(_port(depth, level), depth, level)
    print(check, *notes)
    assert harness.correct_of(check), check
    assert check["samples"]["value"] == FRAMES
    assert 0.0 <= check["loosened_pct"]["value"] <= 1.0
    assert check["max_abs_err"]["value"] <= 1e-5
    assert len(notes) == 1 and notes[0].startswith("plain max_abs_err")


@pytest.fixture(scope="module")
def pools(depth):
    """One pool a level, so the faults share the reference's pass."""
    return {0: T.Pool(depth), 1: T.Pool(depth)}


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("fault,tparams", [
    ("drop", {}), (None, {"history_weight": 0.8}),
    (None, {"neighborhood_clamp": False}), ("stale", {}),
    (None, {"max_displacement": 3})],
    ids=["history_dropped", "weight_0.8", "clamp_skipped", "stale_history",
         "window_r3"])
def test_planted_faults_fail_where_there_is_no_allowance(depth, pools, level,
                                                         fault, tparams):
    samples = _port(depth, level, fault, **tparams)
    check, _ = _judge(samples, depth, level, pools[level])
    assert not harness.correct_of(check)
    seq = pools[level].sequences[("cpu", torch.float64)]
    worst = 0.0
    for t, out in samples:
        ref, slack = seq.at(t)
        gap = (out.double() - ref).abs()
        worst = max(worst, float(gap[slack == 0].max()))
    assert worst > LIMIT


@pytest.mark.parametrize("level", [0, 1])
def test_the_bfloat16_control_fails(depth, pools, level):
    wl = {"dolly_step": STEP}
    cfg = _config(level)
    f = control.render(cfg, reference=T.reference, workload=wl)
    samples = [(t, f(t, pools[level], "cpu")) for t in range(FRAMES)]
    check, _ = _judge(samples, depth, level, pools[level])
    assert not harness.correct_of(check)
    gap = control.control_gap(pools[level], cfg, range(FRAMES), "cpu",
                              workload=wl, reference=T.reference)
    assert gap == check["max_abs_err"]["value"] > LIMIT


# -- the judge's allowance on a synthetic reference --------------------------

def test_the_judge_counts_and_holds_the_loosened_share():
    ref = torch.zeros((4, 5), dtype=torch.float64)
    slack = torch.zeros_like(ref)
    slack[0, :2] = 0.5  # 2 of 20 texels loosened past the limit
    got = ref.clone()
    got[0, 0] = 0.4  # within its allowance
    got[3, 3] = 5e-4  # within the plain limit

    def reference(key, pool, config, workload, device, dtype=None):
        return ref, slack

    wl = {"check": {"max_abs_err": LIMIT, "max_loosened_pct": 10.0}}
    notes = []
    check = harness.judge([(0, got), (1, None)], None, {}, LIMIT, "cpu",
                          reference=reference, workload=wl, notes=notes)
    assert check["max_abs_err"]["value"] == 5e-4
    assert check["loosened_pct"] == {"value": 10.0, "limit": 10.0}
    assert check["missing"]["value"] == 1 and check["samples"]["value"] == 1
    assert notes == ["plain max_abs_err 0.4 without the allowance, over "
                     "20 texels"]
    check["missing"]["value"] = 0
    assert harness.correct_of(check)
    check["loosened_pct"]["value"] = 10.5
    assert not harness.correct_of(check)
    with pytest.raises(ValueError, match="max_loosened_pct"):
        harness.judge([(0, got)], None, {}, LIMIT, "cpu",
                      reference=reference, workload={"check": {}})

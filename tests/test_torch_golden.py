"""tpuao_torch.golden against tpuao.golden, function for function.

The port's golden is the float64 spec in PyTorch: the same NumPy inputs,
made from a seed, go through each function of ``tpuao.golden`` (the NumPy
spec) and its counterpart in ``tpuao_torch.golden`` on CPU tensors, and
the two must agree within 1e-12 (float64 against float64).  Sizes 64x128,
100x150 and 135x240 (the last two pad to 64).  One test holds the port's
plain ``render_frame`` to the port's golden at ``GTOL`` (1e-4), the bound
it meets against ``tpuao.golden`` (tests/test_torch_pipeline.py); on the
card, chip_smoke.py's phase 17 holds every path to it at full size.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuao.golden import reference as JG
from tpuao.golden import temporal as JGT
import tpuao.params as JP

from tpuao_torch import render_frame
from tpuao_torch.golden import reference as G
from tpuao_torch.golden import temporal as GT
from tpuao_torch.params import (AOParams, CameraParams, TemporalParams,
                                padded_shape, to_golden, to_golden_temporal,
                                upsample_constants)
from tpuao_torch.utils import fixtures as F

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-12  # the port's float64 golden against the NumPy spec
GTOL = 1e-4   # the port's float32 plain path against the float64 golden
SIZES = [(64, 128), (100, 150), (135, 240)]
CAMERAS = {
    "linear": CameraParams(depth_mode="linear"),
    "reversed_z": CameraParams(),
    "forward_z": CameraParams(reversed_z=False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so these tests do not crowd the
    CPU that the suite's other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_golden(*params):
    """The JAX package's plain mirrors of the port's parameter classes."""
    kinds = {AOParams: JP.GoldenAOParams, CameraParams: JP.GoldenCameraParams,
             TemporalParams: JP.GoldenTemporalParams}
    out = tuple(kinds[type(p)](**dataclasses.asdict(p)) for p in params)
    return out if len(out) > 1 else out[0]


def close(got, want, atol=ATOL):
    """``got`` a float64 CPU tensor (or a list / dict of them) within
    ``atol`` of the NumPy spec's ``want``, leaf by leaf."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            close(got[k], want[k], atol)
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, atol)
        return
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want = np.asarray(want)
    if want.dtype == bool:
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
        return
    assert got.dtype == torch.float64
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def scene(hw, seed=3, cam=CAMERAS["linear"]):
    """Linear depth and raw (H, W, 3) normals of a sphere scene."""
    return F.spheres_on_plane(*hw, cam, n_spheres=4, seed=seed,
                              with_normals=True)


def depth_for(z, mode):
    cam = CAMERAS[mode]
    return (z if mode == "linear" else F.to_hardware_depth(z, cam)), cam


# ---------------------------------------------------------------------------
# Prepare
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(CAMERAS))
@pytest.mark.parametrize("hw", SIZES)
def test_linearize_depth(hw, mode):
    depth, cam = depth_for(scene(hw)[0], mode)
    close(G.linearize_depth(depth, cam, device="cpu"),
          JG.linearize_depth(depth, jax_golden(cam)))


@pytest.mark.parametrize("hw", SIZES)
def test_pyramid_and_pad_parity4(hw):
    z, n = scene(hw)
    close(G.downsample2x(z, device="cpu"), JG.downsample2x(z))
    close(G.build_pyramid(z, 4, device="cpu"), JG.build_pyramid(z, 4))
    close(G.build_pyramid(n, 3, device="cpu"), JG.build_pyramid(n, 3))
    for pad in (4, 16):
        close(G.pad_parity4(z, pad, device="cpu"), JG.pad_parity4(z, pad))


# ---------------------------------------------------------------------------
# Render
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("exhaustive", [True, False])
@pytest.mark.parametrize("hw", SIZES)
def test_render_ao_level(hw, exhaustive, normals):
    z, n = scene(hw)
    cam = CAMERAS["linear"]
    par = AOParams(exhaustive=exhaustive, use_normals=normals, strength=1.7,
                   rejection_falloff=3.5)
    jp, jc = jax_golden(par, cam)
    _, wp = padded_shape(*hw)
    pyr, npyr = JG.build_pyramid(z, 2), JG.build_pyramid(n, 2)
    for l in (1, 2):
        nl = npyr[l] if normals else None
        close(G.render_ao_level(pyr[l], l, wp, cam, par, nl, device="cpu"),
              JG.render_ao_level(pyr[l], l, wp, jc, jp, nl))


# ---------------------------------------------------------------------------
# Blur + upsample
# ---------------------------------------------------------------------------

def step_inputs(hw, seed):
    """Low-res AO, a second AO, low and high depth, a high-res blend."""
    lh, lw = hw[0] // 2, hw[1] // 2
    rng = np.random.default_rng(seed)
    lo_d = rng.uniform(0.2, 0.8, (lh, lw))
    hi_d = np.repeat(np.repeat(lo_d, 2, 0), 2, 1)
    hi_d = hi_d + rng.uniform(-0.01, 0.01, hi_d.shape)
    return (rng.uniform(size=(lh, lw)), rng.uniform(size=(lh, lw)), lo_d,
            hi_d, rng.uniform(size=(2 * lh, 2 * lw)))


@pytest.mark.parametrize("hw", SIZES)
def test_noise_filter_and_bilateral_upsample2x(hw):
    lo_ao, _, lo_d, hi_d, _ = step_inputs(hw, 5)
    for nfs in (0.5, 1e3):
        close(G.noise_filter(lo_ao, lo_d, nfs, device="cpu"),
              JG.noise_filter(lo_ao, lo_d, nfs))
    for k_blur, k_up in ((1e-3, 1e-7), (0.9, 1e-3)):
        close(G.bilateral_upsample2x(lo_ao, lo_d, hi_d, k_blur, k_up,
                                     device="cpu"),
              JG.bilateral_upsample2x(lo_ao, lo_d, hi_d, k_blur, k_up))


@pytest.mark.parametrize("blend", [False, True])
@pytest.mark.parametrize("premin", [False, True])
@pytest.mark.parametrize("hw", SIZES)
def test_blur_upsample_step(hw, premin, blend):
    lo_ao, lo_ao2, lo_d, hi_d, hi_blend = step_inputs(hw, 6)
    par = AOParams(noise_filter_tolerance=-2.0, blur_tolerance=-3.0)
    _, wp = padded_shape(*hw)
    kw = {"lo_ao2": lo_ao2 if premin else None,
          "hi_ao_blend": hi_blend if blend else None}
    close(G.blur_upsample_step(lo_ao, lo_d, hi_d, par, wp, device="cpu",
                               **kw),
          JG.blur_upsample_step(lo_ao, lo_d, hi_d, jax_golden(par), wp, **kw))


# ---------------------------------------------------------------------------
# Full frame and composite
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("exhaustive", [True, False])
@pytest.mark.parametrize("mode", list(CAMERAS))
@pytest.mark.parametrize("hw", SIZES)
def test_render_frame_golden_every_debug_leaf(hw, mode, exhaustive, normals):
    z, n = scene(hw)
    depth, cam = depth_for(z, mode)
    par = AOParams(exhaustive=exhaustive, use_normals=normals)
    nrm = n if normals else None
    got, dbg = G.render_frame_golden(depth, cam, par, nrm, return_debug=True,
                                     device="cpu")
    want, jdbg = JG.render_frame_golden(depth, *jax_golden(cam, par),
                                        nrm, return_debug=True)
    close(got, want)
    close(dbg, jdbg)
    assert tuple(got.shape) == hw


@pytest.mark.parametrize("case", ["blur_off", "full_width", "depth_2"])
@pytest.mark.parametrize("hw", SIZES)
def test_render_frame_golden_options(hw, case):
    z, n = scene(hw, seed=5)
    depth, cam = depth_for(z, "reversed_z")
    par = {"blur_off": AOParams(enable_blur=False, use_normals=True),
           "full_width": AOParams(),
           "depth_2": AOParams(hierarchy_depth=2)}[case]
    fw = 2 * padded_shape(*hw)[1] if case == "full_width" else None
    got, dbg = G.render_frame_golden(depth, cam, par, n, return_debug=True,
                                     full_width=fw, device="cpu")
    want, jdbg = JG.render_frame_golden(depth, *jax_golden(cam, par),
                                        n, return_debug=True, full_width=fw)
    close(got, want)
    close(dbg, jdbg)


@pytest.mark.parametrize("debug", [False, True])
@pytest.mark.parametrize("channels", [None, 3])
def test_composite(channels, debug):
    rng = np.random.default_rng(9)
    shape = (100, 150) if channels is None else (100, 150, channels)
    color = rng.integers(0, 256, shape).astype(np.uint8)
    ao = rng.uniform(size=(100, 150))
    close(G.composite(color, ao, debug=debug, device="cpu"),
          JG.composite(color, ao, debug=debug))


# ---------------------------------------------------------------------------
# Temporal
# ---------------------------------------------------------------------------

def motion_4x4(dx=0.3, dz=0.2, yaw=0.01):
    """A current -> previous eye transform: a small yaw and a translation."""
    m = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    m[0, 3], m[2, 3] = dx, dz
    return m


def motion_vectors(hw, seed, di=0.7, dj=-1.5, jitter=3.0):
    """(H, W, 2) per-pixel motion, some of it past a 4-pixel window."""
    rng = np.random.default_rng(seed)
    mv = np.empty(hw + (2,))
    mv[..., 0] = di + rng.uniform(-jitter, jitter, hw)
    mv[..., 1] = dj + rng.uniform(-jitter, jitter, hw)
    return mv


def motion_of(kind, hw, seed=0):
    return {"static": None, "4x4": motion_4x4(),
            "mv": motion_vectors(hw, seed)}[kind]


def history(hw, seed):
    """Current AO and depth, and a history that partly agrees in depth."""
    rng = np.random.default_rng(seed)
    z = scene(hw, seed=seed)[0]
    prev_d = z * (1.0 + rng.uniform(-0.15, 0.15, hw))
    return (rng.uniform(size=hw), z, rng.uniform(size=hw), prev_d)


@pytest.mark.parametrize("hw", SIZES)
def test_rays_and_coords(hw):
    cam = CAMERAS["linear"]
    jc = jax_golden(cam)
    z = scene(hw)[0]
    m = motion_4x4()
    close(GT.eye_rays(*hw, cam.tan_half_fov_h, device="cpu"),
          JGT.eye_rays(*hw, cam.tan_half_fov_h))
    close(GT.reproject_coords(z, cam, m, device="cpu"),
          JGT.reproject_coords(z, jc, m))
    close(GT.reproject_coords(z, cam, torch.as_tensor(m), device="cpu"),
          JGT.reproject_coords(z, jc, m))
    mv = motion_vectors(hw, 1)
    close(GT.mv_coords(mv, device="cpu"), JGT.mv_coords(mv))
    z1 = z[::2, ::2]
    close(GT.reproject_coords_l1(z1, *hw, cam, m, device="cpu"),
          JGT.reproject_coords_l1(z1, *hw, jc, m))
    with pytest.raises(ValueError, match="4x4"):
        GT.reproject_coords(z, cam, np.eye(3), device="cpu")
    with pytest.raises(ValueError, match="H, W, 2"):
        GT.mv_coords(mv[..., :1], device="cpu")


@pytest.mark.parametrize("hw", SIZES + [(1, 7), (6, 1)])
def test_bilinear_sample_and_neighborhood_bounds(hw):
    rng = np.random.default_rng(2)
    field = rng.uniform(size=hw)
    h, w = hw
    ip = rng.uniform(-2.0, h + 1.0, hw)
    jp = rng.uniform(-2.0, w + 1.0, hw)
    ip.flat[:3] = [0.0, h - 1.0, h - 1.5]  # on the clamps and the h - 2 tap
    close(GT.bilinear_sample(field, ip, jp, device="cpu"),
          JGT.bilinear_sample(field, ip, jp))
    close(GT.neighborhood_bounds(field, device="cpu"),
          JGT.neighborhood_bounds(field))


@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("max_displacement", [None, 4])
@pytest.mark.parametrize("kind", ["static", "4x4", "mv"])
@pytest.mark.parametrize("hw", SIZES)
def test_temporal_resolve_golden(hw, kind, max_displacement, clamp):
    cam = CAMERAS["linear"]
    tp = TemporalParams(max_displacement=max_displacement,
                        neighborhood_clamp=clamp, depth_tolerance=0.2)
    fields = history(hw, 4)
    motion = motion_of(kind, hw)
    close(GT.temporal_resolve_golden(*fields, cam, tp, motion, device="cpu"),
          JGT.temporal_resolve_golden(*fields, *jax_golden(cam, tp), motion))


@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("max_displacement", [None, 4])
@pytest.mark.parametrize("kind", ["static", "4x4", "mv"])
@pytest.mark.parametrize("hw", SIZES)
def test_temporal_resolve_l1_golden(hw, kind, max_displacement, clamp):
    cam = CAMERAS["linear"]
    tp = TemporalParams(max_displacement=max_displacement,
                        neighborhood_clamp=clamp, depth_tolerance=0.2)
    h1, w1 = -(-hw[0] // 2), -(-hw[1] // 2)
    fields = [f[::2, ::2] for f in history(hw, 6)]
    assert fields[0].shape == (h1, w1)
    motion = motion_of(kind, hw)
    close(GT.temporal_resolve_l1_golden(*fields, *hw, cam, tp, motion,
                                        device="cpu"),
          JGT.temporal_resolve_l1_golden(*fields, *hw,
                                         *jax_golden(cam, tp), motion))


@pytest.mark.parametrize("kind", ["static", "4x4", "mv"])
@pytest.mark.parametrize("hw", SIZES)
def test_render_frame_l1_temporal_golden(hw, kind):
    z, n = scene(hw, seed=8)
    depth, cam = depth_for(z, "reversed_z")
    par, tp = AOParams(use_normals=True), TemporalParams()
    jc, jp, jt = jax_golden(cam, par, tp)
    motion = motion_of(kind, hw)
    got, st = GT.render_frame_l1_temporal_golden(depth, None, cam, par, tp,
                                                 motion, n, device="cpu")
    want, jst = JGT.render_frame_l1_temporal_golden(depth, None, jc, jp, jt,
                                                    motion, n)
    close((got, st), (want, jst))
    got, _ = GT.render_frame_l1_temporal_golden(depth, st, cam, par, tp,
                                                motion, n)
    close(got, JGT.render_frame_l1_temporal_golden(depth, jst, jc, jp, jt,
                                                   motion, n)[0])


def dolly(hw, t_n, cam):
    """Hardware-depth frames of a static world from an eye moving along x
    and z, their normals, and each frame's current -> previous motion."""
    frames, normals, views = [], [], []
    for t in range(t_n):
        eye = (0.05 * t, 0.0, 0.04 * t)
        z, n = F.spheres_on_plane(*hw, cam, n_spheres=4, seed=3,
                                  with_normals=True, eye=eye)
        v = np.eye(4)
        v[:3, 3] = [-e for e in eye]
        frames.append(F.to_hardware_depth(z, cam))
        normals.append(n)
        views.append(v)
    motions = np.stack([np.eye(4)] + [views[t - 1] @ np.linalg.inv(views[t])
                                      for t in range(1, t_n)])
    return np.stack(frames), np.stack(normals), motions


@pytest.mark.parametrize("kind", ["4x4", "mv", "static"])
def test_sequence_oracles_over_a_dolly(kind):
    hw, t_n = (100, 150), 4
    cam = CAMERAS["reversed_z"]
    depths, normals, motions = dolly(hw, t_n, cam)
    if kind == "mv":
        motions = np.stack([motion_vectors(hw, t, jitter=0.5)
                            for t in range(t_n)])
    elif kind == "static":
        motions = None
    par, tp = AOParams(), TemporalParams()
    jc, jp, jt = jax_golden(cam, par, tp)
    close(GT.render_sequence_golden(depths, cam, par, tp, motions,
                                    device="cpu"),
          JGT.render_sequence_golden(depths, jc, jp, jt, motions))
    par = AOParams(use_normals=True)
    jp = jax_golden(par)
    st = jst = None
    for t in range(t_n):
        mot = None if motions is None or t == 0 else motions[t]
        got, st = GT.render_frame_l1_temporal_golden(
            depths[t], st, cam, par, tp, mot, normals[t], device="cpu")
        want, jst = JGT.render_frame_l1_temporal_golden(
            depths[t], jst, jc, jp, jt, mot, normals[t])
        close((got, st), (want, jst))


# ---------------------------------------------------------------------------
# Parameters, devices, and the port against its golden
# ---------------------------------------------------------------------------

TUNABLES = {"noise_filter_tolerance": -2.5, "blur_tolerance": -4.0,
            "upsample_tolerance": -6.5, "rejection_falloff": 3.0,
            "strength": 1.3}
CAMERA_FLOATS = {"near": 0.2, "far": 50.0, "tan_half_fov_h": 0.7}


def as_kind(v, kind):
    return {"float": float(v), "numpy": np.float32(v),
            "tensor": torch.tensor(v, dtype=torch.float64,
                                   requires_grad=True)}[kind]


@pytest.mark.parametrize("kind", ["float", "numpy", "tensor"])
def test_to_golden(kind):
    par = AOParams(hierarchy_depth=3, exhaustive=False, use_normals=True,
                   **{k: as_kind(v, kind) for k, v in TUNABLES.items()})
    cam = CameraParams(reversed_z=False,
                       **{k: as_kind(v, kind)
                          for k, v in CAMERA_FLOATS.items()})
    gp, gc = to_golden(par, cam)
    jp, jc = JP.to_golden(par if kind != "tensor" else
                          par.replace(**TUNABLES),
                          cam if kind != "tensor" else
                          cam.replace(**CAMERA_FLOATS))
    assert (type(gp), type(gc)) == (AOParams, CameraParams)
    assert dataclasses.asdict(gp) == dataclasses.asdict(jp)
    assert dataclasses.asdict(gc) == dataclasses.asdict(jc)
    for v in list(dataclasses.asdict(gp).values()) + [gc.near, gc.far,
                                                      gc.tan_half_fov_h]:
        assert type(v) in (float, int, bool)
    tp = TemporalParams(history_weight=as_kind(0.8, kind),
                        depth_tolerance=as_kind(0.05, kind),
                        max_displacement=None)
    gt = to_golden_temporal(tp)
    jt = JP.to_golden_temporal(tp.replace(history_weight=0.8,
                                          depth_tolerance=0.05)
                               if kind == "tensor" else tp)
    assert type(gt) is TemporalParams
    assert dataclasses.asdict(gt) == dataclasses.asdict(jt)
    assert type(gt.history_weight) is float


def test_to_golden_refuses_a_rig_leaf():
    """A camera rig's (V,) leaf is not one value: both packages raise."""
    rig = AOParams(strength=np.array([1.0, 1.5, 2.0]))
    with pytest.raises(TypeError):
        to_golden(rig, CameraParams())
    with pytest.raises(TypeError):
        JP.to_golden(rig, CameraParams())
    with pytest.raises(TypeError):
        to_golden(AOParams(), CameraParams(tan_half_fov_h=torch.ones(2)))
    with pytest.raises(TypeError):
        to_golden_temporal(TemporalParams(history_weight=np.ones(4)))


def test_devices_and_dtypes():
    """Tensors stay where they are and float32 input is widened exactly;
    NumPy input follows the call's first tensor, else ``device=``, by
    default the card (raising where there is none); outputs are float64;
    tunables given as 0-d tensors read as floats."""
    z = scene((64, 128))[0]
    cam, par = CAMERAS["linear"], AOParams()
    want = G.render_frame_golden(z, cam, par, device="cpu")
    z32 = torch.as_tensor(z.astype(np.float32))
    got = G.render_frame_golden(z32, cam, par)
    assert got.device.type == "cpu" and got.dtype == torch.float64
    close(got, JG.render_frame_golden(z.astype(np.float32), cam, par))
    t_par = par.replace(strength=torch.tensor(1.0))
    close(G.render_frame_golden(torch.as_tensor(z), cam, t_par), want.numpy())
    rng = np.random.default_rng(0)
    hi = rng.uniform(size=(128, 256))
    close(G.blur_upsample_step(torch.as_tensor(want), z, hi, par, 128),
          JG.blur_upsample_step(want.numpy(), z, hi, par, 128))
    if torch.cuda.is_available():
        assert G.render_frame_golden(z, cam, par).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            G.render_frame_golden(z, cam, par)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            GT.eye_rays(4, 8, 0.5)


@pytest.mark.parametrize("preset", ["HIGH", "ULTRA"])
def test_port_plain_render_frame_within_gtol_of_golden(preset):
    """The port's plain frame path (float32, CPU) against its own float64
    golden at 135x240: the bound it meets against ``tpuao.golden``."""
    from tpuao_torch.models.presets import preset as make

    z, n = scene((135, 240), seed=11)
    depth, cam = depth_for(z, "reversed_z")
    depth = depth.astype(np.float32)
    par = make(preset)
    nrm = n.astype(np.float32) if par.use_normals else None
    got = render_frame(depth, cam, par, normals=nrm, device="cpu")
    want = G.render_frame_golden(depth, cam, par, nrm, device="cpu")
    err = float((got.double() - want).abs().max())
    assert err <= GTOL, err


def test_upsample_constants_stay_floats_under_to_golden():
    """The golden's step constants are Python floats from ``to_golden``'s
    parameters (what ``blur_upsample_step`` reads)."""
    par = AOParams(blur_tolerance=torch.tensor(-4.0))
    gp, _ = to_golden(par, CameraParams())
    consts = upsample_constants(gp, 256, 64)
    assert all(type(c) is float for c in consts)
    assert consts == upsample_constants(AOParams(blur_tolerance=-4.0), 256, 64)


def test_golden_imports_nothing_it_judges():
    """Importing tpuao_torch.golden in a fresh interpreter loads, of the
    port, only tpuao_torch.params: none of ops, models, parallel, utils,
    serving or cli (the code the golden judges), and no jax or tpuao."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import tpuao_torch.golden, tpuao_torch.golden.temporal\n"
        "new = set(sys.modules) - before\n"
        "ours = sorted(m for m in new if m.startswith('tpuao_torch.')\n"
        "              and not m.startswith('tpuao_torch.golden'))\n"
        "bad = [m for m in ours if m != 'tpuao_torch.params'] + sorted(\n"
        "    m for m in new if m.split('.')[0] in\n"
        "    ('jax', 'jaxlib', 'flax', 'optax', 'tpuao'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

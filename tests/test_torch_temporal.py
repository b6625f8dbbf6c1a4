"""The port's temporal accumulation against tpuao's (spec:
tpuao/golden/temporal.py).

The plain windowed history sample against ``tpuao``'s XLA form and its
Pallas kernel in interpret mode, with displacements past the window so
that out-of-window taps count; ``temporal_resolve`` and
``temporal_resolve_l1`` under static, camera and motion-vector motion
against ``tpuao`` (``atol=1e-5``) and the golden spec (``atol=1e-4``
away from the validity boundaries); the frame and sequence functions at
``resolve_level`` 0 and 1 and ``TemporalAOEngine`` against ``tpuao``'s,
one dolly sequence against ``render_sequence_golden``, and the state
guards.  On CPU tensors the windowed wrapper runs its plain version; the
CUDA kernel is held against it on the card (tests/test_torch_kernels_
cuda.py, chip_smoke.py).  Inputs are NumPy fields made from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuao.golden import temporal as GT
from tpuao.models import pipeline as JPL
from tpuao.ops import temporal as JT
from tpuao.ops.pallas_kernels import windowed_resolve as pk_windowed
from tpuao.params import (AOParams as JAOParams, CameraParams as JCamera,
                          GoldenAOParams, GoldenCameraParams,
                          GoldenTemporalParams, TemporalParams as JTP)
from tpuao.utils import fixtures as JF

from tpuao_torch import (AOParams, CameraParams, TemporalAOEngine,
                         TemporalParams, preset, render_frame,
                         render_frame_temporal, render_sequence_temporal)
from tpuao_torch.ops import kernels as K
from tpuao_torch.ops import temporal as T
from tpuao_torch.utils.camera import relative_motion

TOL = 1e-5   # float32 port vs float32 JAX package
GTOL = 1e-4  # float32 port vs float64 golden
CAM = CameraParams(depth_mode="linear")
JCAM = JCamera(depth_mode="linear")
GCAM = GoldenCameraParams(depth_mode="linear")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so these tests do not crowd the
    CPU that the suite's other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    K.reset_launch_counts()
    yield
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)


def smooth_depth(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    z = 0.45 + 0.15 * np.sin(xx / 17.0 + rng.uniform(0, 6)) * \
        np.cos(yy / 23.0 + rng.uniform(0, 6)) + 0.1 * (xx + yy) / (h + w)
    return np.clip(z, 0.05, 0.95)


def smooth_field(h, w, seed=1):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    return 0.5 + 0.4 * np.sin(xx / 11.0 + rng.uniform(0, 6)) * \
        np.sin(yy / 13.0 + rng.uniform(0, 6))


def translation(tx=0.0, ty=0.0, tz=0.0):
    m = np.eye(4)
    m[0, 3], m[1, 3], m[2, 3] = tx, ty, tz
    return m


def view(eye):
    v = np.eye(4)
    v[0, 3], v[1, 3], v[2, 3] = -eye[0], -eye[1], -eye[2]
    return v


def t32(x):
    return torch.as_tensor(np.array(x, np.float32))


def f32(x):
    return np.asarray(x, np.float32)


def dolly(h, w, t_n, step=(0.05, 0.0, 0.04), seed=5, with_normals=False):
    """A static world raycast from a moving eye: depths (T, H, W)
    [normals (T, H, W, 3)] and the relative motions (T, 4, 4)."""
    eyes = [tuple(s * t for s in step) for t in range(t_n)]
    frames = [JF.spheres_on_plane(h, w, GCAM, n_spheres=4, seed=seed, eye=e,
                                  with_normals=with_normals,
                                  backend="numpy") for e in eyes]
    motions = np.stack([np.eye(4)] + [relative_motion(view(eyes[t - 1]),
                                                      view(eyes[t]))
                                      for t in range(1, t_n)])
    if with_normals:
        return (f32(np.stack([f[0] for f in frames])),
                f32(np.stack([f[1] for f in frames])), motions, eyes)
    return f32(np.stack(frames)), motions, eyes


def fields(h, w, r, seed=5):
    """History (ao, depth) and coordinates displaced by up to r+2 texels,
    so some taps fall outside the [-r, r+1] window."""
    rng = np.random.default_rng(seed)
    ao = f32(smooth_field(h, w, seed=3))
    d = f32(smooth_depth(h, w, seed=4))
    ii, jj = np.mgrid[0:h, 0:w]
    ip = f32(ii + rng.uniform(-(r + 2), r + 2, (h, w)))
    jp = f32(jj + rng.uniform(-(r + 2), r + 2, (h, w)))
    ip[0, :4] = [-r - 1.5, r + 1.0, 0.0, r + 0.25]  # edge, exact, clamped
    return ao, d, ip, jp


# ---------------------------------------------------------------------------
# the windowed history sample (the kernel's plain version)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,r", [(48, 64, 2), (37, 50, 3)])
def test_windowed_matches_tpuao_and_pallas(h, w, r):
    ao, d, ip, jp = fields(h, w, r)
    got = K.windowed_resolve(t32(ao), t32(d), t32(ip), t32(jp), r)
    xla = JT._bilinear_windowed2(*(jnp.asarray(a) for a in (ao, d, ip, jp)),
                                 r)
    pk = pk_windowed(*(jnp.asarray(a) for a in (ao, d, ip, jp)), r,
                     row_tile=16)
    for g, x, p in zip(got, xla, pk):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=TOL)


def test_windowed_equals_gather_inside_window_and_zero_outside():
    h, w, r = 40, 56, 3
    ao, d, _, _ = fields(h, w, r)
    ii, jj = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(2)
    ip = t32(ii + rng.uniform(-r, r, (h, w)))
    jp = t32(jj + rng.uniform(-r, r, (h, w)))
    win = T._bilinear_windowed2(t32(ao), t32(d), ip, jp, r)
    gat = T._bilinear_gather2(t32(ao), t32(d), ip, jp)
    for a, b in zip(win, gat):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6)
    far = T._bilinear_windowed2(t32(ao), t32(d), ip + (2 * r + 3.0), jp, r)
    assert float(far[0].abs().max()) == 0.0  # every tap out of window


def test_windowed_wrapper_checks():
    z = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="plane"):
        K.windowed_resolve(z, z, z, torch.zeros(8, 9), 2)
    with pytest.raises(ValueError, match="plane"):
        K.windowed_resolve(z[None], z[None], z[None], z[None], 2)
    with pytest.raises(ValueError, match="radius"):
        K.windowed_resolve(z, z, z, z, 0)


# ---------------------------------------------------------------------------
# temporal_resolve / temporal_resolve_l1
# ---------------------------------------------------------------------------

MOTIONS = {
    "static": None,
    "dolly": translation(tx=0.8, ty=-0.5, tz=1.3),
    "rotation": np.array([[0.9998, -0.02, 0.0, 0.4],
                          [0.02, 0.9998, 0.0, -0.2],
                          [0.0, 0.0, 1.0, 0.8],
                          [0.0, 0.0, 0.0, 1.0]]),
    "mv_channel_last": "mv_cl",
    "mv_channel_first": "mv_cf",
}


def _motion(kind, h, w):
    m = MOTIONS[kind]
    if not isinstance(m, str):
        return m
    rng = np.random.default_rng(3)
    mv = np.stack([1.3 + 0.5 * np.sin(np.arange(h)[:, None] / 7.0)
                   + 0 * np.arange(w),
                   -2.1 + rng.uniform(-0.5, 0.5, (h, w))], -1)
    return f32(mv if m == "mv_cl" else np.moveaxis(mv, -1, 0))


def _safe(ip, jp, h, w, r, ii, jj):
    """Texels away from the validity boundaries, where float32 and float64
    coordinates may fall on two sides of a mask."""
    eps = 1e-3
    ok = ((np.abs(ip + 0.5) > eps) & (np.abs(ip - (h - 0.5)) > eps)
          & (np.abs(jp + 0.5) > eps) & (np.abs(jp - (w - 0.5)) > eps))
    if r is not None:
        ok &= (np.abs(np.abs(ip - ii) - r) > eps)
        ok &= (np.abs(np.abs(jp - jj) - r) > eps)
    return ok


@pytest.mark.parametrize("max_displacement", [2, None])
@pytest.mark.parametrize("kind", list(MOTIONS))
def test_temporal_resolve_matches_tpuao_and_golden(kind, max_displacement):
    h, w = 48, 64
    ao, hist = smooth_field(h, w), smooth_field(h, w, seed=9)
    d, pd = smooth_depth(h, w), smooth_depth(h, w, seed=2)
    if kind == "static":
        pd = d * (1.0 + 0.04 * np.sin(np.arange(w) / 5.0))
    motion = _motion(kind, h, w)
    kw = dict(history_weight=0.9, depth_tolerance=0.3,
              neighborhood_clamp=kind != "dolly",
              max_displacement=max_displacement)
    args = [f32(a) for a in (ao, d, hist, pd)]
    jm = None if motion is None else jnp.asarray(f32(motion))
    want = np.asarray(JT.temporal_resolve(*args, JCAM, JTP(**kw), motion=jm))
    for impl in ("auto", "jnp"):
        got = T.temporal_resolve(*(t32(a) for a in args), CAM,
                                 TemporalParams(**kw), motion=motion,
                                 impl=impl).numpy()
        np.testing.assert_allclose(got, want, atol=TOL)
    gm = motion if motion is None or motion.ndim == 2 else (
        motion if motion.shape[-1] == 2 else np.moveaxis(motion, 0, -1))
    gold = GT.temporal_resolve_golden(ao, d, hist, pd, GCAM,
                                      GoldenTemporalParams(**kw), gm)
    ii, jj = np.mgrid[0:h, 0:w]
    if motion is None:
        safe = np.ones((h, w), bool)
    elif motion.ndim == 3:
        di, dj = (gm[..., 0], gm[..., 1])
        safe = _safe(ii + di, jj + dj, h, w, max_displacement, ii, jj)
    else:
        ip, jp, _, _ = GT.reproject_coords(d, GCAM, motion)
        safe = _safe(ip, jp, h, w, max_displacement, ii, jj)
    assert np.abs(got - gold)[safe].max() <= GTOL


@pytest.mark.parametrize("max_displacement", [3, None])
@pytest.mark.parametrize("kind", ["static", "dolly", "mv_channel_last",
                                  "mv_channel_first"])
def test_temporal_resolve_l1_matches_tpuao(kind, max_displacement):
    h0, w0 = 96, 128
    h1, w1 = h0 // 2, w0 // 2
    args = [f32(a) for a in (smooth_field(h1, w1), smooth_depth(h1, w1),
                             smooth_field(h1, w1, seed=9),
                             smooth_depth(h1, w1, seed=2))]
    motion = _motion(kind, h0, w0)
    kw = dict(history_weight=0.9, depth_tolerance=0.3,
              max_displacement=max_displacement)
    jm = None if motion is None else jnp.asarray(f32(motion))
    want = np.asarray(JT.temporal_resolve_l1(*args, h0, w0, JCAM, JTP(**kw),
                                             motion=jm))
    for impl in ("auto", "jnp"):
        got = T.temporal_resolve_l1(*(t32(a) for a in args), h0, w0, CAM,
                                    TemporalParams(**kw), motion=motion,
                                    impl=impl).numpy()
        np.testing.assert_allclose(got, want, atol=TOL)


def test_resolve_null_history_is_exact_and_static_is_gather_free():
    h, w = 32, 48
    ao, d = t32(smooth_field(h, w)), t32(smooth_depth(h, w))
    prev = T.initial_state(h, w)
    assert prev[1].dtype == torch.float32 and float(prev[1][0, 0]) == 1e6
    for motion in (None, translation(tx=0.3)):
        out = T.temporal_resolve(ao, d, *prev, CAM, TemporalParams(),
                                 motion=motion)
        np.testing.assert_array_equal(out.numpy(), ao.numpy())
    with pytest.raises(ValueError, match="rank 3|motion vectors"):
        T.temporal_resolve(ao, d, *prev, CAM, TemporalParams(),
                           motion=np.zeros((h, w, 3), np.float32))
    with pytest.raises(ValueError, match="on meta"):
        T.temporal_resolve(ao, d, *prev, CAM, TemporalParams(),
                           motion=torch.zeros(h, w, 2, device="meta"))


# ---------------------------------------------------------------------------
# the frame and sequence functions and the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("resolve_level", [0, 1])
def test_frame_and_sequence_match_tpuao(resolve_level):
    depths, motions, _ = dolly(64, 96, 3)
    par, jpar = AOParams(), JAOParams()
    seq = render_sequence_temporal(depths, CAM, par, TemporalParams(),
                                   motions=motions,
                                   resolve_level=resolve_level, device="cpu")
    jseq = np.asarray(JPL.render_sequence_temporal(
        depths, JCAM, jpar, JTP(), motions=f32(motions),
        resolve_level=resolve_level))
    assert tuple(seq.shape) == (3, 64, 96)
    np.testing.assert_allclose(seq.numpy(), jseq, atol=TOL)
    # frame by frame; frame 0's motion (identity) meets the null history,
    # so it changes nothing and every JAX call is one program
    st, jst = None, None
    for t in range(3):
        out, st = render_frame_temporal(depths[t], st, CAM, par,
                                        TemporalParams(), motion=motions[t],
                                        resolve_level=resolve_level,
                                        device="cpu")
        jout, jst = JPL.render_frame_temporal(
            depths[t], jst, JCAM, jpar, JTP(), motion=f32(motions[t]),
            resolve_level=resolve_level)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL)
        np.testing.assert_array_equal(out.numpy(), seq[t].numpy())
    for a, b in zip(st, jst):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)


def test_ultra_frame_with_normals_mv_and_impls_match_tpuao():
    depths, normals, motions, _ = dolly(64, 64, 2, with_normals=True)
    mv = np.zeros((64, 64, 2), np.float32)
    mv[..., 1] = -0.6
    for resolve_level, motion in ((0, motions[1]), (1, mv)):
        st = jst = None
        for t in range(2):  # frame 0: null history, motion irrelevant
            jout, jst = JPL.render_frame_temporal(
                depths[t], jst, JCAM, JPL.AOParams(use_normals=True), JTP(),
                motion=f32(motion), normals=normals[t], impl="jnp",
                resolve_level=resolve_level)
            for impl in ("auto", "pallas", "jnp"):
                out, st_i = render_frame_temporal(
                    depths[t], st, CAM, preset("ULTRA"), TemporalParams(),
                    motion=motion, normals=normals[t], impl=impl,
                    resolve_level=resolve_level, device="cpu")
                np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                           atol=TOL)
            st = st_i


def test_no_blur_odd_dims_and_color_match_tpuao():
    z = f32(JF.spheres_on_plane(63, 98, GCAM, n_spheres=3, seed=4,
                                backend="numpy"))
    motion = translation(tx=0.3, tz=0.5)
    color = np.full((63, 98, 3), 0.5, np.float32)
    for par, jpar, rl in ((AOParams(), JAOParams(), 1),
                          (AOParams(enable_blur=False),
                           JAOParams(enable_blur=False), 1),
                          (AOParams(hierarchy_depth=1),
                           JAOParams(hierarchy_depth=1), 1)):
        got, st = render_frame_temporal(z, None, CAM, par, TemporalParams(),
                                        motion=motion, color=color,
                                        resolve_level=rl, device="cpu")
        want, jst = JPL.render_frame_temporal(z, None, JCAM, jpar, JTP(),
                                              motion=f32(motion),
                                              color=color, resolve_level=rl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
        assert tuple(st[0].shape) == tuple(jst[0].shape)


def test_dolly_sequence_matches_golden():
    depths, motions, _ = dolly(64, 96, 3, seed=2)
    tp = dict(history_weight=0.7)
    got = render_sequence_temporal(depths, CAM, AOParams(),
                                   TemporalParams(**tp), motions=motions,
                                   device="cpu")
    want = GT.render_sequence_golden(depths.astype(np.float64), GCAM,
                                     GoldenAOParams(),
                                     GoldenTemporalParams(**tp),
                                     motions=motions)
    np.testing.assert_allclose(got.numpy(), want, atol=GTOL)


def test_l1_frame_matches_golden_dolly():
    depths, motions, _ = dolly(64, 96, 3)
    gst = st = None
    for t in range(3):
        m = None if t == 0 else motions[t]
        want, gst = GT.render_frame_l1_temporal_golden(
            depths[t], gst, GCAM, GoldenAOParams(), GoldenTemporalParams(),
            motion=m)
        got, st = render_frame_temporal(depths[t], st, CAM, AOParams(),
                                        TemporalParams(), motion=m,
                                        resolve_level=1, device="cpu")
        assert np.abs(got.numpy() - want).max() <= 1e-3, t


def test_temporal_engine_view_matrices_match_tpuao():
    depths, _, eyes = dolly(64, 64, 3, step=(0.1, 0.0, 0.0), seed=6)
    eng = TemporalAOEngine(camera=CAM, device="cpu")
    jeng = JPL.TemporalAOEngine(camera=JCAM)
    outs = []
    for t in range(3):
        o = eng.render(depths[t], view=view(eyes[t]))
        np.testing.assert_allclose(
            o.numpy(), np.asarray(jeng.render(depths[t], view=view(eyes[t]))),
            atol=TOL)
        outs.append(o)
    single = render_frame(depths[2], CAM, AOParams(), device="cpu")
    assert float((outs[2] - single).abs().max()) > 1e-4  # history is used
    eng.reset()
    np.testing.assert_array_equal(eng.render(depths[0], view=view(eyes[0])),
                                  outs[0])
    with pytest.raises(ValueError, match="not both"):
        eng.render(depths[0], motion=np.eye(4), view=view(eyes[0]))


def test_temporal_engine_properties_and_resolve_level():
    z = f32(JF.spheres_on_plane(64, 96, GCAM, n_spheres=2, seed=3,
                                backend="numpy"))
    eng = TemporalAOEngine(camera=CAM, params=preset("HIGH"), device="cpu")
    eng.history_weight = 0.5
    eng.depth_tolerance = 0.2
    assert eng.tparams == TemporalParams(history_weight=0.5,
                                         depth_tolerance=0.2)
    with pytest.raises(ValueError, match="history_weight"):
        eng.history_weight = 1.0
    eng.render(z)
    assert tuple(eng._state[0].shape) == (64, 96)
    eng.resolve_level = 1  # drops the history: the state shape changes
    assert eng._state is None and eng.resolve_level == 1
    eng.render(z)
    assert tuple(eng._state[0].shape) == (32, 48)
    eng.resolve_level = 1  # no change, history kept
    assert eng._state is not None
    with pytest.raises(ValueError, match="resolve_level"):
        eng.resolve_level = 2
    with pytest.raises(ValueError, match="resolve_level"):
        TemporalAOEngine(resolve_level=3, device="cpu")
    with pytest.raises(ValueError, match="impl='fused'"):
        TemporalAOEngine(camera=CAM, impl="fused", resolve_level=1,
                         device="cpu").render(z)


def test_state_shape_guard_and_inputs():
    z = f32(JF.spheres_on_plane(64, 96, GCAM, n_spheres=2, seed=3,
                                backend="numpy"))
    with pytest.raises(ValueError, match="resolve_level"):
        render_frame_temporal(z, T.initial_state(64, 96), CAM,
                              resolve_level=1, device="cpu")
    with pytest.raises(ValueError, match="resolve_level"):
        render_frame_temporal(z, T.initial_state(32, 48), CAM,
                              resolve_level=0, device="cpu")
    with pytest.raises(ValueError, match="resolve_level"):
        render_frame_temporal(z, None, CAM, resolve_level=2, device="cpu")
    with pytest.raises(ValueError, match="single"):
        render_frame_temporal(np.stack([z, z]), None, CAM, device="cpu")
    with pytest.raises(ValueError, match="motions"):
        render_sequence_temporal(np.stack([z, z]), CAM,
                                 motions=np.zeros((2, 3, 3)), device="cpu")
    with pytest.raises(ValueError, match=r"\(T, H, W\)"):
        render_sequence_temporal(z, CAM, device="cpu")

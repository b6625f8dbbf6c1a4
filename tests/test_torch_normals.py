"""The port's normals path (the ``ULTRA`` render) against tpuao's.

The plain normals render in both ABIs -- level-0 slope planes and raw
per-level normals -- against ``tpuao.ops.render`` and against the Pallas
kernel in interpret mode (``atol=1e-5``), ``render_frame`` with normals
under every ``impl`` against ``tpuao``'s ``jnp`` and ``pallas`` paths and
against the float64 golden (``atol=1e-4``), the layouts, and the golden
property tests of the normals path.  On CPU tensors the kernel wrappers
run their plain versions; the CUDA kernel is held against them on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).  Inputs are NumPy
scenes made from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuao.golden import reference as G
from tpuao.models import pipeline as JPL
from tpuao.ops import pallas_kernels as PK
from tpuao.ops import render as JR
from tpuao.params import (AOParams as JAOParams, CameraParams as JCamera,
                          GoldenAOParams, GoldenCameraParams)
from tpuao.utils import fixtures as JF

from tpuao_torch import AOParams, CameraParams, render_frame
from tpuao_torch.models import pipeline as TPL
from tpuao_torch.ops import kernels as K
from tpuao_torch.ops import prepare as P
from tpuao_torch.ops import render as R

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
    assert K.render_ao_level_normals.raw_launches == 0


def scene(h=128, w=192, seed=9, n_spheres=4):
    """float32 depth (H, W) and channel-last normals (H, W, 3)."""
    z, n = JF.spheres_on_plane(h, w, GCAM, n_spheres=n_spheres, seed=seed,
                               with_normals=True, backend="numpy")
    return z.astype(np.float32), n.astype(np.float32)


def t32(x):
    return torch.as_tensor(np.array(x, np.float32))


@pytest.fixture(scope="module")
def level1():
    """Level 1 of a 128x192 scene: depth (64, 96), channel-last normals
    (64, 96, 3) and the level-0 slope planes picked to level 1."""
    z, n = scene()
    dsn = np.ascontiguousarray(z[::2, ::2])
    nds = np.ascontiguousarray(n[::2, ::2])
    gx, gy = JR.slope_planes(jnp.asarray(n), JCAM.tan_half_fov_h, 192)
    return dsn, nds, (np.asarray(gx)[::2, ::2], np.asarray(gy)[::2, ::2])


# ---------------------------------------------------------------------------
# the normals prologue
# ---------------------------------------------------------------------------

def test_slope_planes_match_tpuao():
    _, n = scene(64, 96)
    want = JR.slope_planes(jnp.asarray(n), JCAM.tan_half_fov_h, 96)
    for layout in (n, np.moveaxis(n, -1, -3)):
        got = R.slope_planes(t32(layout), CAM.tan_half_fov_h, 96)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("hw", [(64, 96), (50, 70)])
def test_slope_pyramid_matches_tpuao(hw):
    _, n = scene(*hw, seed=4)
    hp, wp = 64, 128
    want = JR.slope_pyramid(jnp.asarray(n), JCAM.tan_half_fov_h, hp, wp, 4)
    got = R.slope_pyramid(t32(n), CAM.tan_half_fov_h, hp, wp, 4)
    assert len(got) == len(want) == 5
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.is_contiguous() and gy.is_contiguous()
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))


def test_normals_layouts_and_ambiguity():
    _, n = scene(16, 24)
    cl = t32(n)
    cf = torch.movedim(cl, -1, -3)
    assert torch.equal(R.normals_channel_last(cf), cl)
    assert R.normals_channel_last(cl) is cl
    assert torch.equal(R.normals_channel_first(cl), cf)
    np.testing.assert_array_equal(
        R.normals_channel_last(cf).numpy(),
        np.asarray(JR.normals_channel_last(jnp.asarray(cf.numpy()))))
    for bad in (torch.zeros(3, 8, 3), torch.zeros(2, 3, 8, 3)):
        with pytest.raises(ValueError, match="ambiguous"):
            R.normals_channel_last(bad)
    with pytest.raises(ValueError, match="no size-3"):
        R.normals_channel_last(torch.zeros(8, 8, 2))


# ---------------------------------------------------------------------------
# the normals render, both ABIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exhaustive", [True, False])
@pytest.mark.parametrize("abi", ["slopes", "normals_cl", "normals_cf"])
def test_render_normals_matches_tpuao(level1, abi, exhaustive):
    dsn, nds, slopes = level1
    par = AOParams(use_normals=True, exhaustive=exhaustive, strength=1.3)
    jpar = JAOParams(use_normals=True, exhaustive=exhaustive, strength=1.3)
    if abi == "slopes":
        kw = {"slopes_ds": tuple(t32(g) for g in slopes)}
        jkw = {"slopes_ds": tuple(jnp.asarray(g) for g in slopes)}
    else:
        nn = nds if abi == "normals_cl" else np.moveaxis(nds, -1, -3)
        kw, jkw = {"normals_ds": t32(nn)}, {"normals_ds": jnp.asarray(nn)}
    got = K.render_ao_level(t32(dsn), 1, 192, CAM, par, **kw).numpy()
    want = np.asarray(JR.render_ao_level(jnp.asarray(dsn), 1, 192, JCAM,
                                         jpar, **jkw))
    np.testing.assert_allclose(got, want, atol=TOL)
    gold = G.render_ao_level(dsn.astype(np.float64), 1, 192, GCAM,
                             GoldenAOParams(use_normals=True,
                                            exhaustive=exhaustive,
                                            strength=1.3),
                             nds.astype(np.float64))
    np.testing.assert_allclose(got, gold, atol=GTOL)


def test_render_normals_matches_pallas_interpret(level1):
    dsn, nds, _ = level1
    got = K.render_ao_level_normals(
        t32(dsn), 1, 192, CAM, AOParams(use_normals=True),
        normals_ds=t32(np.moveaxis(nds, -1, -3))).numpy()
    pk = np.asarray(PK.render_ao_level(
        jnp.asarray(dsn), 1, 192, JCAM, JAOParams(use_normals=True),
        jnp.asarray(nds)))
    np.testing.assert_allclose(got, pk, atol=TOL, rtol=1e-4)


def test_render_normals_batched_and_levels():
    z, n = scene(128, 192, seed=2)
    z2, n2 = scene(128, 192, seed=5)
    zb, nb = np.stack([z, z2]), np.stack([n, n2])
    pyr = P.build_pyramid(t32(zb), 3)
    spyr = R.slope_pyramid(t32(nb), CAM.tan_half_fov_h, 128, 192, 3)
    npyr = R.normals_pyramid(t32(nb), 128, 192, 3)
    par = AOParams(use_normals=True)
    for l in (1, 3):
        both = K.render_ao_level(pyr[l], l, 192, CAM, par,
                                 slopes_ds=spyr[l])
        raw = K.render_ao_level(pyr[l], l, 192, CAM, par,
                                normals_ds=npyr[l])
        assert both.shape == pyr[l].shape
        # the two ABIs differ only by float32 rounding of the slopes
        np.testing.assert_allclose(both.numpy(), raw.numpy(), atol=TOL)
        for b in (0, 1):
            one = K.render_ao_level(pyr[l][b], l, 192, CAM, par,
                                    slopes_ds=tuple(g[b] for g in spyr[l]))
            np.testing.assert_array_equal(both[b].numpy(), one.numpy())


def test_render_normals_wrapper_checks():
    z = t32(np.full((16, 16), 0.5))
    n = torch.zeros(16, 16, 3)
    with pytest.raises(ValueError, match="exactly one"):
        K.render_ao_level_normals(z, 1, 32, CAM, AOParams(use_normals=True))
    with pytest.raises(ValueError, match="use_normals"):
        K.render_ao_level_normals(z, 1, 32, CAM, AOParams(), normals_ds=n)
    # use_normals off: the depth-only estimator, normals ignored
    np.testing.assert_array_equal(
        K.render_ao_level(z, 1, 32, CAM, AOParams(), normals_ds=n).numpy(),
        K.render_ao_level(z, 1, 32, CAM, AOParams()).numpy())


def test_tangent_m2_is_the_plain_rounding():
    par = AOParams(use_normals=True)
    rc = 4.0 * 10.0 * CAM.tan_half_fov_h / (192 // 2)
    want = [np.float32((0.5 * rc * t) ** 2)
            for _, _, t, _ in R._pair_constants(par)]
    np.testing.assert_array_equal(K.tangent_m2(par, 1, 192, CAM), want)


# ---------------------------------------------------------------------------
# render_frame with normals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["channel_last", "channel_first"])
def test_render_frame_normals_matches_tpuao_and_golden(layout):
    z, n = scene()
    nn = n if layout == "channel_last" else np.moveaxis(n, -1, -3)
    want = np.asarray(JPL.render_frame(
        z, JCAM, JAOParams(use_normals=True), normals=nn, impl="jnp"))
    gold = G.render_frame_golden(z, GCAM, GoldenAOParams(use_normals=True),
                                 normals=n)
    for impl in TPL.IMPLS:
        got = render_frame(z, CAM, AOParams(use_normals=True), normals=nn,
                           impl=impl, device="cpu").numpy()
        np.testing.assert_allclose(got, want, atol=TOL)
        np.testing.assert_allclose(got, gold, atol=GTOL)


def test_render_frame_normals_matches_tpuao_pallas():
    """tpuao's impl="pallas" (raw normals into the Pallas kernel, interpret
    mode) against the port's raw-normals path, at a size interpret mode
    runs quickly."""
    z, n = scene(64, 64, seed=8, n_spheres=3)
    par = dict(use_normals=True, hierarchy_depth=3)
    want = np.asarray(JPL.render_frame(z, JCAM, JAOParams(**par), normals=n,
                                       impl="pallas"))
    for impl in TPL.IMPLS:
        got = render_frame(z, CAM, AOParams(**par), normals=n,
                           impl=impl, device="cpu").numpy()
        np.testing.assert_allclose(got, want, atol=TOL)


def test_render_frame_normals_odd_size_and_batch():
    z, n = scene(100, 150, seed=6)
    z2, n2 = scene(100, 150, seed=7)
    zb, nb = np.stack([z, z2]), np.stack([n, n2])
    par = AOParams(use_normals=True, hierarchy_depth=3)
    want = np.asarray(JPL.render_frame(
        zb, JCAM, JAOParams(use_normals=True, hierarchy_depth=3), normals=nb,
        impl="jnp"))
    for impl in ("auto", "pallas"):
        got = render_frame(zb, CAM, par, normals=nb, impl=impl,
                           device="cpu").numpy()
        assert got.shape == (2, 100, 150)
        np.testing.assert_allclose(got, want, atol=TOL)
    one = render_frame(z2, CAM, par, normals=np.moveaxis(n2, -1, -3),
                       device="cpu")
    np.testing.assert_allclose(one.numpy(), want[1], atol=TOL)


def test_render_frame_normals_debug_levels():
    z, n = scene(64, 96)
    for impl in ("auto", "pallas"):
        _, dbg = render_frame(z, CAM, AOParams(use_normals=True), normals=n,
                              impl=impl, debug_outputs=True, device="cpu")
        # no fused step with normals: every level renders
        assert sorted(dbg["ao_levels"]) == [1, 2, 3, 4]


def test_normals_tensor_on_another_device_raises():
    z, n = scene(64, 64)
    with pytest.raises(ValueError, match="device"):
        render_frame(t32(z), CAM, AOParams(use_normals=True),
                     normals=t32(n).to("meta"), device="cpu")


# ---------------------------------------------------------------------------
# golden properties of the normals path, through the port
# ---------------------------------------------------------------------------

def test_normals_path_runs_and_differs():
    z, n = scene(128, 192, seed=5, n_spheres=3)
    ao0 = render_frame(z, CAM, AOParams(), device="cpu").numpy()
    ao1 = render_frame(z, CAM, AOParams(use_normals=True), normals=n,
                       device="cpu").numpy()
    assert ao1.shape == ao0.shape
    assert np.all((ao1 >= 0) & (ao1 <= 1))
    assert not np.allclose(ao0, ao1)


def test_normals_grazing_plane_no_horizon_band():
    z, n = scene(192, 256, seed=0, n_spheres=0)
    ao = render_frame(z, CAM, AOParams(use_normals=True), normals=n,
                      device="cpu").numpy()
    assert ao.min() > 0.75, ao.min()
    assert ao.mean() > 0.97


def test_normals_flat_wall_unchanged():
    z = np.full((64, 96), 0.4, np.float32)
    n = np.zeros((64, 96, 3), np.float32)
    n[..., 2] = 1.0
    ao0 = render_frame(z, CAM, AOParams(), device="cpu").numpy()
    ao1 = render_frame(z, CAM, AOParams(use_normals=True), normals=n,
                       device="cpu").numpy()
    np.testing.assert_array_equal(ao0, ao1)

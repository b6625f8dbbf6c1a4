"""The port's engine, presets, params I/O and camera utilities against
tpuao's.

Presets are held equal to ``tpuao.models.presets`` and each renders equal
to ``tpuao`` (``atol=1e-5``); ``AmbientOcclusionEngine`` is held to the
JAX engine's validation, config round trip (files written by either
package), debug view, grayscale rule and ``out_dtype``; the projection and
camera utilities are held to ``tpuao``'s on the matrices of
tests/test_camera.py.  Inputs are NumPy scenes made from a seed.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from tpuao.models import pipeline as JPL
from tpuao.models import presets as JPS
from tpuao.params import (AOParams as JAOParams, CameraParams as JCamera,
                          GoldenCameraParams, params_to_dict as j_to_dict)
from tpuao.params import TemporalParams as JTemporal
from tpuao.utils import camera as JUC
from tpuao.utils import fixtures as JF

from tpuao_torch import (AmbientOcclusionEngine, AOParams, CameraParams,
                         PRESETS, TemporalParams, preset)
from tpuao_torch.ops import kernels as K
from tpuao_torch.params import (from_tpuao, load_config, params_to_dict,
                                save_config)
from tpuao_torch.utils import camera as UC

TOL = 1e-5  # float32 port vs float32 JAX package
CAM = CameraParams(depth_mode="linear")
JCAM = JCamera(depth_mode="linear")


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


def scene(h=64, w=96, seed=1, with_normals=False):
    out = JF.spheres_on_plane(h, w, GoldenCameraParams(depth_mode="linear"),
                              n_spheres=3, seed=seed,
                              with_normals=with_normals, backend="numpy")
    if with_normals:
        return tuple(a.astype(np.float32) for a in out)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------

def test_presets_equal_tpuao():
    assert list(PRESETS) == list(JPS.PRESETS)
    for name, p in PRESETS.items():
        assert params_to_dict(p) == j_to_dict(JPS.PRESETS[name]), name
    assert preset("high") == AOParams()
    assert preset("VERY_LOW").exhaustive is False
    assert preset("ultra").use_normals is True
    with pytest.raises(ValueError, match="preset"):
        preset("nope")


@pytest.mark.parametrize("name", list(JPS.PRESETS))
def test_preset_renders_equal_tpuao(name):
    z, n = scene(64, 64, with_normals=True)
    eng = AmbientOcclusionEngine(CAM, preset(name), device="cpu")
    got = eng.render(z, normals=n).numpy()
    want = np.asarray(JPL.render_frame(z, JCAM, JPS.preset(name), normals=n,
                                       impl="jnp"))
    assert got.shape == (64, 64)
    np.testing.assert_allclose(got, want, atol=TOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_engine_api_matches_tpuao():
    z = scene()
    eng = AmbientOcclusionEngine(CAM, impl="jnp", device="cpu")
    jeng = JPL.AmbientOcclusionEngine(JCAM, impl="jnp")
    ao = eng.render(z).numpy()
    np.testing.assert_allclose(ao, np.asarray(jeng.render(z)), atol=TOL)
    for name in ("strength", "rejection_falloff", "noise_filter_tolerance",
                 "blur_tolerance", "upsample_tolerance"):
        with pytest.raises(ValueError, match=name):
            setattr(eng, name, 99.0)
    eng.strength = jeng.strength = 2.0
    eng.blur_tolerance = jeng.blur_tolerance = -2.0
    assert eng.params.strength == 2.0 and eng.params.blur_tolerance == -2.0
    ao2 = eng(z).numpy()
    np.testing.assert_allclose(ao2, np.asarray(jeng(z)), atol=TOL)
    assert ao2.mean() <= ao.mean() + 1e-6
    with pytest.raises(ValueError, match="strength"):
        eng.params = AOParams(strength=0.0)
    eng.params = AOParams(strength=1.5)
    assert eng.strength == 1.5
    color = np.ones((64, 96, 3), np.float32)
    lit = eng.render(z, color=color).numpy()
    np.testing.assert_allclose(lit[..., 0], eng.render(z).numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="impl"):
        AmbientOcclusionEngine(CAM, impl="xla", device="cpu")


def test_engine_debug_grayscale_and_out_dtype():
    z = scene(64, 64)
    eng = AmbientOcclusionEngine(CAM, impl="jnp", debug=True,
                                 out_dtype="uint8", device="cpu")
    jeng = JPL.AmbientOcclusionEngine(JCAM, impl="jnp", debug=True,
                                      out_dtype="uint8")
    gray = np.ones((64, 64), np.float32)
    view = eng.render(z, color=gray)
    assert tuple(view.shape) == (64, 64, 1) and view.dtype == torch.uint8
    want = np.asarray(jeng.render(z, color=gray))
    assert np.abs(view.numpy().astype(int) - want.astype(int)).max() <= 1
    color = np.ones((64, 64, 3), np.float32)
    view3, dbg = eng.render(z, color=color, debug_outputs=True)
    assert tuple(view3.shape) == (64, 64, 3)
    assert set(dbg["ao_levels"]) == {1, 2, 3, 4}
    # no colour: the debug flag has nothing to replace
    plain = AmbientOcclusionEngine(CAM, out_dtype="uint8",
                                   device="cpu").render(z)
    assert plain.dtype == torch.uint8 and tuple(plain.shape) == (64, 64)


def test_engine_debug_levels_under_auto():
    """The default impl's debug dict holds every level, with tpuao's
    default engine's values."""
    z = scene(64, 64)
    ao, dbg = AmbientOcclusionEngine(CAM, device="cpu").render(
        z, debug_outputs=True)
    jao, jdbg = JPL.AmbientOcclusionEngine(JCAM).render(z,
                                                        debug_outputs=True)
    assert sorted(dbg["ao_levels"]) == sorted(jdbg["ao_levels"]) == [1, 2,
                                                                      3, 4]
    for l, lvl in dbg["ao_levels"].items():
        np.testing.assert_allclose(lvl.numpy(),
                                   np.asarray(jdbg["ao_levels"][l]),
                                   atol=TOL)
    np.testing.assert_allclose(ao.numpy(), np.asarray(jao), atol=TOL)


def test_engine_out_dtype():
    z = scene(96, 128, seed=2)
    out = AmbientOcclusionEngine(CAM, out_dtype="uint8",
                                 device="cpu").render(z)
    want = np.asarray(JPL.AmbientOcclusionEngine(
        JCAM, out_dtype="uint8").render(z))
    assert out.dtype == torch.uint8 and tuple(out.shape) == (96, 128)
    assert np.abs(out.numpy().astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("writer", ["port", "tpuao"])
def test_engine_config_roundtrip(tmp_path, writer):
    path = str(tmp_path / "eng.json")
    if writer == "port":
        eng = AmbientOcclusionEngine(CAM, device="cpu")
        eng.strength = 3.0
        eng.blur_tolerance = -2.0
        assert eng.save_config(path) == path
    else:
        jeng = JPL.AmbientOcclusionEngine(JCAM)
        jeng.strength = 3.0
        jeng.blur_tolerance = -2.0
        jeng.save_config(path)
    eng2 = AmbientOcclusionEngine.from_config(path, out_dtype="uint8",
                                              device="cpu")
    jeng2 = JPL.AmbientOcclusionEngine.from_config(path, out_dtype="uint8")
    assert eng2.strength == 3.0 and eng2.blur_tolerance == -2.0
    assert eng2.camera.depth_mode == "linear"
    assert params_to_dict(eng2.params) == j_to_dict(jeng2.params)
    assert params_to_dict(eng2.camera) == j_to_dict(jeng2.camera)
    z = np.full((64, 64), 0.5, np.float32)
    out = eng2.render(z)
    assert out.dtype == torch.uint8 and tuple(out.shape) == (64, 64)


def test_save_config_reads_back_and_rejects(tmp_path):
    path = save_config(str(tmp_path / "c.json"), AOParams(strength=2.5),
                       CAM)
    assert load_config(path) == (AOParams(strength=2.5), CAM)
    bad = json.loads(open(path).read())
    bad["ao"]["strength"] = 50.0
    open(path, "w").write(json.dumps(bad))
    with pytest.raises(ValueError, match="strength"):
        load_config(path)


# ---------------------------------------------------------------------------
# TemporalParams and from_tpuao
# ---------------------------------------------------------------------------

def test_temporal_params_equal_tpuao():
    from tpuao.params import TEMPORAL_PARAM_RANGES as J_RANGES

    from tpuao_torch.params import TEMPORAL_PARAM_RANGES

    assert TEMPORAL_PARAM_RANGES == J_RANGES
    names = [f.name for f in dataclasses.fields(TemporalParams)]
    assert names == [f.name for f in dataclasses.fields(JTemporal)]
    for f in dataclasses.fields(TemporalParams):
        assert f.default == getattr(JTemporal(), f.name), f.name


@pytest.mark.parametrize("bad", [dict(history_weight=1.5),
                                 dict(history_weight=-0.1),
                                 dict(depth_tolerance=0.0),
                                 dict(max_displacement=0),
                                 dict(max_displacement=65),
                                 dict(max_displacement=2.5)])
def test_temporal_params_validate_like_tpuao(bad):
    with pytest.raises(ValueError):
        JTemporal(**bad).validate()
    with pytest.raises(ValueError):
        TemporalParams(**bad).validate()
    TemporalParams().validate()
    assert TemporalParams().replace(max_displacement=None).max_displacement \
        is None


def test_from_tpuao_carries_temporal_params():
    ja = JAOParams(strength=1.5, use_normals=True)
    jt = JTemporal(history_weight=0.7, max_displacement=3,
                   neighborhood_clamp=False)
    jt_dict = {f.name: getattr(jt, f.name) for f in dataclasses.fields(jt)}
    ap, cam, tp = from_tpuao(j_to_dict(ja), j_to_dict(JCAM), jt_dict)
    assert ap == AOParams(strength=1.5, use_normals=True) and cam == CAM
    assert tp == TemporalParams(history_weight=0.7, max_displacement=3,
                                neighborhood_clamp=False)
    assert len(from_tpuao(j_to_dict(ja), j_to_dict(JCAM))) == 2
    with pytest.raises(ValueError, match="history_weight"):
        from_tpuao(j_to_dict(ja), j_to_dict(JCAM), {"history_weight": 2.0})
    assert params_to_dict(TemporalParams(max_displacement=None))[
        "max_displacement"] is None


# ---------------------------------------------------------------------------
# projection matrices and camera utilities (tests/test_camera.py's)
# ---------------------------------------------------------------------------

def _rh_mat(a, b, fovx_deg=70.0, aspect=16 / 9):
    x = 1.0 / math.tan(math.radians(fovx_deg) / 2)
    p = np.zeros((4, 4))
    p[0, 0] = x
    p[1, 1] = x * aspect
    p[2, 2] = a
    p[2, 3] = b
    p[3, 2] = -1.0
    return p


def _unity_reversed(n, f):
    return _rh_mat(n / (f - n), n * f / (f - n))


def _unity_forward(n, f):
    return _rh_mat(-f / (f - n), -f * n / (f - n))


def _gl(n, f):
    return _rh_mat(-(f + n) / (f - n), -2 * f * n / (f - n))


def _cam_tuple(c):
    return (float(c.near), float(c.far), float(c.tan_half_fov_h),
            bool(c.reversed_z), c.depth_mode)


@pytest.mark.parametrize("mk,conv", [(_unity_reversed, "unity"),
                                     (_unity_forward, "unity"),
                                     (_gl, "gl")])
@pytest.mark.parametrize("transpose", [False, True])
def test_from_projection_equals_tpuao(mk, conv, transpose):
    p = mk(0.3, 250.0)
    p = p.T if transpose else p
    got = CameraParams.from_projection(p, convention=conv)
    want = JCamera.from_projection(p, convention=conv)
    assert _cam_tuple(got) == _cam_tuple(want)
    lh = UC.perspective_projection(0.5, 80.0, 0.9, reversed_z=True)
    assert (_cam_tuple(CameraParams.from_projection(lh.ravel()))
            == _cam_tuple(JCamera.from_projection(lh.ravel())))


def test_from_projection_rejects_like_tpuao():
    sheared = _unity_reversed(0.3, 100.0)
    sheared[2, 0] = 0.2
    assert (_cam_tuple(CameraParams.from_projection(sheared))
            == _cam_tuple(JCamera.from_projection(sheared)))
    for bad, kw, match in ((np.eye(3), {}, "16 values"),
                           (np.eye(4), {}, "perspective"),
                           (_rh_mat(0.0, 0.3), {}, "infinite"),
                           (_unity_reversed(1, 10), {"convention": "dx"},
                            "convention")):
        with pytest.raises(ValueError, match=match):
            JCamera.from_projection(bad, **kw)
        with pytest.raises(ValueError, match=match):
            CameraParams.from_projection(bad, **kw)


@pytest.mark.parametrize("reversed_z", [True, False])
def test_camera_utils_equal_tpuao(reversed_z):
    p = UC.perspective_projection(0.3, 250.0, 0.7, aspect=2.0,
                                  reversed_z=reversed_z)
    np.testing.assert_array_equal(p, JUC.perspective_projection(
        0.3, 250.0, 0.7, aspect=2.0, reversed_z=reversed_z))
    for m in (p, p.T):
        assert (_cam_tuple(UC.camera_from_projection(m))
                == _cam_tuple(JUC.camera_from_projection(m)))
    z = np.linspace(0.3, 250.0, 17)
    np.testing.assert_array_equal(UC.hardware_depth(z, p),
                                  JUC.hardware_depth(z, p))
    np.testing.assert_array_equal(UC.hardware_depth(z, p.T),
                                  JUC.hardware_depth(z, p.T))
    b1 = UC.perspective_projection(0.5, 1.0, 0.7)  # B == 1: not ambiguous
    assert (_cam_tuple(UC.camera_from_projection(b1))
            == _cam_tuple(JUC.camera_from_projection(b1)))
    for bad in (np.eye(3), np.zeros((4, 4)), np.eye(4)):
        with pytest.raises(ValueError):
            UC.camera_from_projection(bad)
        with pytest.raises(ValueError):
            JUC.camera_from_projection(bad)
    with pytest.raises(ValueError):
        UC.perspective_projection(2.0, 1.0, 0.5)


def test_relative_motion_equals_tpuao():
    rng = np.random.default_rng(4)
    v0, v1 = np.eye(4), np.eye(4)
    v0[:3, 3] = rng.uniform(-1, 1, 3)
    v1[:3, :3] = [[0.99, -0.1, 0.0], [0.1, 0.99, 0.0], [0.0, 0.0, 1.0]]
    v1[:3, 3] = rng.uniform(-1, 1, 3)
    np.testing.assert_array_equal(UC.relative_motion(v0, v1),
                                  JUC.relative_motion(v0, v1))
    np.testing.assert_allclose(UC.relative_motion(v1, v1), np.eye(4),
                               atol=1e-12)

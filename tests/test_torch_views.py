"""tpuao_torch.parallel.sharding against tpuao's, on the CPU.

``render_views`` is the frame pipeline over a leading views axis, which the
port's kernels take as their grid's batch; it is held against tpuao's
vmapped ``render_views`` (impl="jnp") to 1e-5, float32 against float32.
``render_views_sharded`` and the engine's ``render_views`` are held against
tpuao's on a 4-device CPU mesh (the conftest's fake devices): the port on
one batch, and on its own mesh of ``["cpu"] * 4`` (4 and 5 views, a rig,
colour with uint8).
"""

import dataclasses
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpuao.models import pipeline as JPL
from tpuao.models.presets import preset as jpreset
from tpuao.params import AOParams as JAOParams
from tpuao.params import CameraParams as JCameraParams
from tpuao.parallel import sharding as JSH

from tpuao_torch.models.pipeline import AmbientOcclusionEngine, render_frame
from tpuao_torch.models.presets import preset
from tpuao_torch.ops import kernels as K
from tpuao_torch.params import AOParams, CameraParams, from_tpuao
from tpuao_torch.parallel import sharding as SH
from tpuao_torch.utils import fixtures as F

TOL = 1e-5


def views(n, h=48, w=64, normals=False):
    out = [F.spheres_on_plane(h, w, CameraParams(depth_mode="linear"),
                              n_spheres=2, seed=s, with_normals=normals)
           for s in range(n)]
    if normals:
        return (np.stack([z for z, _ in out]).astype(np.float32),
                np.stack([n for _, n in out]).astype(np.float32))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("use_normals", [False, True])
def test_render_views_matches_tpuao(use_normals):
    cam, jcam = (CameraParams(depth_mode="linear"),
                 JCameraParams(depth_mode="linear"))
    if use_normals:
        z, n = views(3, normals=True)
    else:
        z, n = views(3), None
    got = SH.render_views(z, cam, AOParams(use_normals=use_normals),
                          normals=n, device="cpu")
    want = np.asarray(JSH.render_views(
        jnp.asarray(z), jcam, JAOParams(use_normals=use_normals),
        normals=None if n is None else jnp.asarray(n), impl="jnp"))
    assert got.shape == (3, 48, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    for i in range(3):  # a view's result does not depend on its batch
        np.testing.assert_array_equal(
            got[i].numpy(),
            render_frame(z[i], cam, AOParams(use_normals=use_normals),
                         normals=None if n is None else n[i],
                         device="cpu").numpy())
    with pytest.raises(ValueError, match="V, H, W"):
        SH.render_views(z[0], cam, device="cpu")


@pytest.mark.parametrize("pad", [0, 1, 5])
def test_pad_leading_matches_tpuao(pad):
    x = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    got = SH.pad_leading(torch.as_tensor(x), pad)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JSH.pad_leading(jnp.asarray(x), pad)))
    with pytest.raises(ValueError, match="pad"):
        SH.pad_leading(torch.as_tensor(x), -1)


def test_multi_card_modes_are_not_defined():
    """make_mesh's bounds, as tpuao's: more devices than there are, or
    none at all, raise; a mesh may name one device several times.  An
    empty mesh renders nothing."""
    mesh = SH.make_mesh(3, devices=["cpu"] * 4)
    assert mesh == (torch.device("cpu"),) * 3
    assert SH.make_1d_mesh("rows", devices=["cpu"]) == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="mesh of 5 devices requested, "
                       "have 4"):
        SH.make_mesh(5, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="mesh of 9 devices requested"):
        JSH.make_mesh(9)  # the reference's message, on its 8 devices
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="requested"):
            SH.make_mesh(2)
    with pytest.raises(ValueError, match="no device"):
        SH.make_mesh(devices=[])
    with pytest.raises(ValueError, match="no device"):
        SH.render_views_sharded(views(2), mesh=[], device="cpu")
    assert SH.VIEW_AXIS == JSH.VIEW_AXIS


def test_mesh_and_device_must_agree():
    """A one-device mesh and ``device=`` naming different devices raise
    rather than one silently winning; naming the same one renders."""
    cam = CameraParams(depth_mode="linear")
    with pytest.raises(ValueError, match="mesh names cpu"):
        SH.render_views_sharded(views(2), cam, mesh=["cpu"], device="cuda")
    got = SH.render_views_sharded(views(2), cam, mesh=[torch.device("cpu")],
                                  device="cpu")
    want = SH.render_views_sharded(views(2), cam, device="cpu")
    assert torch.equal(got, want)


# -- render_views_sharded against tpuao's on a 4-device CPU mesh ------------

V, VH, VW = 4, 64, 128
LIN = dict(depth_mode="linear")


def _jax_mesh():
    return JSH.make_mesh(4)


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("case", ["uniform", "normals", "color_uint8",
                                  "debug"])
def test_render_views_sharded_matches_tpuao(case):
    if case == "normals":
        z, n = views(V, VH, VW, normals=True)
    else:
        z, n = views(V, VH, VW), None
    par = dict(use_normals=case == "normals", strength=1.5)
    kw = {}
    if case == "color_uint8":
        rng = np.random.default_rng(5)
        kw = dict(color=rng.integers(0, 256, (V, VH, VW, 3), dtype=np.uint8),
                  out_dtype="uint8")
    if case == "debug":
        kw = dict(debug_outputs=True)
    got = SH.render_views_sharded(z, CameraParams(**LIN), AOParams(**par),
                                  normals=n, device="cpu", **kw)
    want = JSH.render_views_sharded(
        jnp.asarray(z), JCameraParams(**LIN), JAOParams(**par),
        normals=None if n is None else jnp.asarray(n), mesh=_jax_mesh(),
        **kw)
    if case == "debug":
        (got, dbg), (want, jdbg) = got, want
        g, w = _leaves(dbg), _leaves(jdbg)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].shape == w[k].shape and g[k].shape[0] == V, k
            np.testing.assert_allclose(g[k], w[k], atol=TOL, err_msg=k)
    want = np.asarray(want)
    assert got.shape == want.shape and got.numpy().dtype == want.dtype
    if case == "color_uint8":  # integer codes: float noise may move one
        assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    # the same batch through render_frame: bit for bit
    ref = render_frame(z, CameraParams(**LIN), AOParams(**par), normals=n,
                       device="cpu", **kw)
    ref = ref[0] if case == "debug" else ref
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def _rig(fovs, strengths):
    """A four-view rig (near, far, fov and strength per view) in both
    packages: the port's through ``params.from_tpuao``."""
    tan = [math.tan(math.radians(f) / 2) for f in fovs]
    jcam = JCameraParams(near=jnp.full(V, 0.1), far=jnp.full(V, 100.0),
                         tan_half_fov_h=jnp.asarray(tan, jnp.float32),
                         **LIN)
    jpar = JAOParams(**{k: jnp.full(V, getattr(JAOParams(), k))
                        for k in SH.RIG_PARAM_FIELDS if k != "strength"},
                     strength=jnp.asarray(strengths, jnp.float32))
    par, cam = from_tpuao(_fields(jpar), _fields(jcam))
    return cam, par, jcam, jpar


def test_per_view_rig_matches_tpuao_and_each_view_its_own_frame():
    z = views(V, VH, VW)
    cam, par, jcam, jpar = _rig([50.0, 60.0, 75.0, 90.0],
                                [0.5, 1.0, 2.0, 3.0])
    assert isinstance(cam.tan_half_fov_h, np.ndarray)
    assert cam.tan_half_fov_h.shape == (V,)
    got = SH.render_views_sharded(z, cam, par, per_view=True, device="cpu")
    want = np.asarray(JSH.render_views_sharded(
        jnp.asarray(z), jcam, jpar, mesh=_jax_mesh(), per_view=True))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    for i in range(V):  # each view with its own scalars, bit for bit
        own_c = cam.replace(**{k: float(getattr(cam, k)[i])
                               for k in SH.RIG_CAMERA_FIELDS})
        own_p = par.replace(**{k: float(getattr(par, k)[i])
                               for k in SH.RIG_PARAM_FIELDS})
        np.testing.assert_array_equal(
            got[i].numpy(), render_frame(z[i], own_c, own_p,
                                         device="cpu").numpy())
    # the views differ: the rig reached every one
    assert len({float(got[i].mean()) for i in range(V)}) == V


def test_per_view_rig_groups_views_that_share_their_values(monkeypatch):
    """A rig of 4 views with 2 distinct value sets renders 2 batches (one
    coarsest-level render call each), writes them back in view order, and
    keeps colour, uint8 and the debug leaves per view."""
    z = views(V, VH, VW)
    cam, par, _, _ = _rig([60.0, 80.0, 60.0, 80.0], [1.0, 2.0, 1.0, 2.0])
    rng = np.random.default_rng(9)
    color = rng.integers(0, 256, (V, VH, VW, 3), dtype=np.uint8)
    calls = []
    real = K.render_ao_level
    monkeypatch.setattr(K, "render_ao_level",
                        lambda *a, **k: calls.append(a[0].shape[0])
                        or real(*a, **k))
    got, dbg = SH.render_views_sharded(z, cam, par, color=color,
                                       out_dtype="uint8", debug_outputs=True,
                                       per_view=True, device="cpu")
    assert calls.count(2) == 8 and len(calls) == 8  # 2 groups x 4 levels
    calls.clear()
    SH.render_views_sharded(z, cam, par, per_view=True, device="cpu")
    assert calls == [2, 2]  # one render of the coarsest level a group
    for i in range(V):
        own_c = cam.replace(tan_half_fov_h=float(cam.tan_half_fov_h[i]),
                            near=0.1, far=100.0)
        own_p = par.replace(**{k: float(getattr(par, k)[i])
                               for k in SH.RIG_PARAM_FIELDS})
        out, odbg = render_frame(z[i], own_c, own_p, color=color[i],
                                 out_dtype="uint8", debug_outputs=True,
                                 device="cpu")
        np.testing.assert_array_equal(got[i].numpy(), out.numpy())
        for k, v in _leaves(odbg).items():
            np.testing.assert_array_equal(_leaves(dbg)[k][i], v, err_msg=k)
    assert got.dtype == torch.uint8 and got.shape == color.shape


def test_per_view_rejects_leaves_of_another_shape():
    z = views(V, VH, VW)
    cam, par, _, _ = _rig([60.0] * V, [1.0] * V)
    with pytest.raises(ValueError, match="per_view"):
        SH.render_views_sharded(z, cam.replace(near=0.1), par,
                                per_view=True, device="cpu")
    with pytest.raises(ValueError, match="per_view"):
        SH.render_views_sharded(z, cam, par.replace(strength=np.ones(3)),
                                per_view=True, device="cpu")
    # a uniform rig is one batch, equal to the scalar call
    np.testing.assert_array_equal(
        SH.render_views_sharded(z, cam, par, per_view=True,
                                device="cpu").numpy(),
        SH.render_views_sharded(
            z, CameraParams(tan_half_fov_h=float(cam.tan_half_fov_h[0]),
                            **LIN), AOParams(), device="cpu").numpy())


def test_engine_render_views_matches_tpuao():
    z, n = views(V, VH, VW, normals=True)
    eng = AmbientOcclusionEngine(CameraParams(**LIN), preset("ULTRA"),
                                 out_dtype="uint8", device="cpu")
    jeng = JPL.AmbientOcclusionEngine(JCameraParams(**LIN),
                                      jpreset("ULTRA"), out_dtype="uint8")
    got = eng.render_views(z, normals=n)
    want = np.asarray(jeng.render_views(jnp.asarray(z),
                                        normals=jnp.asarray(n),
                                        mesh=_jax_mesh()))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(got.numpy(),
                                  eng.render(z, normals=n).numpy())


# -- the port's own mesh: ["cpu"] * 4 against tpuao's 4-device mesh --------

MESH4 = ["cpu"] * 4


@pytest.mark.parametrize("case", ["4 views", "5 views debug", "rig",
                                  "color_uint8"])
def test_mesh_matches_tpuao(case, monkeypatch):
    """Each shard renders its slice as one batch (one coarsest-level
    render a shard); an uneven count pads to the mesh and crops the
    primary output, the debug leaves keeping the padded count."""
    n = 5 if case == "5 views debug" else V
    z = views(n, VH, VW)
    cam, par = CameraParams(**LIN), AOParams(strength=1.5)
    jcam, jpar = JCameraParams(**LIN), JAOParams(strength=1.5)
    kw = {}
    if case == "rig":
        cam, par, jcam, jpar = _rig([50.0, 60.0, 75.0, 90.0],
                                    [0.5, 1.0, 2.0, 3.0])
        kw = dict(per_view=True)
    if case == "color_uint8":
        rng = np.random.default_rng(5)
        kw = dict(color=rng.integers(0, 256, (V, VH, VW, 3), dtype=np.uint8),
                  out_dtype="uint8")
    if case == "5 views debug":
        kw = dict(debug_outputs=True)
    calls = []
    real = K.render_ao_level
    monkeypatch.setattr(K, "render_ao_level",
                        lambda *a, **k: calls.append(a[0].shape[0])
                        or real(*a, **k))
    got = SH.render_views_sharded(z, cam, par, mesh=MESH4, **kw)
    want = JSH.render_views_sharded(jnp.asarray(z), jcam, jpar,
                                    mesh=_jax_mesh(), **kw)
    if case == "5 views debug":
        (got, dbg), (want, jdbg) = got, want
        g, w = _leaves(dbg), _leaves(jdbg)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].shape == w[k].shape and g[k].shape[0] == 8, k
            np.testing.assert_allclose(g[k], w[k], atol=TOL, err_msg=k)
        assert calls == [2] * 16  # 4 shards x 4 levels, 2 views each
    else:
        assert calls == [1] * 4  # one view a shard, one render each
    want = np.asarray(want)
    assert got.shape == want.shape == (n, VH, VW) + (
        (3,) if case == "color_uint8" else ())
    if case == "color_uint8":
        assert got.dtype == torch.uint8
        assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    # each view as the one-batch call renders it, bit for bit
    one = SH.render_views_sharded(z, cam, par, device="cpu", **kw)
    one = one[0] if case == "5 views debug" else one
    np.testing.assert_array_equal(got.numpy(), one.numpy())


def test_mesh_device_rule_and_engine():
    """``device=`` must name the mesh's first device; the engine's
    render_views takes a mesh of two and equals its one-batch call."""
    z = views(3, VH, VW)
    with pytest.raises(ValueError, match="mesh names cpu"):
        SH.render_views_sharded(z, mesh=["cpu", "cpu"], device="cuda:0")
    eng = AmbientOcclusionEngine(CameraParams(**LIN), device="cpu")
    got = eng.render_views(z, mesh=SH.make_mesh(devices=["cpu"] * 2))
    assert got.shape == (3, VH, VW)
    np.testing.assert_array_equal(got.numpy(), eng.render_views(z).numpy())

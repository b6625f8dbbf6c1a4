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


# -- the spatial and grid modes against tpuao's on its fake CPU devices -----
#
# tpuao runs with impl="jnp" (its spatial modes' default) over the first n
# of its 8 CPU devices; the port with its default impl ("auto": the plain
# ops on the CPU) over a mesh of ["cpu"] * n.

from tpuao.parallel import grid as JGR  # noqa: E402
from tpuao.parallel import spatial as JSP  # noqa: E402

from tpuao_torch.parallel import grid as GR  # noqa: E402
from tpuao_torch.parallel import spatial as SP  # noqa: E402

SH_W = 128  # narrow frames: the band rules are about rows


def _frame(h, seed, normals=False):
    out = F.spheres_on_plane(h, SH_W, CameraParams(**LIN), n_spheres=3,
                             seed=seed, with_normals=normals)
    if normals:
        return out[0].astype(np.float32), out[1].astype(np.float32)
    return out.astype(np.float32)


def _halo_padded(x, halo, axis=0):
    """``x`` edge-replicated by ``halo`` rows at the top and the bottom."""
    top = np.repeat(np.take(x, [0], axis=axis), halo, axis=axis)
    bot = np.repeat(np.take(x, [-1], axis=axis), halo, axis=axis)
    return np.concatenate([top, x, bot], axis=axis)


def _assert_leaves(dbg, jdbg):
    g, w = _leaves(dbg), _leaves(jdbg)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, (k, g[k].shape, w[k].shape)
        np.testing.assert_allclose(g[k], w[k], atol=TOL, err_msg=k)


@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("blur", [True, False])
def test_stencil_halo_rows_matches_tpuao(d, blur):
    got = SP.stencil_halo_rows(AOParams(hierarchy_depth=d, enable_blur=blur))
    assert got == JSP.stencil_halo_rows(
        JAOParams(hierarchy_depth=d, enable_blur=blur))
    assert got % 64 == 0
    assert SP.HALO_ROWS == JSP.HALO_ROWS == 320
    assert SP.stencil_halo_rows(AOParams()) == SP.HALO_ROWS
    assert SP.ROW_AXIS == JSP.ROW_AXIS


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("axis", [0, 1])
def test_edge_pad_rows_matches_tpuao(dtype, axis):
    rng = np.random.default_rng(3)
    x = (rng.uniform(0, 255, (3, 100, 5)) if axis else
         rng.uniform(0, 255, (100, 5, 3))).astype(dtype)
    for target in (100, 130):
        got = SP.edge_pad_rows(torch.as_tensor(x), target, axis)
        want = np.asarray(JSP.edge_pad_rows(jnp.asarray(x), target, axis))
        assert got.dtype == torch.as_tensor(x).dtype
        np.testing.assert_array_equal(got.numpy(), want)
    for n in (1, 2, 4):
        got = SP.pad_rows_aligned(torch.as_tensor(x), n, axis)
        want = np.asarray(JSP.pad_rows_aligned(jnp.asarray(x), n, axis))
        assert got.shape[axis] == -(-100 // (64 * n)) * 64 * n
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axis", [0, 1])
def test_halo_extend_rows_slices_the_edge_padded_frame(axis):
    """4 bands of 8 rows with a halo of 3: band i extended is rows
    [8 i, 8 i + 14) of the frame edge-replicated by 3 rows, whatever the
    leading view axis."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, 32, 5) if axis else (32, 5, 3))
    x = x.astype(np.float32)
    bands = [torch.as_tensor(b) for b in np.split(x, 4, axis=axis)]
    ext = SP.halo_extend_rows(bands, 3, axis)
    padded = _halo_padded(x, 3, axis)
    assert len(ext) == 4
    for i, e in enumerate(ext):
        np.testing.assert_array_equal(
            e.numpy(), np.take(padded, range(8 * i, 8 * i + 14), axis=axis))
    one = SP.halo_extend_rows([torch.as_tensor(x)], 3, axis)
    np.testing.assert_array_equal(one[0].numpy(), padded)


def test_crop_debug_rows_matches_tpuao():
    rng = np.random.default_rng(5)
    halo, band = 64, 128  # ext 256: level 0 and level 2 leaves
    dbg = {"linear_z": rng.uniform(size=(256, 16)).astype(np.float32),
           "ao_levels": {2: rng.uniform(size=(64, 4)).astype(np.float32)},
           "views": rng.uniform(size=(3, 128, 8)).astype(np.float32)}
    got = SP.crop_debug_rows({k: (torch.as_tensor(v) if k != "ao_levels"
                                  else {2: torch.as_tensor(v[2])})
                              for k, v in dbg.items()}, halo, band)
    want = JSP.crop_debug_rows(
        {"linear_z": jnp.asarray(dbg["linear_z"]),
         "ao_levels": {2: jnp.asarray(dbg["ao_levels"][2])},
         "views": jnp.asarray(dbg["views"])}, halo, band)
    assert got["views"].shape == (3, 64, 8)
    _assert_leaves(got, want)


@pytest.mark.parametrize("case", ["depth", "normals colour debug",
                                  "channel-first auto_pad"])
def test_render_frame_spatial_matches_tpuao(case, monkeypatch):
    """One frame on 2 bands: tpuao's to 1e-5 (uint8 codes within 1), and
    bit-equal to the port's own frame program on the halo-padded frame,
    cropped -- each band one render of its coarsest level."""
    cam, jcam = CameraParams(**LIN), JCameraParams(**LIN)
    kw, nrm = {}, None
    if case == "depth":  # d = 4, halo 320, bands of 384
        h, par = 768, dict()
        z = _frame(h, 1)
    else:  # d = 2 with normals, halo 128
        h, par = (256, dict(hierarchy_depth=2, use_normals=True))
        if case == "channel-first auto_pad":
            h = 200  # padded to 256
        z, nrm = _frame(h, 2, normals=True)
        if case == "channel-first auto_pad":
            nrm = np.ascontiguousarray(np.moveaxis(nrm, -1, 0))
        else:
            rng = np.random.default_rng(6)
            kw = dict(color=rng.integers(0, 256, (h, SH_W, 3),
                                         dtype=np.uint8),
                      out_dtype="uint8", debug_outputs=True)
    halo = SP.stencil_halo_rows(AOParams(**par))
    assert halo == (320 if case == "depth" else 128)
    calls = []
    real = K.render_ao_level
    monkeypatch.setattr(K, "render_ao_level",
                        lambda *a, **k: calls.append(a[0].shape)
                        or real(*a, **k))
    got = SP.render_frame_spatial(z, cam, AOParams(**par), mesh=["cpu"] * 2,
                                  normals=nrm, **kw)
    if case == "depth":
        assert len(calls) == 2  # the coarsest level, once a band
    want = JSP.render_frame_spatial(
        jnp.asarray(z), jcam, JAOParams(**par), mesh=JSP.make_row_mesh(2),
        impl="jnp", normals=None if nrm is None else jnp.asarray(nrm), **kw)
    if kw.get("debug_outputs"):
        (got, dbg), (want, jdbg) = got, want
        _assert_leaves(dbg, jdbg)
        assert dbg["linear_z"].shape == (h, SH_W)
    want = np.asarray(want)
    assert got.shape == want.shape and got.numpy().dtype == want.dtype
    if "color" in kw:
        assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    # the port's frame program on the halo-padded (and aligned) frame
    hp = -(-h // 128) * 128
    zp = _halo_padded(np.concatenate([z, np.repeat(z[-1:], hp - h, 0)]),
                      halo)
    npad = None
    if nrm is not None:
        ncl = nrm if nrm.shape[-1] == 3 else np.moveaxis(nrm, 0, -1)
        npad = _halo_padded(np.concatenate(
            [ncl, np.repeat(ncl[-1:], hp - h, 0)]), halo)
    ref = render_frame(zp, cam, AOParams(**par), normals=npad,
                       device="cpu")[halo: halo + h]
    if "color" in kw:
        ref = render_frame(zp, cam, AOParams(**par), normals=npad,
                           color=_halo_padded(kw["color"], halo),
                           out_dtype="uint8", device="cpu")[halo: halo + h]
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_spatial_constraints_raise():
    z = _frame(768, 1)
    with pytest.raises(ValueError, match="band height 192 < halo 320"):
        SP.render_frame_spatial(z, mesh=["cpu"] * 4)
    with pytest.raises(ValueError, match=r"H=700 must be a multiple of "
                       r"64\*mesh \(128\)"):
        SP.render_frame_spatial(z[:700], mesh=["cpu"] * 2, auto_pad=False)
    with pytest.raises(ValueError, match="multiple of 64"):
        SP.render_frame_spatial(z, mesh=["cpu"] * 2, halo_rows=100)
    with pytest.raises(ValueError, match="one .H, W. frame"):
        SP.render_frame_spatial(z[None], mesh=["cpu"])
    with pytest.raises(ValueError, match="views 3 not divisible by view "
                       "mesh 2"):
        GR.render_views_spatial(np.stack([z] * 3),
                                mesh=GR.make_grid_mesh(2, 1, ["cpu"] * 2))
    with pytest.raises(ValueError, match="band height 256 < halo 320: use "
                       "fewer row bands"):
        GR.render_views_spatial(np.stack([z] * 2),
                                mesh=GR.make_grid_mesh(1, 3, ["cpu"] * 3))
    with pytest.raises(ValueError, match="grid 2x4 needs 8 devices, have 4"):
        GR.make_grid_mesh(2, 4, ["cpu"] * 4)
    with pytest.raises(ValueError, match="grid 3x3 needs 9 devices, have 8"):
        JGR.make_grid_mesh(3, 3)  # the reference's message
    with pytest.raises(ValueError, match="mesh names cpu"):
        SP.render_frame_spatial(z, mesh=["cpu"] * 2, device="cuda:0")
    if not torch.cuda.is_available():  # no default mesh without a card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SP.render_frame_spatial(z)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GR.render_views_spatial(np.stack([z] * 2))
    # a mesh of one still edge-replicates the halo: device= alone is one
    np.testing.assert_array_equal(
        SP.render_frame_spatial(z, device="cpu").numpy(),
        SP.render_frame_spatial(z, mesh=["cpu"] * 2).numpy())
    assert SP.make_row_mesh(devices=["cpu"] * 2) == (torch.device("cpu"),) * 2


@pytest.mark.parametrize("case", ["2 views", "4 views", "rig", "debug"])
def test_render_views_spatial_matches_tpuao(case, monkeypatch):
    """2 views x 2 bands (halo 128, d = 2): tpuao's grid to 1e-5, and each
    view bit-equal to the port's own spatial run; a device block renders
    its views as one batch (one batch a distinct rig row)."""
    n = 2 if case == "2 views" else 4
    h = 200  # padded to 256: bands of 128
    cam, jcam = CameraParams(**LIN), JCameraParams(**LIN)
    par, jpar = AOParams(hierarchy_depth=2), JAOParams(hierarchy_depth=2)
    z = np.stack([_frame(h, s) for s in range(n)])
    kw = {}
    if case == "rig":  # 2 distinct value sets, one a view of each block
        cam, par, jcam, jpar = _rig([60.0, 80.0, 60.0, 80.0],
                                    [1.0, 2.0, 1.0, 2.0])
        par, jpar = (p.replace(hierarchy_depth=2) for p in (par, jpar))
        kw = dict(per_view=True)
    if case == "debug":
        kw = dict(debug_outputs=True)
    calls = []
    real = K.render_ao_level
    monkeypatch.setattr(K, "render_ao_level",
                        lambda *a, **k: calls.append(a[0].shape[0])
                        or real(*a, **k))
    mesh = GR.make_grid_mesh(2, 2, ["cpu"] * 4)
    got = GR.render_views_spatial(z, cam, par, mesh=mesh, **kw)
    k = n // 2  # views a block
    if case == "rig":
        assert calls == [1] * 8  # 4 blocks x 2 distinct rows
    elif case != "debug":
        assert calls == [k] * 4  # one batch a device block
    want = JGR.render_views_spatial(jnp.asarray(z), jcam, jpar,
                                    mesh=JGR.make_grid_mesh(2, 2),
                                    impl="jnp", **kw)
    if case == "debug":
        (got, dbg), (want, jdbg) = got, want
        _assert_leaves(dbg, jdbg)
        assert dbg["linear_z"].shape == (n, 256, SH_W)
    want = np.asarray(want)
    assert got.shape == want.shape == (n, h, SH_W)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    for i in range(n):  # each view as its own spatial run, bit for bit
        c, p = cam, par
        if case == "rig":
            c = cam.replace(**{f: float(getattr(cam, f)[i])
                               for f in SH.RIG_CAMERA_FIELDS})
            p = par.replace(**{f: float(getattr(par, f)[i])
                               for f in SH.RIG_PARAM_FIELDS})
        np.testing.assert_array_equal(
            got[i].numpy(), SP.render_frame_spatial(
                z[i], c, p, mesh=["cpu"] * 2).numpy())


def test_engine_render_spatial_matches_tpuao():
    z = _frame(768, 3)
    eng = AmbientOcclusionEngine(CameraParams(**LIN), out_dtype="uint8",
                                 device="cpu")
    jeng = JPL.AmbientOcclusionEngine(JCameraParams(**LIN),
                                      out_dtype="uint8", impl="jnp")
    got = eng.render_spatial(z, mesh=SP.make_row_mesh(devices=["cpu"] * 2))
    want = np.asarray(jeng.render_spatial(jnp.asarray(z),
                                          mesh=JSP.make_row_mesh(2)))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(
        got.numpy(), SP.render_frame_spatial(
            z, CameraParams(**LIN), mesh=["cpu"] * 2,
            out_dtype="uint8").numpy())


# -- sequential sections against tpuao's, and against the port's own frame --
#
# tpuao and the port both with impl="jnp" (the port's plain ops on the
# CPU); tpuao's own bound for its sections against its frame is 2e-6
# (tests/test_sections.py).  The port's sections equal its monolithic
# frame: bounded at 1e-6 here and printed (0.0 expected).

from tpuao.parallel import sections as JSC  # noqa: E402

from tpuao_torch.parallel import sections as SC  # noqa: E402

SEC_TOL = 2e-6


def _vs_monolithic(got, want, label):
    err = float((got.double() - want.double()).abs().max())
    print(f"{label}: sections vs the port's monolithic frame "
          f"max_abs_err={err:.3e}")
    assert err <= 1e-6, (label, err)


@pytest.mark.parametrize("h, k, halo", [
    (2560, 4, 320), (1000, 3, 128), (512, 1, 320), (704, 2, 320),
    (4320, 8, 320), (1080, 8, 320), (512, 2, 320), (100, 3, 64),
    (8640, 4, 320), (1, 2, 0)])
def test_section_plan_matches_tpuao(h, k, halo):
    """Bounds, band and crop offsets as tpuao's, clamped plans (band <
    halo: 1080 rows on 8, 512 on 2, 100 on 3) included."""
    assert SC.section_plan(h, k, halo) == JSC.section_plan(h, k, halo)


def test_section_plan_refuses_what_tpuao_asserts():
    for k, halo in ((0, 320), (2, 100), (2, -64)):
        with pytest.raises(ValueError):
            SC.section_plan(512, k, halo)
    with pytest.raises(AssertionError):
        JSC.section_plan(512, 2, 100)


@pytest.mark.parametrize("case", [
    "704 depth 4 k=2", "1000 depth 2 k=3", "batch of 2",
    "normals uint8 colour", "channel-first normals, 2-D colour",
    "random depth 704 k=2"])
def test_render_frame_sections_matches_tpuao(case):
    """tpuao's sections within 2e-6 (uint8 codes within 1), and the port's
    own monolithic frame within 1e-6.  On random depth tpuao's sections
    leave its frame near the bottom edge (its last section, edge-padded to
    the plan's 768 rows, ends below the frame's 704: ROADMAP queue 3), so
    the port is held to tpuao's monolithic frame there instead."""
    cam, jcam = CameraParams(**LIN), JCameraParams(**LIN)
    par, k, kw, nrm = {}, 2, {}, None
    if case in ("704 depth 4 k=2", "random depth 704 k=2"):
        z = F.spheres_on_plane(704, 64, cam, n_spheres=3, seed=6)
        if case.startswith("random"):
            z = np.random.default_rng(6).uniform(0.2, 0.9, (704, 64))
        z = z.astype(np.float32)
    elif case == "1000 depth 2 k=3":
        z = F.spheres_on_plane(1000, 64, cam, n_spheres=4, seed=7
                               ).astype(np.float32)
        par, k = dict(hierarchy_depth=2), 3
    elif case == "batch of 2":
        z = np.stack([F.spheres_on_plane(512, 64, cam, n_spheres=3,
                                         seed=20 + i) for i in range(2)]
                     ).astype(np.float32)
        par = dict(hierarchy_depth=2)
    else:  # d = 2 with normals (halo 128) on 448 rows: ha 512
        z, nrm = (a.astype(np.float32) for a in F.spheres_on_plane(
            448, 64, cam, n_spheres=4, seed=8, with_normals=True))
        par = dict(hierarchy_depth=2, use_normals=True)
        rng = np.random.default_rng(3)
        if case == "normals uint8 colour":
            kw = dict(color=rng.integers(0, 255, (448, 64, 3),
                                         dtype=np.uint8), out_dtype="uint8")
        else:
            nrm = np.ascontiguousarray(np.moveaxis(nrm, -1, 0))
            kw = dict(color=rng.uniform(0, 1, (448, 64)).astype(np.float32))
    got = SC.render_frame_sections(z, cam, AOParams(**par), n_sections=k,
                                   impl="jnp", normals=nrm, device="cpu",
                                   **kw)
    mono = render_frame(z, cam, AOParams(**par), normals=nrm, impl="jnp",
                        device="cpu", **kw)
    assert got.shape == mono.shape == np.shape(kw.get("color", z))
    assert got.dtype == mono.dtype
    if case.startswith("random"):
        want = np.asarray(JPL.render_frame(jnp.asarray(z), jcam, JAOParams(),
                                           impl="jnp"))
        np.testing.assert_allclose(got.numpy(), want, atol=TOL)
        ref = np.asarray(JSC.render_frame_sections(
            jnp.asarray(z), jcam, JAOParams(), n_sections=k, impl="jnp"))
        off = float(np.abs(ref - want).max())
        print(f"{case}: tpuao's sections vs tpuao's frame {off:.3e}")
        assert off > 1e-3  # the reference fault this case steps round
    else:
        want = np.asarray(JSC.render_frame_sections(
            jnp.asarray(z), jcam, JAOParams(**par), n_sections=k, impl="jnp",
            normals=None if nrm is None else jnp.asarray(nrm), **kw))
        if got.dtype == torch.uint8:
            assert np.abs(got.numpy().astype(int) - want.astype(int)
                          ).max() <= 1
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=SEC_TOL)
    _vs_monolithic(got, mono, case)


@pytest.mark.parametrize("d, blur, k", [
    (1, True, 2), (2, True, 2), (3, True, 2), (4, True, 2), (4, False, 2),
    (4, True, 1), (4, True, 4), (4, True, 8)])
def test_sections_equal_the_monolithic_frame(d, blur, k, monkeypatch):
    """The derived halo suffices at every depth: on random depth (no
    saturated plane to hide a truncated stencil) each section's kept rows
    equal the monolithic frame's on max(256, 2 halo) rows; one section is
    the frame bit for bit; 640 rows on 4 sections is a clamped plan (band
    192 < halo 320).  540 rows on 8 sections (band 128) leave the last
    three sections no row to keep, and they are not rendered: the
    coarsest level renders once a section that keeps rows.  At depths 1
    and 2 a halo 64 rows short of the derived one differs from the frame
    (at depths 3 and 4 the pair estimator's far taps saturate on these
    scenes, so a shorter halo reads the same)."""
    par = AOParams(hierarchy_depth=d, enable_blur=blur)
    halo = SC.stencil_halo_rows(par)
    h = 540 if k == 8 else max(256, 2 * halo)
    z = np.random.default_rng(10 + d).uniform(0.2, 0.9, (h, 64)).astype(
        np.float32)
    mono = render_frame(z, CameraParams(**LIN), par, device="cpu")
    calls = []
    real = K.render_ao_level
    monkeypatch.setattr(K, "render_ao_level",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = SC.render_frame_sections(z, CameraParams(**LIN), par,
                                   n_sections=k, device="cpu")
    if k == 1:
        np.testing.assert_array_equal(got.numpy(), mono.numpy())
    _vs_monolithic(got, mono, f"depth {d} blur {blur} k={k}")
    _, _, plan = SC.section_plan(h, k, halo)
    kept = sum(a + off < h for a, _, off in plan)
    assert len(calls) == kept == (5 if k == 8 else k)
    if d <= 2 and k == 2:  # the check has teeth: a halo 64 rows short
        short = SC.render_frame_sections(z, CameraParams(**LIN), par,
                                         halo_rows=halo - 64, device="cpu")
        assert float((short - mono).abs().max()) > 1e-3


def test_sections_fused_equals_separate_and_refuses_clamped_plans():
    """The fused form is the separate form bit for bit (tpuao's fused form
    within 2e-6), at k = 2 and 4; on a clamped plan (512 rows, k = 2,
    halo 320) it raises as tpuao's does, while the separate form still
    equals the frame; it takes one (H, W) frame of its plan's height."""
    cam, jcam = CameraParams(**LIN), JCameraParams(**LIN)
    z = F.spheres_on_plane(1280, 64, cam, n_spheres=4, seed=6).astype(
        np.float32)
    for k in (2, 4):
        got = SC.render_frame_sections_fused(z, cam, n_sections=k,
                                             device="cpu")
        np.testing.assert_array_equal(got.numpy(), SC.render_frame_sections(
            z, cam, n_sections=k, device="cpu").numpy())
    want = np.asarray(JSC.render_frame_sections_fused(
        jnp.asarray(z[:704]), jcam, JAOParams(), n_sections=2, impl="jnp"))
    got = SC.render_frame_sections_fused(z[:704], cam, impl="jnp",
                                         device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=SEC_TOL)
    small = z[:512]
    with pytest.raises(ValueError, match="band 256 < halo 320"):
        SC.render_frame_sections_fused(small, cam, device="cpu")
    with pytest.raises(AssertionError, match="band"):
        JSC.render_frame_sections_fused(jnp.asarray(small), jcam,
                                        JAOParams(), n_sections=2,
                                        impl="jnp")
    _vs_monolithic(SC.render_frame_sections(small, cam, device="cpu"),
                   render_frame(small, cam, device="cpu"), "512 rows, k=2")
    with pytest.raises(ValueError, match="single .H, W. frame"):
        SC.render_frame_sections_fused(z[None], cam, device="cpu")
    fn = SC.sections_fused_fn(2, 768, 384, 320, "auto")
    with pytest.raises(ValueError, match="does not align"):
        fn(torch.as_tensor(z), cam, AOParams())
    if not torch.cuda.is_available():  # NumPy goes to the card by default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SC.render_frame_sections(small)


def test_engine_render_sections_matches_the_function():
    """The engine's render_sections passes its camera, params, impl,
    out_dtype and device: the function's result, and ``render``'s."""
    cam = CameraParams(**LIN)
    z, n = (a.astype(np.float32) for a in F.spheres_on_plane(
        704, 64, cam, n_spheres=3, seed=5, with_normals=True))
    eng = AmbientOcclusionEngine(cam, preset("ULTRA"), out_dtype="uint8",
                                 device="cpu")
    got = eng.render_sections(z, 3, normals=n)
    assert got.dtype == torch.uint8 and got.shape == z.shape
    np.testing.assert_array_equal(got.numpy(), SC.render_frame_sections(
        z, cam, preset("ULTRA"), n_sections=3, normals=n, out_dtype="uint8",
        device="cpu").numpy())
    np.testing.assert_array_equal(got.numpy(), eng.render(z, normals=n)
                                  .numpy())

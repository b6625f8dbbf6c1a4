"""The port's frame path against tpuao's, end to end.

``tpuao_torch.render_frame`` on CPU tensors (every ``impl`` runs the plain
versions there) against ``tpuao.render_frame`` with ``impl="jnp"`` and with
``impl="fused"`` (its Pallas kernels in interpret mode) at ``atol=1e-5``,
and against the float64 golden ``render_frame_golden`` at ``atol=1e-4``.
Inputs are NumPy scenes made from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch

from tpuao import AOParams as JAOParams, CameraParams as JCamera
from tpuao.golden import render_frame_golden
from tpuao.models import pipeline as JPL
from tpuao.params import GoldenAOParams, GoldenCameraParams
from tpuao.utils import fixtures as JF

from tpuao_torch import AOParams, CameraParams, render_frame
from tpuao_torch.models import pipeline as TPL
from tpuao_torch.ops import kernels as K

TOL = 1e-5   # float32 port vs float32 JAX package
GTOL = 1e-4  # float32 port vs float64 golden


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so these tests do not crowd the
    CPU that the suite's other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene(h, w, seed=3, hardware=False, batch=None):
    """Depth (float32) and the matching (port, jax, golden) cameras."""
    kw = {} if hardware else {"depth_mode": "linear"}
    gcam = GoldenCameraParams(**kw)
    seeds = [seed] if batch is None else [seed + i for i in range(batch)]
    zs = [JF.spheres_on_plane(h, w, gcam, n_spheres=4, seed=s,
                              backend="numpy") for s in seeds]
    if hardware:
        zs = [JF.to_hardware_depth(z, gcam) for z in zs]
    z = np.stack(zs) if batch is not None else zs[0]
    return z.astype(np.float32), CameraParams(**kw), JCamera(**kw), gcam


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    K.reset_launch_counts()
    yield
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)


CASES = {
    "128x192_linear": dict(h=128, w=192),
    "100x150_hardware_reversed_z": dict(h=100, w=150, hardware=True),
    "depth1": dict(h=64, w=128, par=dict(hierarchy_depth=1)),
    "depth2": dict(h=64, w=128, par=dict(hierarchy_depth=2)),
    "depth3": dict(h=64, w=128, par=dict(hierarchy_depth=3)),
    "depth4_sparse_tuned": dict(h=64, w=128, par=dict(
        hierarchy_depth=4, exhaustive=False, strength=2.0,
        rejection_falloff=5.0, blur_tolerance=-3.0)),
    "batch_2x64x128": dict(h=64, w=128, batch=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_render_frame_matches_tpuao(case):
    c = CASES[case]
    z, cam, jcam, _ = scene(c["h"], c["w"], hardware=c.get("hardware", False),
                            batch=c.get("batch"))
    par = c.get("par", {})
    got = {impl: render_frame(z, cam, AOParams(**par), impl=impl,
                              device="cpu").numpy()
           for impl in TPL.IMPLS}
    want_jnp = np.asarray(JPL.render_frame(z, jcam, JAOParams(**par),
                                           impl="jnp"))
    want_fused = np.asarray(JPL.render_frame(z, jcam, JAOParams(**par),
                                             impl="fused"))
    assert got["auto"].shape == z.shape and got["auto"].dtype == np.float32
    for impl in TPL.IMPLS:  # on CPU every impl is the plain path
        np.testing.assert_array_equal(got[impl], got["jnp"])
    np.testing.assert_allclose(got["auto"], want_jnp, atol=TOL)
    np.testing.assert_allclose(got["auto"], want_fused, atol=TOL)


@pytest.mark.parametrize("hardware", [False, True])
def test_render_frame_matches_golden(hardware):
    h, w = (128, 192) if not hardware else (100, 150)
    z, cam, _, gcam = scene(h, w, seed=11, hardware=hardware)
    got = render_frame(z, cam, AOParams(), device="cpu").numpy()
    gold = render_frame_golden(z, gcam, GoldenAOParams())
    np.testing.assert_allclose(got, gold, atol=GTOL)
    assert got.min() < 0.95  # the scene really occludes


def test_blur_off_matches_tpuao_and_golden():
    z, cam, jcam, gcam = scene(100, 150)
    got = render_frame(z, cam, AOParams(enable_blur=False),
                       device="cpu").numpy()
    want = np.asarray(JPL.render_frame(z, jcam, JAOParams(enable_blur=False),
                                       impl="jnp"))
    np.testing.assert_allclose(got, want, atol=TOL)
    gold = render_frame_golden(z, gcam, GoldenAOParams(enable_blur=False))
    np.testing.assert_allclose(got, gold, atol=GTOL)


def test_out_dtype_uint8_matches_tpuao():
    z, cam, jcam, _ = scene(64, 128, batch=2)
    got = render_frame(z, cam, AOParams(), out_dtype="uint8",
                       device="cpu").numpy()
    want = np.asarray(JPL.render_frame(z, jcam, JAOParams(), impl="jnp",
                                       out_dtype="uint8"))
    assert got.dtype == np.uint8
    # float32 noise (<1e-5) can move a value across a rounding boundary
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got == want).mean() > 0.999


def test_out_dtype_bfloat16_matches_tpuao():
    z, cam, jcam, _ = scene(64, 128)
    got = render_frame(z, cam, AOParams(), out_dtype="bfloat16", device="cpu")
    assert got.dtype == torch.bfloat16
    want = np.asarray(JPL.render_frame(z, jcam, JAOParams(), impl="jnp",
                                       out_dtype="bfloat16")).astype(
                                           np.float32)
    # one bfloat16 step in [0.5, 1) is 2**-8; float32 noise can flip it
    np.testing.assert_allclose(got.float().numpy(), want, atol=2.0 ** -8)
    with pytest.raises(ValueError, match="out_dtype"):
        render_frame(z, cam, AOParams(), out_dtype="float16", device="cpu")


@pytest.mark.parametrize("kind", ["float32", "uint8"])
def test_colour_composite_matches_tpuao(kind):
    z, cam, jcam, _ = scene(64, 128)
    rng = np.random.default_rng(12)
    if kind == "uint8":
        color = rng.integers(0, 256, (64, 128, 3), dtype=np.uint8)
    else:
        color = rng.uniform(size=(64, 128, 3)).astype(np.float32)
    for out_dtype in ("float32", "uint8"):
        got = render_frame(z, cam, AOParams(), color=color,
                           out_dtype=out_dtype, device="cpu").numpy()
        want = np.asarray(JPL.render_frame(z, jcam, JAOParams(), color=color,
                                           impl="jnp", out_dtype=out_dtype))
        assert got.dtype == want.dtype and got.shape == want.shape
        if got.dtype == np.float32:
            np.testing.assert_allclose(got, want, atol=TOL)
        else:  # integer codes: a rounding boundary may move by one
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("hw", [(100, 150), (128, 192)])
def test_single_scale_ao_matches_tpuao(hw):
    z, cam, jcam, _ = scene(*hw, hardware=True)
    got = TPL.single_scale_ao(z, cam, AOParams(strength=1.5),
                              device="cpu").numpy()
    want = np.asarray(JPL.single_scale_ao(z, jcam, JAOParams(strength=1.5),
                                          impl="pallas"))
    assert got.shape == (-(-hw[0] // 2), -(-hw[1] // 2))
    np.testing.assert_allclose(got, want, atol=TOL)


def test_flat_plane_gives_one():
    out = render_frame(np.full((64, 128), 0.3, np.float32),
                       CameraParams(depth_mode="linear"), AOParams(),
                       device="cpu")
    np.testing.assert_allclose(out.numpy(), 1.0, atol=1e-6)


def test_debug_outputs():
    """Under impl="auto" the debug dict holds every level, as tpuao's
    "auto" (its jnp path) returns them, with the same values."""
    z, cam, jcam, _ = scene(64, 128)
    out, dbg = render_frame(z, cam, AOParams(), debug_outputs=True,
                            device="cpu")
    _, jdbg = JPL.render_frame(z, jcam, JAOParams(), debug_outputs=True,
                               impl="auto")
    assert set(dbg) >= {"linear_z", "ao_levels", "pyramid", "combined_0"}
    assert sorted(dbg["ao_levels"]) == sorted(jdbg["ao_levels"]) == [1, 2,
                                                                      3, 4]
    for l, ao in dbg["ao_levels"].items():
        np.testing.assert_allclose(ao.numpy(), np.asarray(jdbg["ao_levels"][l]),
                                   atol=TOL)
    np.testing.assert_array_equal(dbg["combined_0"].numpy(), out.numpy())
    _, dbg = render_frame(z, cam, AOParams(), debug_outputs=True, impl="jnp",
                          device="cpu")
    assert sorted(dbg["ao_levels"]) == [1, 2, 3, 4]


def _leaves(tree, prefix=""):
    """A debug dict's leaves by '/'-joined key."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("impl", TPL.IMPLS)
@pytest.mark.parametrize("hw", [(100, 150), (135, 240)])
def test_debug_dict_matches_tpuao_at_padded_sizes(hw, impl):
    """At sizes that pad (135 x 240 is 1080p / 8), the debug dict has
    tpuao's keys and leaf shapes under every impl -- ``combined_0`` is the
    padded buffer under "pallas" and "fused", the cropped frame under
    "auto" and "jnp" -- with values within 1e-5, and the frame equals the
    call without the dict bit for bit."""
    z, cam, jcam, _ = scene(*hw)
    out, dbg = render_frame(z, cam, AOParams(), debug_outputs=True,
                            impl=impl, device="cpu")
    _, jdbg = JPL.render_frame(z, jcam, JAOParams(), debug_outputs=True,
                               impl=impl)
    got, want = _leaves(dbg), _leaves(jdbg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k], v, atol=TOL, err_msg=k)
    padded = impl in ("pallas", "fused")
    assert got["combined_0"].shape == (
        tuple(-(-s // 64) * 64 for s in hw) if padded else hw)
    np.testing.assert_array_equal(
        out.numpy(), render_frame(z, cam, AOParams(), impl=impl,
                                  device="cpu").numpy())
    np.testing.assert_array_equal(got["combined_0"][:hw[0], :hw[1]],
                                  out.numpy())


def test_debug_outputs_fused_hold_the_coarsest_level(monkeypatch):
    """impl="fused" renders levels 1..d-1 inside the fused chain and
    returns level d alone, as tpuao's "fused" does; and "auto" renders the
    extra levels only when the debug dict is asked for."""
    z, cam, jcam, _ = scene(64, 128)
    out, dbg = render_frame(z, cam, AOParams(), debug_outputs=True,
                            impl="fused", device="cpu")
    jout, jdbg = JPL.render_frame(z, jcam, JAOParams(), debug_outputs=True,
                                  impl="fused")
    assert list(dbg["ao_levels"]) == list(jdbg["ao_levels"]) == [4]
    np.testing.assert_allclose(dbg["ao_levels"][4].numpy(),
                               np.asarray(jdbg["ao_levels"][4]), atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL)
    calls = []
    real = K.render_ao_level
    monkeypatch.setattr(K, "render_ao_level",
                        lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    render_frame(z, cam, AOParams(), device="cpu")
    assert calls == [4]
    calls.clear()
    render_frame(z, cam, AOParams(), debug_outputs=True, device="cpu")
    assert sorted(calls) == [1, 2, 3, 4]


def test_debug_outputs_without_blur_hold_every_level(monkeypatch):
    z, cam, jcam, _ = scene(64, 128)
    par = dict(enable_blur=False)
    out, dbg = render_frame(z, cam, AOParams(**par), debug_outputs=True,
                            device="cpu")
    jout, jdbg = JPL.render_frame(z, jcam, JAOParams(**par),
                                  debug_outputs=True, impl="jnp")
    assert sorted(dbg["ao_levels"]) == sorted(jdbg["ao_levels"]) == [1, 2,
                                                                      3, 4]
    for l, ao in dbg["ao_levels"].items():
        np.testing.assert_allclose(ao.numpy(), np.asarray(jdbg["ao_levels"][l]),
                                   atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL)
    # without debug_outputs only level 1, which the frame uses, renders
    calls = []
    real = K.render_ao_level
    monkeypatch.setattr(K, "render_ao_level",
                        lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    np.testing.assert_array_equal(
        render_frame(z, cam, AOParams(**par),
                     device="cpu").numpy(), out.numpy())
    assert calls == [1]


def test_bad_impl_raises_and_normals_render():
    z, cam, _, _ = scene(64, 64)
    with pytest.raises(ValueError, match="impl"):
        render_frame(z, cam, AOParams(), impl="xla", device="cpu")
    n = np.zeros((64, 64, 3), np.float32)
    n[..., 2] = 1.0  # a camera-facing wall: no tangent offset
    np.testing.assert_allclose(
        render_frame(z, cam, AOParams(use_normals=True), normals=n,
                     device="cpu").numpy(),
        render_frame(z, cam, AOParams(), device="cpu").numpy(), atol=1e-7)


def test_tensor_input_stays_on_its_device():
    z, cam, _, _ = scene(64, 64)
    t = torch.as_tensor(z)
    out = render_frame(t, cam, AOParams(), device=torch.device("meta"))
    assert out.device == t.device

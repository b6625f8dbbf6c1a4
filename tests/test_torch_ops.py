"""The port's ops against the JAX package, module by module.

Each module that holds a kernel is held, on the same NumPy-seeded inputs,
against the matching Pallas kernel of ``tpuao.ops.pallas_kernels`` (run in
interpret mode on the CPU, as tests/test_pallas.py runs it) at
``atol=1e-5, rtol=1e-4``, and against the float64 golden spec
``tpuao.golden.reference`` at ``atol=1e-4`` (the [BJ] budget is 1e-3).  On
CPU tensors the kernel wrappers run their plain versions, so these tests
check the plain versions and the wrappers' shape handling; the CUDA
kernels themselves are held against the plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuao.golden import reference as G
from tpuao.ops import composite as JC
from tpuao.ops import pallas_kernels as PK
from tpuao.ops import prepare as JPR
from tpuao.ops import render as JR
from tpuao.ops import upsample as JU
from tpuao.params import (AOParams as JAOParams, CameraParams as JCamera,
                          GoldenAOParams, GoldenCameraParams)
from tpuao.utils import fixtures as JF

from tpuao_torch.ops import _build
from tpuao_torch.ops import composite as C
from tpuao_torch.ops import kernels as K
from tpuao_torch.ops import prepare as P
from tpuao_torch.ops import render as R
from tpuao_torch.ops import upsample as U
from tpuao_torch.params import AOParams, CameraParams, padded_shape

KTOL = dict(atol=1e-5, rtol=1e-4)  # port vs Pallas kernel, both float32
GTOL = dict(atol=1e-4)             # float32 port vs float64 golden


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so these tests do not crowd the
    CPU that the suite's other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def j32(x):
    return jnp.asarray(np.asarray(x, np.float32))


@pytest.fixture(scope="module")
def ds():
    """Level 1 of a 128x192 sphere scene: (64, 96)."""
    z = JF.spheres_on_plane(128, 192, n_spheres=4, seed=3, backend="numpy")
    return G.downsample2x(z).astype(np.float32)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    """CPU tensors never launch a kernel."""
    K.reset_launch_counts()
    yield
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)


def _step_inputs(lh, lw, seed):
    rng = np.random.default_rng(seed)
    lo_d = rng.uniform(0.2, 0.8, (lh, lw))
    hi_d = np.repeat(np.repeat(lo_d, 2, 0), 2, 1)
    hi_d = hi_d + rng.uniform(-0.01, 0.01, hi_d.shape)
    return (rng.uniform(size=(lh, lw)), lo_d, hi_d,
            rng.uniform(size=(lh, lw)), rng.uniform(size=(2 * lh, 2 * lw)))


# ---------------------------------------------------------------------------
# prepare: exact against tpuao.ops.prepare
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cam", [
    dict(depth_mode="linear"),
    dict(depth_mode="hardware", reversed_z=True),
    dict(depth_mode="hardware", reversed_z=False, near=0.3, far=40.0),
])
def test_linearize_depth_exact(cam):
    d = np.random.default_rng(0).uniform(0.0, 1.0, (2, 24, 40))
    got = P.linearize_depth(t32(d), CameraParams(**cam)).numpy()
    want = np.asarray(JPR.linearize_depth(j32(d), JCamera(**cam)))
    np.testing.assert_array_equal(got, want)


def test_build_pyramid_exact():
    z = np.random.default_rng(1).uniform(0.1, 1.0, (3, 128, 192))
    got = P.build_pyramid(t32(z), 4)
    want = JPR.build_pyramid(j32(z), 4)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[1].is_contiguous()  # a strided view, as documented


@pytest.mark.parametrize("hw", [(22, 30), (44, 64), (5, 7)])
@pytest.mark.parametrize("pad", [4, 16])
def test_pad_parity4_exact(hw, pad):
    x = np.random.default_rng(2).uniform(size=(2,) + hw)
    got = P.pad_parity4(t32(x), pad).numpy()
    np.testing.assert_array_equal(got, np.asarray(JPR.pad_parity4(j32(x),
                                                                  pad)))
    np.testing.assert_array_equal(got[0], G.pad_parity4(
        x[0].astype(np.float32), pad))


def test_deinterleave_roundtrip_exact():
    x = np.random.default_rng(3).uniform(size=(2, 16, 24))
    got = P.deinterleave_4x4(t32(x))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JPR.deinterleave_4x4(j32(x))))
    np.testing.assert_array_equal(P.interleave_4x4(got).numpy(),
                                  x.astype(np.float32))
    with pytest.raises(ValueError):
        P.deinterleave_4x4(torch.zeros(6, 8))


# ---------------------------------------------------------------------------
# the prologue (prepare_levels): csrc/prepare.cu's index rule, as gathers,
# against the plain ops, bit for bit
# ---------------------------------------------------------------------------

PROLOGUE_CAMS = {
    "reversed": CameraParams(),
    "forward": CameraParams(reversed_z=False, near=0.3, far=40.0),
    "linear": CameraParams(depth_mode="linear"),
}


def prologue_rule(depth, camera, d, hp, wp, normals_cl=None):
    """The kernel's rule: texel (y, x) of level l is source texel
    (min(y 2^l, h0 - 1), min(x 2^l, w0 - 1)), linearised; with normals
    (channel-last) the slopes of levels 1..d at the same texels, in the
    kernel's arithmetic (n_x, n_y) * float32(2 tanH / wp) / clamp(n_z,
    0.05), NaN passed through the clamp."""
    h0, w0 = depth.shape[-2:]
    ts0 = torch.tensor(np.float32(2.0 * camera.tan_half_fov_h / wp))
    levels, slopes = [], [None]
    for l in range(d + 1):
        ys = torch.clamp(torch.arange(hp >> l) << l, max=h0 - 1)
        xs = torch.clamp(torch.arange(wp >> l) << l, max=w0 - 1)
        levels.append(P.linearize_depth(
            depth.index_select(-2, ys).index_select(-1, xs), camera))
        if normals_cl is not None and l:
            n = normals_cl.index_select(-3, ys).index_select(-2, xs)
            nz = n[..., 2]
            g = ts0 / torch.where(torch.isnan(nz), nz,
                                  torch.clamp(nz, min=0.05))
            slopes.append((n[..., 0] * g, n[..., 1] * g))
    return levels, None if normals_cl is None else slopes


def assert_bits(got, want):
    """Equal values and equal NaN positions (``torch.equal`` with NaN)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def assert_prologue(got, want, d):
    (gl, gs), (wl, ws) = got, want
    assert len(gl) == len(wl) == d + 1
    for g, w in zip(gl, wl):
        assert_bits(g, w)
        assert g.is_contiguous()  # the kernels read raw pointers
    assert (gs is None) == (ws is None)
    if gs is not None:
        assert len(gs) == len(ws) == d + 1 and gs[0] is None
        for (gx, gy), (wx, wy) in zip(gs[1:], ws[1:]):
            assert_bits(gx, wx)
            assert_bits(gy, wy)
            assert gx.is_contiguous() and gy.is_contiguous()


def prologue_inputs(batch, h0, w0, seed):
    """Depth in [0, 1] with exact 0s, 1s and NaNs; unit-ish normals, many
    with n_z <= 0.05, some NaN: channel-last and channel-first."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.0, 1.0, (batch, h0, w0)).astype(np.float32)
    n = rng.uniform(-1.0, 1.0, (batch, h0, w0, 3)).astype(np.float32)
    flat_z, flat_n = z.reshape(-1), n.reshape(-1, 3)
    for v in (0.0, 1.0, np.nan):
        flat_z[rng.integers(0, flat_z.size, 7)] = v
    flat_n[rng.integers(0, len(flat_n), 9), rng.integers(0, 3, 9)] = np.nan
    flat_n[rng.integers(0, len(flat_n), 9), 2] = 0.05
    cl = torch.as_tensor(n)
    return torch.as_tensor(z), cl, cl.movedim(-1, -3).contiguous()


@pytest.mark.parametrize("mode", sorted(PROLOGUE_CAMS))
@pytest.mark.parametrize("hw,batch", [((70, 130), 1), ((70, 130), 8),
                                      ((1000, 1900), 1), ((128, 192), 1),
                                      ((128, 192), 8)])
def test_prologue_rule_equals_plain_ops(hw, batch, mode):
    """Pads on both axes (70x130, 1000x1900) and on neither (128x192),
    depths 1-4, both normals layouts, through the frame program's choice
    of prologue under each impl (the kernel wrapper runs the plain ops on
    the CPU) and the plain version itself."""
    from tpuao_torch.models.pipeline import _select_prepare_impl

    cam = PROLOGUE_CAMS[mode]
    z, ncl, ncf = prologue_inputs(batch, *hw, seed=hw[0] + batch)
    if batch == 1:
        z, ncl, ncf = z[0], ncl[0], ncf[0]
    hp, wp = padded_shape(*hw)
    for d in range(1, 5):
        want = prologue_rule(z, cam, d, hp, wp)
        assert_prologue(P.prepare_levels_plain(z, cam, d, hp, wp), want, d)
        want_n = prologue_rule(z, cam, d, hp, wp, ncl)
        for nrm in (ncl, ncf):
            for impl in ("auto", "jnp"):
                assert_prologue(_select_prepare_impl(impl)(
                    z, cam, d, hp, wp, nrm), want_n, d)


def test_prologue_refuses_padded_dims_it_cannot_pick():
    z = torch.zeros(70, 130)
    cam = CameraParams()
    K.prepare_levels(z, cam, 4, 80, 144)  # multiples of 16
    for hp, wp, d in ((64, 192, 1), (128, 129, 0), (72, 192, 4),
                      (128, 136, 4), (128, 192, 7)):
        with pytest.raises(ValueError, match="prepare_levels"):
            K.prepare_levels(z, cam, d, hp, wp)


def _old_prologue(depth, camera, d, hp, wp, normals=None):
    """The prologue as the frame program, ``single_scale_ao`` and the
    stage profiler each wrote it before ``prepare_levels``."""
    h0, w0 = depth.shape[-2:]
    x = depth.to(torch.float32)
    if (hp, wp) != (h0, w0):
        x = U._edge_pad(x, 0, hp - h0, 0, wp - w0)
    pyr = [lvl.contiguous() for lvl in
           P.build_pyramid(P.linearize_depth(x, camera), d)]
    if normals is None:
        return pyr, None
    return pyr, R.slope_pyramid(normals.to(torch.float32),
                                camera.tan_half_fov_h, hp, wp, d, h0=h0,
                                w0=w0)


def _checksum(x) -> float:
    if isinstance(x, torch.Tensor):
        return float(x.double().sum())
    if isinstance(x, (list, tuple)):
        return sum(_checksum(v) for v in x if v is not None)
    return 0.0


@pytest.mark.parametrize("impl", ["auto", "jnp", "pallas", "fused"])
@pytest.mark.parametrize("ultra", [False, True])
def test_prologue_callers_unchanged(monkeypatch, impl, ultra):
    """``ao_pipeline``, ``single_scale_ao`` and ``stage_times_ms`` give
    the same bits with the prologue functions as with the sequence they
    replaced (the stage profiler's ``prepare`` now holds the slope levels
    too, so with normals it is left out)."""
    from tpuao_torch.models.pipeline import ao_pipeline, single_scale_ao
    from tpuao_torch.models.presets import preset
    from tpuao_torch.utils.profiling import stage_times_ms

    cam = CameraParams()
    par = preset("ULTRA" if ultra else "HIGH")
    z, ncl, _ = prologue_inputs(2, 70, 130, seed=5)
    z = torch.nan_to_num(z, nan=0.5).clamp(0.05, 0.999)
    nrm = torch.nan_to_num(ncl, nan=0.0) if ultra else None

    def run():
        ao, dbg = ao_pipeline(z, cam, par, nrm, impl=impl, all_levels=True)
        single = single_scale_ao(z, cam, par, impl=impl)
        stages = stage_times_ms(z, cam, par, nrm, impl=impl,
                                timer=lambda call: _checksum(call()))
        if ultra:
            del stages["prepare"]
        return ao, dbg, single, stages

    new = run()
    monkeypatch.setattr(P, "prepare_levels_plain", _old_prologue)
    monkeypatch.setattr(K, "prepare_levels", _old_prologue)
    old = run()
    assert_bits(new[0], old[0])
    assert_bits(new[2], old[2])
    assert new[3] == old[3]
    assert new[1].keys() == old[1].keys()
    for key in new[1]:
        a, b = new[1][key], old[1][key]
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                assert_bits(a[k], b[k])
        else:
            assert_bits(a, b)


@pytest.mark.parametrize("entry", sorted(_build.SIGNATURES))
def test_ctypes_signatures_match_the_sources(entry):
    """Each entry point's ``argtypes`` follow its C parameter list in
    ``csrc/*.cu`` (no compiler here reads them): a pointer is c_void_p,
    ``long long`` c_longlong, ``int`` c_int, ``float`` c_float."""
    src = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    found = re.findall(r"\bint\s+" + entry + r"\s*\(([^)]*)\)", src)
    assert len(found) == 1, found
    kinds = {"long long": ctypes.c_longlong, "int": ctypes.c_int,
             "float": ctypes.c_float}
    got = []
    for p in (re.sub(r"\s+", " ", p.strip()) for p in found[0].split(",")):
        got.append(ctypes.c_void_p if "*" in p else next(
            t for k, t in kinds.items() if p.startswith(k + " ")))
    assert got == list(_build.SIGNATURES[entry])


# ---------------------------------------------------------------------------
# render: plain version against the Pallas kernel and the golden
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exhaustive", [True, False])
def test_render_matches_pallas_and_golden(ds, exhaustive):
    got = K.render_ao_level(t32(ds), 1, 192, CameraParams(),
                            AOParams(exhaustive=exhaustive)).numpy()
    pk = np.asarray(PK.render_ao_level(j32(ds), 1, 192, JCamera(),
                                       JAOParams(exhaustive=exhaustive)))
    np.testing.assert_allclose(got, pk, **KTOL)
    gold = G.render_ao_level(ds, 1, 192, GoldenCameraParams(),
                             GoldenAOParams(exhaustive=exhaustive))
    np.testing.assert_allclose(got, gold, **GTOL)
    jn = np.asarray(JR.render_ao_level(j32(ds), 1, 192, JCamera(),
                                       JAOParams(exhaustive=exhaustive)))
    np.testing.assert_allclose(got, jn, atol=1e-6)


def test_render_matches_pallas_uneven_row_tile(ds):
    # 64 rows on a 24-row Pallas tile: its pad + crop path
    got = K.render_ao_level(t32(ds), 1, 192, CameraParams(),
                            AOParams()).numpy()
    pk = np.asarray(PK.render_ao_level(j32(ds), 1, 192, JCamera(),
                                       JAOParams(), row_tile=24))
    np.testing.assert_allclose(got, pk, **KTOL)


def test_render_44_rows_against_golden():
    z = np.random.default_rng(4).uniform(0.2, 0.8, (44, 64))
    tun = dict(strength=2.5, rejection_falloff=6.0)
    got = K.render_ao_level(t32(z), 2, 256, CameraParams(tan_half_fov_h=0.9),
                            AOParams(**tun)).numpy()
    gold = G.render_ao_level(z.astype(np.float32), 2, 256,
                             GoldenCameraParams(tan_half_fov_h=0.9),
                             GoldenAOParams(**tun))
    np.testing.assert_allclose(got, gold, **GTOL)


def test_render_batch_equals_per_frame(ds):
    b = np.stack([ds, ds[::-1].copy()])
    got = K.render_ao_level(t32(b), 1, 192, CameraParams(), AOParams())
    for i in range(2):
        one = K.render_ao_level(t32(b[i]), 1, 192, CameraParams(), AOParams())
        np.testing.assert_array_equal(got[i].numpy(), one.numpy())


def test_fully_occluded_pixel_small_strength():
    """vis == 0 with strength 0.1 gives exactly 0 (the log floor alone
    would give 1e-30**0.1 ~ 1e-3, over the budget)."""
    h, w = 32, 64
    z = np.full((h, w), 0.2, np.float32)
    z[h // 2, w // 2] = 0.95  # all taps far in front -> vis == 0
    cam = CameraParams(depth_mode="linear")
    got = K.render_ao_level(t32(z), 1, 2 * w, cam,
                            AOParams(strength=0.1)).numpy()
    pk = np.asarray(PK.render_ao_level(
        j32(z), 1, 2 * w, JCamera(depth_mode="linear"),
        JAOParams(strength=0.1)))
    assert got[h // 2, w // 2] == 0.0
    assert pk[h // 2, w // 2] == 0.0
    np.testing.assert_allclose(got, pk, atol=1e-6)


# ---------------------------------------------------------------------------
# upsample: plain version against the Pallas kernel and the golden
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use2", [False, True])
@pytest.mark.parametrize("blend", [False, True])
def test_upsample_matches_pallas_and_golden(use2, blend):
    lo1, lo_d, hi_d, lo2, hi_ao = _step_inputs(32, 48, 5)
    got = K.blur_upsample_step(
        t32(lo1), t32(lo_d), t32(hi_d), AOParams(), 192,
        lo_ao2=t32(lo2) if use2 else None,
        hi_ao_blend=t32(hi_ao) if blend else None).numpy()
    pk = np.asarray(PK.blur_upsample_step(
        j32(lo1), j32(lo_d), j32(hi_d), JAOParams(), 192,
        lo_ao2=j32(lo2) if use2 else None,
        hi_ao_blend=j32(hi_ao) if blend else None, row_tile=16))
    np.testing.assert_allclose(got, pk, **KTOL)
    gold = G.blur_upsample_step(
        lo1, lo_d, hi_d, GoldenAOParams(), 192,
        lo_ao2=lo2 if use2 else None,
        hi_ao_blend=hi_ao.astype(np.float32) if blend else None)
    np.testing.assert_allclose(got, gold, **GTOL)


@pytest.mark.parametrize("crop", [(40, 60), (45, 77), (64, 95), (1, 1)])
def test_upsample_crop_matches_pallas(crop):
    lo1, lo_d, hi_d, lo2, hi_ao = _step_inputs(32, 48, 6)
    got = K.blur_upsample_step(t32(lo1), t32(lo_d), t32(hi_d), AOParams(),
                               192, lo_ao2=t32(lo2), hi_ao_blend=t32(hi_ao),
                               crop_hw=crop)
    assert tuple(got.shape) == crop
    pk = np.asarray(PK.blur_upsample_step(
        j32(lo1), j32(lo_d), j32(hi_d), JAOParams(), 192, lo_ao2=j32(lo2),
        hi_ao_blend=j32(hi_ao)))
    np.testing.assert_allclose(got.numpy(), pk[: crop[0], : crop[1]], **KTOL)
    jn = np.asarray(JU.blur_upsample_step(
        j32(lo1), j32(lo_d), j32(hi_d), JAOParams(), 192, lo_ao2=j32(lo2),
        hi_ao_blend=j32(hi_ao), crop_hw=crop))
    np.testing.assert_allclose(got.numpy(), jn, atol=1e-6)


def test_noise_filter_and_bilateral_match_jax():
    lo1, lo_d, hi_d, _, _ = _step_inputs(16, 24, 7)
    got = U.noise_filter(t32(lo1), t32(lo_d), 50.0).numpy()
    want = np.asarray(JU.noise_filter(j32(lo1), j32(lo_d), 50.0))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, G.noise_filter(lo1, lo_d, 50.0), **GTOL)
    got = U.bilateral_upsample2x(t32(lo1), t32(lo_d), t32(hi_d), 0.9,
                                 1e-7).numpy()
    want = np.asarray(JU.bilateral_upsample2x(j32(lo1), j32(lo_d), j32(hi_d),
                                              0.9, 1e-7))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(
        got, G.bilateral_upsample2x(lo1, lo_d, hi_d, 0.9, 1e-7), **GTOL)


# The CUDA chain stages (csrc/chain_step.cuh) form each weight g / x, g a
# power of two (the filter's [1,2,1]^2 taps, the 2x's wr*wc), as
# g * (1/x) with a correctly rounded reciprocal, and take the filter's
# centre weight as 4 without a division.  These emulate that form in
# float32 and hold it bit for bit against the plain stages and against
# one correctly rounded division.  (PyTorch's own ``float / tensor`` is
# ``tensor.reciprocal() * float``, so the plain stages are that form too.)

def _stage_weight(g, x):
    return g * torch.reciprocal(x)


def _div_weight(g, x):
    return torch.full_like(x, g) / x


def _noise_filter_with(lo_ao, lo_d, nfs, weight, divide_centre):
    acc = torch.zeros_like(lo_ao)
    wacc = torch.zeros_like(lo_ao)
    for dy, dx, g in U._NOISE_TAPS:
        dd = U._shift2d(lo_d, dy, dx) - lo_d
        if dy == dx == 0 and not divide_centre:
            wt = torch.full_like(dd, g)
        else:
            wt = weight(g, 1.0 + nfs * dd * dd)
        acc = acc + wt * U._shift2d(lo_ao, dy, dx)
        wacc = wacc + wt
    return acc / wacc


def _bilateral_planes_with(taps, hi_d, k_blur, k_up, weight):
    planes = []
    for p in (0, 1):
        for q in (0, 1):
            hd = hi_d[..., p::2, q::2]
            acc = torch.zeros_like(hd)
            wacc = torch.zeros_like(hd)
            for dr in range(p + 1):
                for dc in range(q + 1):
                    a, d = taps[(dr, dc)]
                    dd = d - hd
                    wt = weight(0.5 ** (p + q), dd * dd / k_blur + k_up)
                    acc = acc + wt * a
                    wacc = wacc + wt
            planes.append(acc / torch.clamp(wacc, min=1e-30))
    return planes


@pytest.mark.parametrize("nfs,k_blur,k_up", [
    (50.0, 0.9, 1e-7), (1e4, 1e-30, 1e-12), (0.5, 3.0, 0.7)])
def test_chain_stage_weights_equal_the_plain_division(nfs, k_blur, k_up):
    lo1, lo_d, hi_d, _, _ = _step_inputs(16, 24, 9)
    a, d = (U._edge_pad(t32(x), 0, 1, 0, 1) for x in (lo1, lo_d))
    f = _noise_filter_with(a, d, nfs, _stage_weight, divide_centre=False)
    assert torch.equal(f, U.noise_filter(a, d, nfs))
    assert torch.equal(f, _noise_filter_with(a, d, nfs, _div_weight,
                                             divide_centre=True))
    lh, lw = lo_d.shape
    taps = {(dr, dc): (f[dr: dr + lh, dc: dc + lw], d[dr: dr + lh, dc: dc + lw])
            for dr in (0, 1) for dc in (0, 1)}
    got = _bilateral_planes_with(taps, t32(hi_d), k_blur, k_up, _stage_weight)
    for want in (U._bilateral_planes(taps, t32(hi_d), k_blur, k_up),
                 _bilateral_planes_with(taps, t32(hi_d), k_blur, k_up,
                                        _div_weight)):
        for g, w in zip(got, want):
            assert torch.isfinite(g).all() and torch.equal(g, w)


def test_upsample_k_blur_floor_gives_finite_frame():
    """blur_tolerance = log10(1/step_size) makes k_blur exactly 0 but for
    its 1e-30 floor; dd == 0 taps must not give 0/0."""
    lo = np.full((8, 8), 0.5)
    p = AOParams(blur_tolerance=-float(np.log10(16.0)))
    out = K.blur_upsample_step(t32(lo), t32(lo), t32(np.full((16, 16), 0.5)),
                               p, 128)
    assert torch.isfinite(out).all()


def test_upsample_rejects_bad_inputs():
    lo1, lo_d, hi_d, _, _ = _step_inputs(8, 8, 8)
    with pytest.raises(ValueError, match="hi_d"):
        K.blur_upsample_step(t32(lo1), t32(lo_d), t32(hi_d[:-2]), AOParams(),
                             64)
    with pytest.raises(ValueError, match="crop_hw"):
        K.blur_upsample_step(t32(lo1), t32(lo_d), t32(hi_d), AOParams(), 64,
                             crop_hw=(17, 4))
    with pytest.raises(TypeError, match="float32"):
        K.blur_upsample_step(torch.as_tensor(lo1), t32(lo_d), t32(hi_d),
                             AOParams(), 64)


# ---------------------------------------------------------------------------
# fused: plain version against the Pallas kernel and the golden composition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lh,lw,row_tile", [(44, 64, 16), (96, 64, 64)])
def test_fused_matches_pallas_and_golden(lh, lw, row_tile):
    rng = np.random.default_rng(lh)
    ds_ = rng.uniform(0.2, 0.8, (lh, lw))
    hi = rng.uniform(0.2, 0.8, (2 * lh, 2 * lw))
    c1 = rng.uniform(0.3, 1.0, (lh, lw))
    got = K.fused_render_upsample_step(t32(ds_), t32(c1), t32(hi), 1, 2 * lw,
                                       CameraParams(), AOParams()).numpy()
    pk = np.asarray(PK.fused_render_upsample_step(
        j32(ds_), j32(c1), j32(hi), 1, 2 * lw, JCamera(), JAOParams(),
        row_tile=row_tile))
    np.testing.assert_allclose(got, pk, **KTOL)
    ao = G.render_ao_level(ds_.astype(np.float32), 1, 2 * lw,
                           GoldenCameraParams(), GoldenAOParams())
    gold = G.blur_upsample_step(c1.astype(np.float32), ds_.astype(np.float32),
                                hi.astype(np.float32), GoldenAOParams(),
                                2 * lw, lo_ao2=ao)
    np.testing.assert_allclose(got, gold, **GTOL)


def test_fused_crop_and_batch():
    rng = np.random.default_rng(9)
    ds_ = rng.uniform(0.2, 0.8, (2, 20, 24))
    hi = rng.uniform(0.2, 0.8, (2, 40, 48))
    c1 = rng.uniform(0.3, 1.0, (2, 20, 24))
    full = K.fused_render_upsample_step(t32(ds_), t32(c1), t32(hi), 2, 96,
                                        CameraParams(), AOParams())
    crop = K.fused_render_upsample_step(t32(ds_), t32(c1), t32(hi), 2, 96,
                                        CameraParams(), AOParams(),
                                        crop_hw=(39, 45))
    np.testing.assert_array_equal(crop.numpy(), full[:, :39, :45].numpy())
    one = K.fused_render_upsample_step(t32(ds_[1]), t32(c1[1]), t32(hi[1]),
                                       2, 96, CameraParams(), AOParams())
    np.testing.assert_array_equal(full[1].numpy(), one.numpy())


# ---------------------------------------------------------------------------
# composite
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [None, 3])
def test_composite_matches_jax(dtype, channels):
    rng = np.random.default_rng(10)
    shape = (12, 20) if channels is None else (12, 20, channels)
    if np.issubdtype(dtype, np.integer):
        color = rng.integers(0, np.iinfo(dtype).max, shape).astype(dtype)
    else:
        color = rng.uniform(size=shape).astype(dtype)
    ao = rng.uniform(size=(12, 20)).astype(np.float32)
    got = C.composite(torch.as_tensor(color), torch.as_tensor(ao)).numpy()
    want = np.asarray(JC.composite(jnp.asarray(color), jnp.asarray(ao)))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_debug_view_matches_jax():
    ao = np.random.default_rng(11).uniform(size=(6, 9)).astype(np.float32)
    got = C.debug_view(torch.as_tensor(ao), 4).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JC.debug_view(jnp.asarray(ao), 4)))

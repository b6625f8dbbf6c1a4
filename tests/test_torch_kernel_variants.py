"""The port's two kernel variants against tpuao's, on the CPU.

``render_ao_level_dma`` and ``fused_render_upsample_step_zc`` run their
plain versions on CPU tensors (the CUDA kernels are held against those on
the card in tests/test_torch_kernels_cuda.py); here they are held against
the JAX package's Pallas kernels of the same names, run in interpret mode
as tests/test_pallas.py runs them, and against the float64 golden.
Inputs are made with numpy from a seed.

Tolerances: 1e-5 against tpuao (float32 against float32, the same pair
test in another order of operations); 1e-4 against the float64 golden,
as tests/test_torch_ops.py holds the render.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpuao.golden import reference as G
from tpuao.ops import pallas_kernels as PK
from tpuao.ops import render as JR
from tpuao.ops import upsample as JU
from tpuao.params import (AOParams as JAOParams,
                          CameraParams as JCameraParams, GoldenAOParams,
                          GoldenCameraParams)
from tpuao.utils import fixtures as JF

from tpuao_torch.ops import kernels as K
from tpuao_torch.params import AOParams, CameraParams

TOL = 1e-5  # port (float32) vs tpuao (float32)
TOL_GOLDEN = 1e-4  # port (float32) vs the float64 golden


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def level():
    """Level 1 of a 128x192 sphere scene: (64, 96) float64."""
    return G.downsample2x(JF.spheres_on_plane(128, 192, n_spheres=4, seed=3,
                                              backend="numpy"))


def t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("row_tile", [24, 128, 16])
@pytest.mark.parametrize("exhaustive", [True, False])
def test_render_dma_matches_tpuao_and_golden(level, row_tile, exhaustive):
    # 64 rows at row_tile 24: rows not a tile multiple (JAX pads and crops)
    got = K.render_ao_level_dma(t32(level), 1, 192, CameraParams(),
                                AOParams(exhaustive=exhaustive),
                                row_tile=row_tile).numpy()
    want = np.asarray(PK.render_ao_level_dma(
        jnp.asarray(level, jnp.float32), 1, 192, JCameraParams(),
        JAOParams(exhaustive=exhaustive), row_tile=row_tile))
    np.testing.assert_allclose(got, want, atol=TOL)
    golden = G.render_ao_level(level, 1, 192, GoldenCameraParams(),
                               GoldenAOParams(exhaustive=exhaustive))
    np.testing.assert_allclose(got, golden, atol=TOL_GOLDEN)


def test_render_dma_row_tile_invariant_and_batched(level):
    """row_tile does not change the result; a leading batch is the
    per-frame result stacked (the JAX kernel takes one frame)."""
    other = np.roll(level, 17, axis=1)
    batch = t32(np.stack([level, other]))
    ref = K.render_ao_level_dma(batch, 1, 192, CameraParams(), AOParams())
    for rt in (1, 7, 64, 1000):
        np.testing.assert_array_equal(
            K.render_ao_level_dma(batch, 1, 192, CameraParams(), AOParams(),
                                  row_tile=rt).numpy(), ref.numpy())
    for i, frame in enumerate((level, other)):
        want = np.asarray(PK.render_ao_level_dma(
            jnp.asarray(frame, jnp.float32), 1, 192, JCameraParams(),
            JAOParams()))
        np.testing.assert_allclose(ref[i].numpy(), want, atol=TOL)
    with pytest.raises(ValueError, match="row_tile"):
        K.render_ao_level_dma(batch, 1, 192, CameraParams(), AOParams(),
                              row_tile=0)


SMS = 132  # H100 SXM
WAVE = 3 * SMS  # blocks resident at once: three an SM


def dma_cost(h, w, seg, batch=1):
    """(blocks, rows the busiest SM renders) of a segment of seg rows."""
    blocks = -(-w // 64) * -(-h // seg) * batch
    return blocks, -(-blocks // SMS) * (seg + 2)


@pytest.mark.parametrize("h,w,seg,blocks,waves", [
    (544, 960, 32, 255, 1),       # 1080p level 1: two blocks on most SMs
    (1088, 1920, 64, 510, 2),     # 4K: 128-row segments were 270 blocks
    (2176, 3840, 128, 1020, 3)])  # 8K
def test_dma_rows_at_the_level1_shapes(h, w, seg, blocks, waves):
    """The DMA render's segment at the level-1 shapes of 1080p, 4K and 8K
    (the default row_tile): four texels a thread, its grid's blocks and
    waves of 396, and no segment within row_tile leaves the busiest SM
    fewer rows."""
    assert K.dma_rows(128, 1, h, w) == seg and K.dma_nt(seg) == 4
    assert dma_cost(h, w, seg)[0] == blocks
    assert -(-blocks // WAVE) == waves
    best = dma_cost(h, w, seg)[1]
    for other in range(8, 129, 8):
        assert dma_cost(h, w, other)[1] >= best
        if other > seg:
            assert dma_cost(h, w, other)[1] > best  # ties go to the larger


@pytest.mark.parametrize("row_tile", [1, 7, 8, 16, 37, 128, 4096])
def test_dma_rows_only_bounded_by_row_tile(row_tile):
    """row_tile bounds the segment and nothing else decides it but the
    grid; a segment's texels a thread step through it exactly."""
    for batch, h, w in ((1, 544, 960), (1, 1088, 1920), (4, 544, 960),
                        (3, 44, 100), (1, 4, 4), (2, 130, 130)):
        seg = K.dma_rows(row_tile, batch, h, w)
        assert 1 <= seg <= min(row_tile, K.DMA_MAX_ROWS)
        if row_tile < 8:
            assert seg == row_tile
        else:
            assert seg % 8 == 0 and seg < h + 8
            assert seg % (8 * K.dma_nt(seg)) == 0
    assert K.dma_rows(4096, 1, 1088, 1920) == K.dma_rows(128, 1, 1088, 1920)
    # 4 x 10 x 3 = 120 blocks at the cap: one each on 120 SMs
    assert K.dma_rows(4096, 3, 640, 640) == K.DMA_MAX_ROWS == 160
    assert [K.dma_nt(s) for s in (1, 8, 16, 24, 32, 48, 88, 96, 128)] == \
        [1, 1, 2, 1, 4, 2, 1, 4, 4]
    with pytest.raises(ValueError, match="row_tile"):
        K.dma_rows(0, 1, 64, 64)


def zc_inputs(lh, lw, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.2, 0.8, (lh, lw)),
            rng.uniform(0.3, 1.0, (lh, lw)),
            rng.uniform(0.2, 0.8, (2 * lh, 2 * lw)))


def jax_zc(ds, c1, hi, lw, params, row_tile):
    return np.asarray(PK.fused_render_upsample_step_zc(
        jnp.asarray(ds, jnp.float32), jnp.asarray(c1, jnp.float32),
        jnp.asarray(hi, jnp.float32), 1, 2 * lw, JCameraParams(), params,
        row_tile=row_tile))


def jax_composition(ds, c1, hi, lw, params):
    """tpuao's jnp composition the zero-copy kernel equals."""
    d, c, h = (jnp.asarray(a, jnp.float32) for a in (ds, c1, hi))
    ao = JR.render_ao_level(d, 1, 2 * lw, JCameraParams(), params)
    return np.asarray(JU.blur_upsample_step(c, d, h, params, 2 * lw,
                                            lo_ao2=ao))


# (lh, lw, row_tile): R = max(min(row_tile, lh), 40)
ZC_CASES = [(44, 64, 16),   # R clamped up to 40; 44 rows: an uneven tile
            (96, 64, 48)]   # the JAX package's own zero-copy test shape


@pytest.mark.parametrize("lh,lw,row_tile", ZC_CASES)
def test_fused_zc_matches_tpuao_composition(lh, lw, row_tile):
    ds, c1, hi = zc_inputs(lh, lw, 11)
    for exhaustive in (True, False):
        got = K.fused_render_upsample_step_zc(
            t32(ds), t32(c1), t32(hi), 1, 2 * lw, CameraParams(),
            AOParams(exhaustive=exhaustive), row_tile=row_tile).numpy()
        want = jax_composition(ds, c1, hi, lw, JAOParams(
            exhaustive=exhaustive))
        np.testing.assert_allclose(got, want, atol=TOL)
        golden = G.blur_upsample_step(
            c1, ds, hi, GoldenAOParams(exhaustive=exhaustive), 2 * lw,
            lo_ao2=G.render_ao_level(ds, 1, 2 * lw, GoldenCameraParams(),
                                     GoldenAOParams(exhaustive=exhaustive)))
        np.testing.assert_allclose(got, golden, atol=TOL_GOLDEN)


def test_fused_zc_matches_tpuao_sparse_kernel():
    """Against the Pallas zero-copy kernel itself (interpret mode), with
    the 10-pair table: R clamped to 40 over 44 rows."""
    ds, c1, hi = zc_inputs(44, 64, 12)
    par = AOParams(exhaustive=False)
    got = K.fused_render_upsample_step_zc(t32(ds), t32(c1), t32(hi), 1, 128,
                                          CameraParams(), par, row_tile=16)
    want = jax_zc(ds, c1, hi, 64, JAOParams(exhaustive=False), 16)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("lh,lw,row_tile", ZC_CASES)
def test_fused_zc_matches_tpuao_kernel(lh, lw, row_tile):
    """Against the Pallas zero-copy kernel, 34 pairs (~5 s a case in
    interpret mode, which keeps it in the default tier)."""
    ds, c1, hi = zc_inputs(lh, lw, 13)
    got = K.fused_render_upsample_step_zc(t32(ds), t32(c1), t32(hi), 1,
                                          2 * lw, CameraParams(), AOParams(),
                                          row_tile=row_tile)
    want = jax_zc(ds, c1, hi, lw, JAOParams(), row_tile)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_fused_zc_row_tile_crop_and_batch():
    ds, c1, hi = zc_inputs(44, 64, 14)
    args = (t32(ds), t32(c1), t32(hi), 1, 128, CameraParams(), AOParams())
    ref = K.fused_render_upsample_step_zc(*args)
    for rt in (1, 40, 41, 44, 1000):
        np.testing.assert_array_equal(
            K.fused_render_upsample_step_zc(*args, row_tile=rt).numpy(),
            ref.numpy())
    crop = K.fused_render_upsample_step_zc(*args, crop_hw=(87, 127))
    np.testing.assert_array_equal(crop.numpy(), ref[:87, :127].numpy())
    np.testing.assert_array_equal(
        ref.numpy(), K.fused_render_upsample_step(*args).numpy())
    b = [torch.stack([a, a.flip(-1)]) for a in args[:3]]
    got = K.fused_render_upsample_step_zc(*b, *args[3:])
    np.testing.assert_array_equal(got[0].numpy(), ref.numpy())
    np.testing.assert_array_equal(
        got[1].numpy(),
        K.fused_render_upsample_step_zc(*(a.flip(-1) for a in args[:3]),
                                        *args[3:]).numpy())
    with pytest.raises(ValueError, match="expected"):
        K.fused_render_upsample_step_zc(args[0], args[1][:, :10], *args[2:])


@pytest.mark.parametrize("row_tile,lh,want", [
    (64, 44, 44), (16, 44, 40), (64, 544, 64), (128, 1088, 128),
    (1, 4, 40), (100, 60, 60)])
def test_zc_rows_like_jax(row_tile, lh, want):
    assert K.zc_rows(row_tile, lh) == want == max(min(row_tile, lh), 40)


def test_variants_do_not_launch_on_the_cpu(level):
    K.reset_launch_counts()
    K.render_ao_level_dma(t32(level), 1, 192, CameraParams(), AOParams())
    ds, c1, hi = zc_inputs(44, 64, 15)
    K.fused_render_upsample_step_zc(t32(ds), t32(c1), t32(hi), 1, 128,
                                    CameraParams(), AOParams())
    assert K.launch_counts()["render_ao_level_dma"] == 0
    assert K.launch_counts()["fused_render_upsample_step_zc"] == 0
    assert set(K.launch_counts()) >= {"render_ao_level_dma",
                                      "fused_render_upsample_step_zc"}

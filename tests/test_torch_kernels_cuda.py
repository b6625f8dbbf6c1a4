"""The CUDA kernels of tpuao_torch against their plain versions, on a GPU.

The kernel-vs-plain cases of chip_smoke.py at small sizes, the two kernel
variants against their siblings (bit for bit), and the launch counts of
the frame, normals and temporal paths.  Every
test needs a CUDA device and skips without one (a CUDA kernel has no CPU
mode; the plain versions are tested on the CPU against the JAX package in
tests/test_torch_ops.py).  This file imports no JAX, so it also runs on a
machine that has none; run it there with

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from tpuao_torch.models.pipeline import (TemporalAOEngine, render_frame,
                                         render_frame_temporal)
from tpuao_torch.models.presets import preset
from tpuao_torch.ops import kernels as K
from tpuao_torch.ops import prepare as P
from tpuao_torch.ops import render as R
from tpuao_torch.ops import temporal as T
from tpuao_torch.params import (AOParams, CameraParams, TemporalParams,
                                padded_shape)
from tpuao_torch.utils import fixtures as F
from tpuao_torch.utils.timing import cuda_time_ms

pytestmark = pytest.mark.gpu

TOL = 1e-5  # kernel vs plain version, both float32 on the card
CAM = CameraParams(depth_mode="linear")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def counts(**nonzero) -> dict:
    """A full launch-count dict: the named kernels, every other one 0."""
    out = dict.fromkeys(K.launch_counts(), 0)
    out.update(nonzero)
    return out


def close(got, want, tol=TOL):
    assert got.shape == want.shape and got.device == want.device
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= tol, err


def uniform(dev, shape, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(lo, hi, shape), dtype=torch.float32,
                           device=dev)


def pyramid(dev, h=128, w=192, seed=3):
    z = torch.as_tensor(F.spheres_on_plane(h, w, CAM, seed=seed),
                        dtype=torch.float32, device=dev)
    return [lvl.contiguous() for lvl in P.build_pyramid(z, 4)]


@pytest.mark.parametrize("exhaustive", [True, False])
def test_render_levels(dev, exhaustive):
    pyr = pyramid(dev)
    par = AOParams(exhaustive=exhaustive, strength=1.7)
    for l in range(1, 5):
        close(K.render_ao_level(pyr[l], l, 192, CAM, par),
              K.render_ao_level_plain(pyr[l], l, 192, CAM, par))


def test_render_44_rows_and_batch(dev):
    b = uniform(dev, (3, 44, 64), 0.2, 0.8, 1)
    got = K.render_ao_level(b, 1, 128, CAM, AOParams())
    close(got, K.render_ao_level_plain(b, 1, 128, CAM, AOParams()))
    close(got[2], K.render_ao_level(b[2], 1, 128, CAM, AOParams()), 0.0)


def test_render_fully_occluded_pixel_is_exactly_zero(dev):
    z = torch.full((32, 64), 0.2, device=dev)
    z[16, 32] = 0.95
    par = AOParams(strength=0.1)
    got = K.render_ao_level(z, 1, 128, CAM, par)
    assert float(got[16, 32]) == 0.0
    close(got, K.render_ao_level_plain(z, 1, 128, CAM, par))


@pytest.mark.parametrize("use2", [False, True])
@pytest.mark.parametrize("blend", [False, True])
@pytest.mark.parametrize("crop", [None, (64, 96), (63, 95), (1, 1)])
def test_upsample(dev, use2, blend, crop):
    lo = uniform(dev, (32, 48), 0.0, 1.0, 2)
    lo2 = uniform(dev, (32, 48), 0.0, 1.0, 3) if use2 else None
    lo_d = uniform(dev, (32, 48), 0.2, 0.8, 4)
    hi_d = (lo_d.repeat_interleave(2, 0).repeat_interleave(2, 1)
            + uniform(dev, (64, 96), -0.01, 0.01, 5)).contiguous()
    hi_ao = uniform(dev, (64, 96), 0.0, 1.0, 6) if blend else None
    args = (lo, lo_d, hi_d, AOParams(), 192)
    kw = dict(lo_ao2=lo2, hi_ao_blend=hi_ao, crop_hw=crop)
    close(K.blur_upsample_step(*args, **kw),
          K.blur_upsample_step_plain(*args, **kw))


@pytest.mark.parametrize("lh,lw,crop", [(44, 64, None), (44, 64, (87, 127)),
                                        (96, 64, None), (4, 4, (7, 5))])
def test_fused(dev, lh, lw, crop):
    ds = uniform(dev, (2, lh, lw), 0.2, 0.8, 7)
    c1 = uniform(dev, (2, lh, lw), 0.3, 1.0, 8)
    hi = uniform(dev, (2, 2 * lh, 2 * lw), 0.2, 0.8, 9)
    args = (ds, c1, hi, 1, 2 * lw, CAM, AOParams())
    got = K.fused_render_upsample_step(*args, crop_hw=crop)
    close(got, K.fused_render_upsample_step_plain(*args, crop_hw=crop))


# ---------------------------------------------------------------------------
# the prologue (csrc/prepare.cu) against its plain ops, bit for bit
# ---------------------------------------------------------------------------

PROLOGUE_CAMS = {
    "reversed": CameraParams(),
    "forward": CameraParams(reversed_z=False, near=0.3, far=40.0),
    "linear": CameraParams(depth_mode="linear"),
}


def prologue_inputs(dev, batch, h0, w0, seed):
    """Depth in [0, 1] with exact 0s, 1s and NaNs; normals in [-1, 1]^3,
    many with n_z <= 0.05, some exactly 0.05, some NaN: channel-last and
    channel-first (leading dims ``batch``, none for None)."""
    rng = np.random.default_rng(seed)
    b = 1 if batch is None else batch
    z = rng.uniform(0.0, 1.0, (b, h0, w0)).astype(np.float32)
    n = rng.uniform(-1.0, 1.0, (b, h0, w0, 3)).astype(np.float32)
    flat_z, flat_n = z.reshape(-1), n.reshape(-1, 3)
    for v in (0.0, 1.0, np.nan):
        flat_z[rng.integers(0, flat_z.size, 7)] = v
    flat_n[rng.integers(0, len(flat_n), 9), rng.integers(0, 3, 9)] = np.nan
    flat_n[rng.integers(0, len(flat_n), 9), 2] = 0.05
    if batch is None:
        z, n = z[0], n[0]
    ncl = torch.as_tensor(n, device=dev)
    return (torch.as_tensor(z, device=dev), ncl,
            ncl.movedim(-1, -3).contiguous())


def same_bits(got, want):
    """Equal values at equal NaN positions, a dense output."""
    assert got.shape == want.shape and got.device == want.device
    assert got.dtype == torch.float32 and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def check_prologue(z, cam, d, nrm=None):
    """One launch of the kernel a call, bit-equal to the plain ops."""
    hp, wp = padded_shape(*z.shape[-2:])
    K.reset_launch_counts()
    got, gs = K.prepare_levels(z, cam, d, hp, wp, nrm)
    assert K.launch_counts() == counts(prepare_levels=1)
    want, ws = P.prepare_levels_plain(z, cam, d, hp, wp, nrm)
    assert len(got) == len(want) == d + 1
    for g, w in zip(got, want):
        same_bits(g, w)
    assert (gs is None) == (nrm is None)
    if nrm is not None:
        assert len(gs) == len(ws) == d + 1 and gs[0] is None
        for (gx, gy), (wx, wy) in zip(gs[1:], ws[1:]):
            same_bits(gx, wx)
            same_bits(gy, wy)


@pytest.mark.parametrize("mode", sorted(PROLOGUE_CAMS))
@pytest.mark.parametrize("hw,batch", [((70, 130), None), ((70, 130), 8),
                                      ((1000, 1900), None),
                                      ((128, 192), None), ((128, 192), 8)])
def test_prologue_equals_plain_ops(dev, hw, batch, mode):
    """Pads on both axes and on neither, depths 1-4, depth only and both
    normals layouts; depth 0, 1 and NaN, n_z <= 0.05 and NaN."""
    z, ncl, ncf = prologue_inputs(dev, batch, *hw, seed=hw[0] + (batch or 1))
    for d in range(1, 5):
        for nrm in (None, ncl, ncf):
            check_prologue(z, PROLOGUE_CAMS[mode], d, nrm)


@pytest.mark.parametrize("case", ["4k_normals", "8x1080p", "8x1080p_normals",
                                  "1000x1900_normals"])
def test_prologue_main_path_shapes(dev, case):
    """The cells' shapes: 4K with channel-last normals, a rig of 8 1080p
    views (and with normals), 1000x1900; reversed-Z hardware depth."""
    cam = CameraParams()
    batch, hw = {"4k_normals": (None, (2160, 3840)),
                 "8x1080p": (8, (1080, 1920)),
                 "8x1080p_normals": (8, (1080, 1920)),
                 "1000x1900_normals": (None, (1000, 1900))}[case]
    z, ncl, _ = prologue_inputs(dev, batch, *hw, seed=21)
    check_prologue(z, cam, 4, ncl if case.endswith("normals") else None)


def test_prologue_reads_views_and_converts(dev):
    """A row slice of a batch (strided depth), a strided channel-last view
    of the normals, float16 depth and normals: the same bits as the plain
    ops on the same tensors; a tensor that requires grad is refused."""
    cam = CameraParams()
    z, ncl, _ = prologue_inputs(dev, 3, 140, 264, seed=22)
    check_prologue(z[:, 5:75, :130], cam, 4, ncl[:, 5:75, 3:133])
    check_prologue(z[1, ::2, 1::2], cam, 2, ncl[1, ::2, 1::2])
    check_prologue(z[..., :70, :128].half(), cam, 3,
                   ncl[..., :70, :128, :].half())
    with pytest.raises(ValueError, match="no backward"):
        K.prepare_levels(z.clone().requires_grad_(), cam, 4,
                         *padded_shape(140, 264))


def test_prologue_replayed_from_the_frame_graph(dev, eager_frames):
    """``render_frame``'s graph holds the prologue's launch in its tally,
    and each replay adds it: one a call, eager, captured or replayed."""
    from tpuao_torch.models import frame_graph as G

    z, n = normals_scene(dev, 270, 480)
    for par, nrm in ((preset("HIGH"), None), (preset("ULTRA"), n)):
        G._clear()
        for _ in range(3):
            K.reset_launch_counts()
            render_frame(z, CAM, par, normals=nrm)
            assert K.prepare_levels.launches == 1
        (entry,) = G._entries.values()
        assert entry.launches[K.prepare_levels, "launches"] == 1
        assert G.graph_counts()["replays"] == 2


@pytest.mark.parametrize("hw,depth", [((128, 192), 4), ((100, 150), 4),
                                      ((64, 128), 1), ((64, 128), 2)])
def test_render_frame_impls_and_launch_counts(dev, hw, depth):
    cam = CameraParams()
    z = np.stack([F.to_hardware_depth(F.spheres_on_plane(*hw, cam, seed=s),
                                      cam) for s in (0, 1)])
    d = torch.as_tensor(z.astype(np.float32), device=dev)
    par = AOParams(hierarchy_depth=depth)
    want = render_frame(d, cam, par, impl="jnp")
    K.reset_launch_counts()
    close(render_frame(d, cam, par, impl="auto"), want)
    assert K.launch_counts() == counts(prepare_levels=1, render_ao_level=1,
                                       blur_upsample_step=1,
                                       fused_render_upsample_step=depth - 1)
    K.reset_launch_counts()
    close(render_frame(d, cam, par, impl="pallas"), want)
    assert K.launch_counts() == counts(prepare_levels=1,
                                       render_ao_level=depth,
                                       blur_upsample_step=depth)


def normals_scene(dev, h=128, w=192, seed=3, batch=None):
    seeds = [seed] if batch is None else range(seed, seed + batch)
    zn = [F.spheres_on_plane(h, w, CAM, seed=s, with_normals=True)
          for s in seeds]
    z = np.stack([a for a, _ in zn]).astype(np.float32)
    n = np.stack([b for _, b in zn]).astype(np.float32)
    if batch is None:
        z, n = z[0], n[0]
    return (torch.as_tensor(z, device=dev), torch.as_tensor(n, device=dev))


@pytest.mark.parametrize("exhaustive", [True, False])
@pytest.mark.parametrize("abi", ["slopes", "normals"])
def test_render_normals_levels(dev, abi, exhaustive):
    z, n = normals_scene(dev, batch=2)
    pyr = [lvl.contiguous() for lvl in P.build_pyramid(z, 4)]
    if abi == "slopes":
        kws = [{"slopes_ds": g} for g in R.slope_pyramid(
            n, CAM.tan_half_fov_h, 128, 192, 4)]
    else:
        kws = [{"normals_ds": g} for g in R.normals_pyramid(n, 128, 192, 4)]
    par = AOParams(use_normals=True, exhaustive=exhaustive, strength=1.4)
    K.reset_launch_counts()
    diff = 0.0
    for l in range(1, 5):
        got = K.render_ao_level(pyr[l], l, 192, CAM, par, **kws[l])
        close(got, K.render_ao_level_normals_plain(pyr[l], l, 192, CAM, par,
                                                   **kws[l]))
        depth_only = K.render_ao_level_plain(pyr[l], l, 192, CAM, par)
        diff = max(diff, float((got - depth_only).abs().max()))
    assert diff > 1e-4  # the tangent term is live: depth-only differs
    assert K.render_ao_level_normals.launches == 4
    assert K.render_ao_level_normals.raw_launches == (4 if abi == "normals"
                                                      else 0)
    assert K.render_ao_level.launches == 0


def test_render_normals_channel_last_and_flat_wall(dev):
    z, n = normals_scene(dev, 64, 96)
    ds = z[::2, ::2].contiguous()
    nds = n[::2, ::2].contiguous()
    par = AOParams(use_normals=True)
    got = K.render_ao_level(ds, 1, 96, CAM, par, normals_ds=nds)
    close(got, K.render_ao_level_normals_plain(ds, 1, 96, CAM, par,
                                               normals_ds=nds))
    flat = torch.zeros_like(nds)
    flat[..., 2] = 1.0
    close(K.render_ao_level(ds, 1, 96, CAM, par, normals_ds=flat),
          K.render_ao_level(ds, 1, 96, CAM, AOParams()))


def history(dev, h, w, r, seed):
    rng = np.random.default_rng(seed)
    ii, jj = np.mgrid[0:h, 0:w]
    f = [rng.uniform(0.0, 1.0, (h, w)), rng.uniform(0.05, 1.0, (h, w)),
         ii + rng.uniform(-(r + 2), r + 2, (h, w)),
         jj + rng.uniform(-(r + 2), r + 2, (h, w))]
    f[2][0, :4] = [-r - 1.5, r + 1.0, 0.0, r + 0.25]
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in f]


@pytest.mark.parametrize("h,w,r", [(64, 96, 4), (37, 50, 2), (8, 8, 1)])
def test_windowed_resolve(dev, h, w, r):
    args = history(dev, h, w, r, 12)
    K.reset_launch_counts()
    got = K.windowed_resolve(*args, r)
    assert K.windowed_resolve.launches == 1
    for g, want in zip(got, K.windowed_resolve_plain(*args, r)):
        close(g, want)
    null = T.initial_state(h, w, device=dev)
    got = K.windowed_resolve(*null, *args[2:], r)
    want = K.windowed_resolve_plain(*null, *args[2:], r)
    close(got[0], want[0])
    assert float(((got[1] - want[1]) / want[1].clamp(min=1.0)).abs().max()
                 ) <= 1e-6


@pytest.mark.parametrize("resolve_level", [0, 1])
def test_temporal_frames_and_launch_counts(dev, resolve_level):
    cam = CAM
    frames = [torch.as_tensor(F.spheres_on_plane(
        128, 192, cam, seed=5, eye=(0.05 * t, 0.0, 0.04 * t)),
        dtype=torch.float32, device=dev) for t in range(3)]
    views = []
    for t in range(3):
        v = np.eye(4)
        v[0, 3], v[2, 3] = -0.05 * t, -0.04 * t
        views.append(v)
    engines = {impl: TemporalAOEngine(cam, preset("HIGH"), impl=impl,
                                      resolve_level=resolve_level)
               for impl in ("auto", "jnp")}
    for t in range(3):
        want = engines["jnp"].render(frames[t], view=views[t])
        K.reset_launch_counts()
        got = engines["auto"].render(frames[t], view=views[t])
        close(got, want)
        want_counts = (counts(prepare_levels=1, render_ao_level=1,
                              blur_upsample_step=1,
                              fused_render_upsample_step=3)
                       if resolve_level == 0 else
                       counts(prepare_levels=1, render_ao_level=2,
                              blur_upsample_step=2,
                              fused_render_upsample_step=2))
        want_counts.update(windowed_resolve=int(t > 0))
        assert K.launch_counts() == want_counts


def test_ultra_temporal_and_max_displacement_none(dev):
    z, n = normals_scene(dev, 128, 192)
    for rl in (0, 1):
        got, want = (render_frame_temporal(
            z, None, CAM, preset("ULTRA"), TemporalParams(),
            motion=np.eye(4), normals=n, impl=impl, resolve_level=rl)[0]
            for impl in ("auto", "jnp"))
        close(got, want)
    tp = TemporalParams(max_displacement=None)
    prev = (torch.rand(128, 192, device=dev), z.clone())
    m = np.eye(4)
    m[0, 3] = 0.3
    K.reset_launch_counts()
    a, _ = render_frame_temporal(z, prev, CAM, AOParams(), tp, motion=m)
    assert K.windowed_resolve.launches == 0  # the gather is plain torch
    b, _ = render_frame_temporal(z, prev, CAM, AOParams(), tp, motion=m,
                                 impl="jnp")
    close(a, b)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    z = uniform(dev, (64, 96), 0.2, 0.8, 10)
    with pytest.raises(ValueError, match="contiguous"):
        K.render_ao_level(z[:, ::2], 1, 96, CAM, AOParams())
    with pytest.raises(TypeError, match="float32"):
        K.render_ao_level(z.double(), 1, 96, CAM, AOParams())
    with pytest.raises(ValueError, match="4x4"):
        K.render_ao_level(z[:3].contiguous(), 1, 96, CAM, AOParams())
    with pytest.raises(ValueError, match="expected"):
        K.fused_render_upsample_step(z[:32, :48].contiguous(),
                                     torch.ones(32, 48), z, 1, 96, CAM,
                                     AOParams())
    with pytest.raises(ValueError, match="cuda|cpu|expected"):
        K.render_ao_level(z, 1, 96, CAM, AOParams(use_normals=True),
                          slopes_ds=(torch.zeros(64, 96),) * 2)
    with pytest.raises(ValueError, match="contiguous"):
        K.windowed_resolve(z[:, ::2], z[:, ::2], z[:, ::2], z[:, ::2], 2)
    with pytest.raises(ValueError, match="device"):
        render_frame(z, CAM, AOParams(use_normals=True),
                     normals=torch.zeros(64, 96, 3))


DMA_SIZES = [(64, 96), (44, 64), (37, 50), (130, 200), (70, 96), (70, 100),
             (70, 130), (70, 200), (45, 64)]
# uneven rows; ragged last strips; an interior strip between edge strips
# (200); widths that take 16-byte copies (multiples of 4) and ones that
# take 4-byte copies (50, 130); levels that are one strip (64, 50)


@pytest.mark.parametrize("h,w", DMA_SIZES)
def test_render_dma_equals_render_kernel(dev, h, w):
    """Bit for bit against render.cu (the same render_tile_texel on the
    same tap values) and plain, both pair tables, at a batch of three and
    one frame, for every row_tile (segments of one row to one a strip)."""
    z = uniform(dev, (3, h, w), 0.05, 1.0, 20)
    z[1] = torch.as_tensor(F.spheres_on_plane(h, w, CAM, seed=4),
                           dtype=torch.float32, device=dev)
    row_tiles = (128, 1, 7, 16, 23, 37, 4096, 10000)
    for ex in (True, False):
        par = AOParams(exhaustive=ex, strength=1.3)
        sib = K.render_ao_level(z, 1, 2 * w, CAM, par)
        close(sib, K.render_ao_level_plain(z, 1, 2 * w, CAM, par), 0.0)
        K.reset_launch_counts()
        for rt in row_tiles:
            close(K.render_ao_level_dma(z, 1, 2 * w, CAM, par, row_tile=rt),
                  sib, 0.0)
            close(K.render_ao_level_dma(z[2], 1, 2 * w, CAM, par,
                                        row_tile=rt), sib[2], 0.0)
        assert K.render_ao_level_dma.launches == 2 * len(row_tiles)


def dma_at_segment(z, seg, par, full_width):
    """The DMA kernel at a given segment, through its entry point (past
    the wrapper's rule, which takes one step a segment at small sizes)."""
    out = torch.empty_like(z)
    table = K._level_table(par, 1, full_width, CAM)
    K._launch("tpuao_render_ao_level_dma", z.data_ptr(), out.data_ptr(),
              z.shape[0] if z.ndim == 3 else 1, z.shape[-2], z.shape[-1],
              seg, table.ctypes.data, len(table),
              float(par.rejection_falloff), float(par.strength),
              z.device.index, K._stream(z.device))
    return out


@pytest.mark.parametrize("w", [100, 130])
def test_render_dma_every_segment(dev, w):
    """Segments of 1 to 160 rows (one to twenty steps; one, two and four
    texels a thread) over a 150-row level, at a width that takes 16-byte
    copies (100) and one that takes 4-byte copies (130): bit-equal to
    render.cu; a segment past 160 rows is refused."""
    z = uniform(dev, (2, 150, w), 0.05, 1.0, 63)
    par = AOParams(strength=1.2)
    want = K.render_ao_level(z, 1, 4 * w, CAM, par)
    for seg in (1, 5, 8, 16, 24, 32, 40, 48, 64, 96, 120, 152, 160):
        close(dma_at_segment(z, seg, par, 4 * w), want, 0.0)
    with pytest.raises(RuntimeError, match="CUDA error"):
        dma_at_segment(z, 161, par, 4 * w)


def test_render_dma_misaligned_base_stages_by_cp_async(dev):
    """A level whose first texel is off 16 bytes (width a multiple of 4)
    cannot take 16-byte copies: the same kernel stages it by 4-byte
    cp.async and still equals render.cu bit for bit."""
    buf = uniform(dev, (64 * 96 + 1,), 0.05, 1.0, 61)
    z = buf[1:].view(64, 96)
    assert z.is_contiguous() and z.data_ptr() % 16 != 0
    for rt in (1, 37, 128):
        close(K.render_ao_level_dma(z, 1, 384, CAM, AOParams(), row_tile=rt),
              K.render_ao_level(z, 1, 384, CAM, AOParams()), 0.0)


def test_render_dma_4k_level_twice(dev):
    """A 4K level-1 plane (1088 x 1920: 64-row segments of two steps at
    four texels a thread; row_tile 16 and 7 take two texels and one),
    run twice in a row at each setting: every launch ends (no barrier
    waited on in vain) and equals render.cu bit for bit."""
    z = uniform(dev, (1088, 1920), 0.05, 1.0, 62)
    want = K.render_ao_level(z, 1, 3840, CAM, AOParams())
    K.reset_launch_counts()
    for rt in (128, 128, 16, 16, 7, 7):
        got = K.render_ao_level_dma(z, 1, 3840, CAM, AOParams(), row_tile=rt)
        torch.cuda.synchronize()
        close(got, want, 0.0)
    assert K.render_ao_level_dma.launches == 6


def test_debug_outputs_render_every_level_under_auto(dev):
    """With debug_outputs the default path also renders levels 1-3 for the
    dict (4 render launches, the prologue's and the chain's launches
    unchanged); without it one; "fused" keeps level 4 alone."""
    cam = CameraParams()
    z = torch.as_tensor(F.to_hardware_depth(
        F.spheres_on_plane(128, 192, cam, seed=2), cam).astype(np.float32),
        device=dev)
    chain = dict(prepare_levels=1, blur_upsample_step=1,
                 fused_render_upsample_step=3)
    K.reset_launch_counts()
    out = render_frame(z, cam, AOParams())
    assert K.launch_counts() == counts(render_ao_level=1, **chain)
    K.reset_launch_counts()
    got, dbg = render_frame(z, cam, AOParams(), debug_outputs=True)
    assert K.launch_counts() == counts(render_ao_level=4, **chain)
    close(got, out, 0.0)
    _, want = render_frame(z, cam, AOParams(), debug_outputs=True,
                           impl="jnp")
    assert sorted(dbg["ao_levels"]) == [1, 2, 3, 4]
    for l in range(1, 5):
        close(dbg["ao_levels"][l], want["ao_levels"][l], 0.0)
    K.reset_launch_counts()
    _, dbg = render_frame(z, cam, AOParams(), debug_outputs=True,
                          impl="fused")
    assert list(dbg["ao_levels"]) == [4]
    assert K.launch_counts() == counts(render_ao_level=1, **chain)


@pytest.mark.parametrize("lh,lw,crop", [(44, 64, None), (44, 64, (87, 127)),
                                        (96, 64, None), (4, 4, (7, 5)),
                                        (61, 94, (121, 187))])
def test_fused_zc_equals_fused_kernel(dev, lh, lw, crop):
    ds = uniform(dev, (2, lh, lw), 0.2, 0.8, 21)
    c1 = uniform(dev, (2, lh, lw), 0.3, 1.0, 22)
    hi = uniform(dev, (2, 2 * lh, 2 * lw), 0.2, 0.8, 23)
    args = (ds, c1, hi, 1, 2 * lw, CAM, AOParams())
    sib = K.fused_render_upsample_step(*args, crop_hw=crop)
    plain = K.fused_render_upsample_step_plain(*args, crop_hw=crop)
    K.reset_launch_counts()
    for rt in (64, 16, 41, 1000):
        got = K.fused_render_upsample_step_zc(*args, row_tile=rt,
                                              crop_hw=crop)
        close(got, sib, 0.0)
        close(got, plain)
    assert K.fused_render_upsample_step_zc.launches == 4
    assert K.fused_render_upsample_step.launches == 0


def test_render_kernels_round_like_their_plain_versions(dev):
    """At level 1 of a 4K frame inv_r is large enough that a pair test
    contracted into FMAs lands over 1e-6 from the plain version; the
    kernels round each step as it does, and stay within 1.1e-6."""
    cam = CameraParams(depth_mode="linear")
    z = torch.as_tensor(F.spheres_on_plane(2176, 3840, cam, seed=7),
                        dtype=torch.float32, device=dev)
    pyr = [lvl.contiguous()
           for lvl in P.build_pyramid(P.linearize_depth(z, cam), 2)]
    par = AOParams()
    plain = K.render_ao_level_plain(pyr[1], 1, 3840, cam, par)
    close(K.render_ao_level(pyr[1], 1, 3840, CAM, par), plain, 1.1e-6)
    close(K.render_ao_level_dma(pyr[1], 1, 3840, CAM, par), plain, 1.1e-6)
    c1 = torch.rand(pyr[2].shape, device=dev)
    args = (pyr[2], c1, pyr[1], 2, 3840, CAM, par)
    want = K.fused_render_upsample_step_plain(*args)
    close(K.fused_render_upsample_step(*args), want, 1.1e-6)
    close(K.fused_render_upsample_step_zc(*args), want, 1.1e-6)


TILED_SIZES = [(37, 50), (44, 64), (4, 4), (65, 129)]  # uneven, minimal,
# and straddling the render tile (8 or 16 rows x 64 columns) and the fused
# tile (5 or 13 x 61 lo texels)


@pytest.mark.parametrize("h,w", TILED_SIZES)
def test_tiled_render_all_modes_bit_equal_to_plain(dev, h, w):
    """The shared-memory tiled render, in its three modes, at batch 3 and
    one frame (the two take different texels-a-thread paths), equals its
    plain version bit for bit, and the DMA render equals it bit for bit."""
    rng = np.random.default_rng(30)
    z = uniform(dev, (3, h, w), 0.05, 1.0, 31)
    nrm = torch.as_tensor(rng.normal(size=(3, 3, h, w)), dtype=torch.float32,
                          device=dev)
    nrm[:, 2] = nrm[:, 2].abs() + 0.1
    gx, gy = (torch.as_tensor(rng.normal(size=(3, h, w)) * 0.02,
                              dtype=torch.float32, device=dev)
              for _ in range(2))
    for ex in (True, False):
        par = AOParams(exhaustive=ex, strength=1.3)
        got = K.render_ao_level(z, 1, 4 * w, CAM, par)
        close(got, K.render_ao_level_plain(z, 1, 4 * w, CAM, par), 0.0)
        close(K.render_ao_level_dma(z, 1, 4 * w, CAM, par), got, 0.0)
        close(K.render_ao_level(z[1], 1, 4 * w, CAM, par), got[1], 0.0)
        pn = par.replace(use_normals=True)
        for l in (1, 3):
            for kw in ({"normals_ds": nrm}, {"slopes_ds": (gx, gy)}):
                got = K.render_ao_level_normals(z, l, 4 * w, CAM, pn, **kw)
                close(got, K.render_ao_level_normals_plain(
                    z, l, 4 * w, CAM, pn, **kw), 0.0)


@pytest.mark.parametrize("lh,lw", TILED_SIZES)
def test_tiled_fused_step_against_plain_and_zero_copy(dev, lh, lw):
    """The tiled fused step at batch 3 and one frame, uncropped and with
    an odd crop: within 3e-7 of its plain version (the chain stages'
    rounding), bit-equal to the zero-copy step, and batch members equal to
    single frames."""
    ds = uniform(dev, (3, lh, lw), 0.2, 0.8, 32)
    c1 = uniform(dev, (3, lh, lw), 0.3, 1.0, 33)
    hi = uniform(dev, (3, 2 * lh, 2 * lw), 0.2, 0.8, 34)
    for crop in (None, (2 * lh - 1, 2 * lw - 1)):
        args = (ds, c1, hi, 1, 4 * lw, CAM, AOParams())
        got = K.fused_render_upsample_step(*args, crop_hw=crop)
        close(got, K.fused_render_upsample_step_plain(*args, crop_hw=crop),
              3e-7)
        close(K.fused_render_upsample_step_zc(*args, crop_hw=crop), got, 0.0)
        one = K.fused_render_upsample_step(ds[2], c1[2], hi[2], 1, 4 * lw,
                                           CAM, AOParams(), crop_hw=crop)
        close(one, got[2], 0.0)


CLAMP_CASES = [("render", 4), ("render", 2), ("render", 1), ("slopes", 1),
               ("normals", 1), ("fused", 3), ("fused", 2), ("fused", 1),
               ("fused_zc", None), ("render_dma", None)]
W_4K = 3840  # the 4K ULTRA frame width: it sets each level's inv_r and m2


def clamp_scenes(dev, h, w):
    """Three levels whose pair tests land on the clamps: a plane at 0.5
    (every zs/zc exactly 1: d == 1, falloff * d > 1), texels drawn from
    0.25, 0.5 and 1.0 (ratios 1/4 to 4: d far below 0 and far above 1 at
    4K's inv_r, and exact ties), and uniform noise."""
    rng = np.random.default_rng(50)
    steps = torch.as_tensor(rng.choice([0.25, 0.5, 1.0], size=(h, w)),
                            dtype=torch.float32, device=dev)
    return torch.stack([torch.full((h, w), 0.5, device=dev), steps,
                        uniform(dev, (h, w), 0.05, 1.0, 51)])


def clamp_slopes(dev, shape, level):
    """The tangent term's extremes at a 4K level: (label, kwargs) of zero
    slopes (x == 0, and -0.0), and of the steepest slopes the clamp n_z >=
    0.05 allows on unit normals (n_z exactly 0.05, and 0.01 clamped to
    it), in random directions, as slope planes and as raw normals."""
    rng = np.random.default_rng(52 + level)
    ang = rng.uniform(0.0, 2.0 * np.pi, shape)
    ts0 = 2.0 * CAM.tan_half_fov_h / W_4K  # level-0 texel scale
    out = []
    for n_z in (0.05, 0.01):
        s = np.sqrt(1.0 - n_z * n_z)
        nx, ny = s * np.cos(ang), s * np.sin(ang)
        nrm = np.stack([nx, ny, np.full(shape, n_z)], axis=-3)
        g = ts0 / max(n_z, 0.05)
        slopes = tuple(torch.as_tensor(a * g, dtype=torch.float32,
                                       device=dev) for a in (nx, ny))
        out += [(f"slopes n_z={n_z}", {"slopes_ds": slopes}),
                (f"normals n_z={n_z}", {"normals_ds": torch.as_tensor(
                    nrm, dtype=torch.float32, device=dev)})]
    zero = torch.zeros(shape, device=dev)
    flat = np.zeros(shape[:-2] + (3,) + shape[-2:])
    flat[..., 2, :, :] = 1.0
    out += [("slopes 0", {"slopes_ds": (zero, zero)}),
            ("slopes -0", {"slopes_ds": (-zero, -zero)}),
            ("normals flat", {"normals_ds": torch.as_tensor(
                flat, dtype=torch.float32, device=dev)})]
    return out


@pytest.mark.parametrize("kernel,nt", CLAMP_CASES)
def test_pair_test_at_its_clamps_bit_equal_to_plain(dev, kernel, nt):
    """Every render instance on tiles whose pair tests land exactly on
    the clamps (``clamp_scenes``), both pair tables, equals its plain
    version bit for bit: the depth-only render at 4, 2 and 1 texels a
    thread and the DMA render at levels 1 and 4 of 4K; the normals render
    (slope planes, raw normals) at levels 1-4 of 4K ULTRA at zero and the
    steepest slopes (``clamp_slopes``); the fused step at 3, 2 and 1
    texels a thread and the zero-copy step against the upsample kernel on
    the plain render (c1 = 1, so the pre-min passes the render through).
    The falloff takes 2.5 and the ends of its range, 1 (where the falloff
    product of the clamped d and of the raw d meet) and 10."""
    from tpuao_torch.utils import launch_opts as L

    z = clamp_scenes(dev, 70, 130)
    name = {"render": "render_ao_level", "fused": "fused_render_upsample_step"}
    L.clear_tuned_tiles()
    try:
        if nt is not None and kernel in name:
            L.set_tuned_tiles(name[kernel], 3, 70, 130, nt)
        for ex, falloff in ((True, 2.5), (False, 2.5), (True, 1.0),
                            (False, 10.0)):
            pu = preset("ULTRA").replace(exhaustive=ex,
                                         rejection_falloff=falloff)
            par = pu.replace(use_normals=False)
            if kernel in ("slopes", "normals"):
                for level in (1, 2, 3, 4):
                    for label, kw in clamp_slopes(dev, (3, 70, 130), level):
                        if kernel not in label:
                            continue
                        got = K.render_ao_level_normals(z, level, W_4K, CAM,
                                                        pu, **kw)
                        want = K.render_ao_level_normals_plain(
                            z, level, W_4K, CAM, pu, **kw)
                        assert torch.equal(got, want), (label, level, ex,
                                                        falloff)
            elif kernel in ("render", "render_dma"):
                fn = (K.render_ao_level if kernel == "render"
                      else K.render_ao_level_dma)
                for level in (1, 4):
                    want = K.render_ao_level_plain(z, level, W_4K, CAM, par)
                    assert torch.equal(fn(z, level, W_4K, CAM, par),
                                       want), (level, ex, falloff)
            else:
                fn = (K.fused_render_upsample_step if kernel == "fused"
                      else K.fused_render_upsample_step_zc)
                c1 = torch.ones_like(z)
                hi = (z.repeat_interleave(2, -2).repeat_interleave(2, -1)
                      + uniform(dev, (3, 140, 260), -0.01, 0.01, 53))
                for crop in (None, (139, 259)):
                    want = K.blur_upsample_step(
                        c1, z, hi, par, W_4K, crop_hw=crop,
                        lo_ao2=K.render_ao_level_plain(z, 1, W_4K, CAM, par))
                    got = fn(z, c1, hi, 1, W_4K, CAM, par, crop_hw=crop)
                    assert torch.equal(got, want), (crop, ex, falloff)
    finally:
        L.clear_tuned_tiles()


@pytest.mark.parametrize("falloff", [0.5, 0.99999994, 10.000001,
                                     float("nan")])
def test_render_kernels_reject_a_falloff_outside_its_range(dev, falloff):
    """Every kernel that renders forms the falloff product from the
    clamped d, exact for a falloff of 1 or more (common.cuh), and rejects
    one outside AOParams's range, 1..10, before it launches."""
    z = uniform(dev, (64, 96), 0.2, 0.8, 26)
    hi = uniform(dev, (128, 192), 0.2, 0.8, 27)
    zero = torch.zeros_like(z)
    pu = preset("ULTRA").replace(rejection_falloff=falloff)
    par = pu.replace(use_normals=False)
    calls = {
        "render": lambda: K.render_ao_level(z, 1, 192, CAM, par),
        "slopes": lambda: K.render_ao_level_normals(
            z, 1, 192, CAM, pu, slopes_ds=(zero, zero)),
        "fused": lambda: K.fused_render_upsample_step(z, z, hi, 1, 192, CAM,
                                                      par),
        "fused_zc": lambda: K.fused_render_upsample_step_zc(z, z, hi, 1, 192,
                                                            CAM, par),
        "render_dma": lambda: K.render_ao_level_dma(z, 1, 192, CAM, par),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="invalid argument"):
            call()
            pytest.fail(name)


def test_variants_raise_on_what_the_kernels_do_not_take(dev):
    z = uniform(dev, (64, 96), 0.2, 0.8, 24)
    hi = uniform(dev, (128, 192), 0.2, 0.8, 25)
    par = AOParams()
    with pytest.raises(ValueError, match="contiguous"):
        K.render_ao_level_dma(z[:, ::2], 1, 96, CAM, par)
    with pytest.raises(TypeError, match="float32"):
        K.render_ao_level_dma(z.double(), 1, 96, CAM, par)
    with pytest.raises(ValueError, match="4x4"):
        K.render_ao_level_dma(z[:3].contiguous(), 1, 96, CAM, par)
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_render_upsample_step_zc(z, z.t().contiguous().t(), hi, 1,
                                        192, CAM, par)
    with pytest.raises(TypeError, match="float32"):
        K.fused_render_upsample_step_zc(z, z.half(), hi, 1, 192, CAM, par)
    with pytest.raises(ValueError, match="expected"):  # mixed devices
        K.fused_render_upsample_step_zc(z, z, hi.cpu(), 1, 192, CAM, par)


def test_timing_reads_the_device(dev):
    z = uniform(dev, (544, 960), 0.2, 0.8, 11)
    ms = cuda_time_ms(lambda: K.render_ao_level(z, 1, 1920, CAM, AOParams()),
                      warmup=1, iters=5)
    assert 0.0 < ms < 1000.0


UPSAMPLE_SIZES = TILED_SIZES + [(68, 120), (21, 61), (22, 62)]  # + the
# 1080p level 4 (HIGH's step 4->3) and a 21-row, 61-column lo tile and one
# texel past it (the upsample tile: (8*NT - 3) x 61 lo texels)


@pytest.mark.parametrize("lh,lw", UPSAMPLE_SIZES)
def test_tiled_upsample_against_plain_and_single_frames(dev, lh, lw):
    """The tiled upsample step with and without pre-min and blend, uncropped
    and with odd crops, at batch 3 (three texels a thread on large grids)
    and one frame: within 3e-7 of its plain version (the chain stages'
    rounding, as the fused step's) and batch members equal to single
    frames bit for bit."""
    lo = uniform(dev, (3, lh, lw), 0.0, 1.0, 40)
    lo2 = uniform(dev, (3, lh, lw), 0.0, 1.0, 41)
    lo_d = uniform(dev, (3, lh, lw), 0.2, 0.8, 42)
    hi_d = (lo_d.repeat_interleave(2, -2).repeat_interleave(2, -1)
            + uniform(dev, (3, 2 * lh, 2 * lw), -0.01, 0.01, 43)).contiguous()
    blend = uniform(dev, (3, 2 * lh, 2 * lw), 0.0, 1.0, 44)
    for use2 in (False, True):
        for use_blend in (False, True):
            for crop in (None, (2 * lh - 1, 2 * lw - 1), (2 * lh, 2 * lw - 3)):
                kw = dict(lo_ao2=lo2 if use2 else None,
                          hi_ao_blend=blend if use_blend else None,
                          crop_hw=crop)
                args = (lo, lo_d, hi_d, AOParams(), 8 * lw)
                got = K.blur_upsample_step(*args, **kw)
                close(got, K.blur_upsample_step_plain(*args, **kw), 3e-7)
                one = {k: (v[1] if isinstance(v, torch.Tensor) else v)
                       for k, v in kw.items()}
                close(K.blur_upsample_step(lo[1], lo_d[1], hi_d[1],
                                           AOParams(), 8 * lw, **one),
                      got[1], 0.0)


def test_upsample_ultra_chain_shapes_batched(dev):
    """The ULTRA chain's four steps at four 1080p frames (pre-min from
    level 3 down, cropped to 1080 x 1920 at the last), each within 1e-6
    of its plain version on the same inputs: the kernel contracts its
    sums into FMAs where the plain version rounds each product, which
    over 2.8 M lo texels reaches three ulp of 1.0 (3.6e-7 measured)."""
    z, _ = normals_scene(dev, 1088, 1920, batch=4)
    pyr = [lvl.contiguous() for lvl in P.build_pyramid(z, 4)]
    aos = {l: K.render_ao_level(pyr[l], l, 1920, CAM, AOParams())
           for l in range(1, 5)}
    c = aos[4]
    for l in (4, 3, 2, 1):
        kw = dict(lo_ao2=None if l == 4 else aos[l],
                  crop_hw=(1080, 1920) if l == 1 else None)
        got = K.blur_upsample_step(c, pyr[l], pyr[l - 1], AOParams(), 1920,
                                   **kw)
        close(got, K.blur_upsample_step_plain(c, pyr[l], pyr[l - 1],
                                              AOParams(), 1920, **kw), 1e-6)
        c = got


@pytest.mark.parametrize("lh,lw", [(13, 61), (21, 62), (42, 123),
                                   (90, 61), (105, 122)])
def test_fused_zc_tile_edges_and_row_tiles(dev, lh, lw):
    """The zero-copy step at sizes on and one past its tile (13 or 21 lo
    rows a step, 61 lo columns a strip), over several segments (R = 40
    and 100 take three texels a thread, R = 64 two): bit-equal to the
    tiled fused step for every row_tile, within 3e-7 of its plain
    version, batch members equal to single frames."""
    ds = uniform(dev, (2, lh, lw), 0.2, 0.8, 50)
    c1 = uniform(dev, (2, lh, lw), 0.3, 1.0, 51)
    hi = uniform(dev, (2, 2 * lh, 2 * lw), 0.2, 0.8, 52)
    for crop in (None, (2 * lh - 1, 2 * lw - 1)):
        args = (ds, c1, hi, 1, 4 * lw, CAM, AOParams())
        sib = K.fused_render_upsample_step(*args, crop_hw=crop)
        close(sib, K.fused_render_upsample_step_plain(*args, crop_hw=crop),
              3e-7)
        for rt in (1, 40, 64, 100, 1000):
            got = K.fused_render_upsample_step_zc(*args, row_tile=rt,
                                                  crop_hw=crop)
            close(got, sib, 0.0)
        one = K.fused_render_upsample_step_zc(ds[1], c1[1], hi[1], 1, 4 * lw,
                                              CAM, AOParams(), crop_hw=crop)
        close(one, sib[1], 0.0)


WRAPPERS_WITH_TUNABLES = ("render_ao_level", "render_ao_level_normals",
                          "render_ao_level_dma", "blur_upsample_step",
                          "fused_render_upsample_step",
                          "fused_render_upsample_step_zc")


def _wrapper_call(name, dev, params, grad_input=False):
    """A call of wrapper ``name`` at 32x48 -> 64x96 with ``params``; with
    ``grad_input`` its first tensor requires grad."""
    lo = uniform(dev, (32, 48), 0.3, 0.7, 1)
    c1 = uniform(dev, (32, 48), 0.5, 1.0, 2)
    hi = uniform(dev, (64, 96), 0.3, 0.7, 3)
    if grad_input:
        lo.requires_grad_()
    cam = CAM
    if name == "render_ao_level_normals":
        g = (torch.zeros_like(c1), torch.zeros_like(c1))
        return lambda: K.render_ao_level_normals(lo, 1, 96, cam, params,
                                                 slopes_ds=g)
    if name in ("render_ao_level", "render_ao_level_dma"):
        return lambda: getattr(K, name)(lo, 1, 96, cam, params)
    if name == "blur_upsample_step":
        return lambda: K.blur_upsample_step(c1 if not grad_input else lo,
                                            hi[::2, ::2].contiguous(), hi,
                                            params, 96)
    return lambda: getattr(K, name)(lo, c1, hi, 1, 96, cam, params)


@pytest.mark.parametrize("name", WRAPPERS_WITH_TUNABLES)
def test_wrappers_refuse_what_requires_grad(dev, name):
    """The kernels have no backward: a tunable tensor or an input that
    requires grad raises while autograd is on, and launches nothing;
    under no_grad, or with tensors that do not require grad, the same
    call launches as before."""
    par = AOParams(use_normals=name == "render_ao_level_normals")
    leaf = torch.tensor(1.5, device=dev, requires_grad=True)
    K.reset_launch_counts()
    for call in (_wrapper_call(name, dev, par.replace(strength=leaf)),
                 _wrapper_call(name, dev, par, grad_input=True)):
        with pytest.raises(ValueError, match="no backward"):
            call()
    assert sum(K.launch_counts().values()) == 0
    with torch.no_grad():
        _wrapper_call(name, dev, par.replace(strength=leaf))()
    _wrapper_call(name, dev, par.replace(strength=leaf.detach()))()
    assert getattr(K, name).launches == 2


def test_windowed_refuses_what_requires_grad(dev):
    ao = uniform(dev, (16, 24), 0.0, 1.0, 4).requires_grad_()
    d = uniform(dev, (16, 24), 0.3, 0.7, 5)
    ii, jj = torch.meshgrid(torch.arange(16.0, device=dev),
                            torch.arange(24.0, device=dev), indexing="ij")
    with pytest.raises(ValueError, match="no backward"):
        K.windowed_resolve(ao, d, ii.contiguous(), jj.contiguous(), 2)


def test_launchers_keep_the_callers_device_and_mesh_of_one_card(dev):
    """A launch leaves the current device as it found it (on another card
    too, where there is one); a mesh naming this card twice renders each
    view bit-equal to one batch, 6 launches a shard."""
    from tpuao_torch.parallel.sharding import render_views_sharded

    z = torch.stack([pyramid(dev, 64, 96, seed=s)[0] for s in range(3)])
    before = torch.cuda.current_device()
    one = render_views_sharded(z, CAM)
    K.reset_launch_counts()
    two = render_views_sharded(z, CAM, mesh=[dev, dev])
    assert torch.cuda.current_device() == before
    assert torch.equal(one, two)
    assert K.launch_counts() == counts(prepare_levels=2, render_ao_level=2,
                                       blur_upsample_step=2,
                                       fused_render_upsample_step=6)
    if torch.cuda.device_count() > 1:
        other = torch.device("cuda", 1)
        with torch.cuda.device(0):
            K.render_ao_level(z[0].to(other), 1, 96, CAM, AOParams())
            assert torch.cuda.current_device() == 0


def test_spatial_1080p_on_two_bands_of_one_card(dev):
    """A 1080p frame in 2 row bands on ``(cuda:0, cuda:0)`` (padded to
    1152 rows, bands of 576, each extended by 320 halo rows) is bit-equal
    to the frame program on the halo-padded frame, cropped: 6 launches a
    band, the current device unchanged."""
    from tpuao_torch.parallel.spatial import HALO_ROWS, render_frame_spatial

    z = torch.as_tensor(F.spheres_on_plane(1080, 1920, CAM, seed=3),
                        dtype=torch.float32, device=dev)
    before = torch.cuda.current_device()
    K.reset_launch_counts()
    got = render_frame_spatial(z, CAM, mesh=[dev, dev])
    assert torch.cuda.current_device() == before
    assert K.launch_counts() == counts(prepare_levels=2, render_ao_level=2,
                                       blur_upsample_step=2,
                                       fused_render_upsample_step=6)
    padded = torch.nn.functional.pad(
        z[None, None], (0, 0, HALO_ROWS, HALO_ROWS + 1152 - 1080),
        mode="replicate")[0, 0]
    want = render_frame(padded, CAM)[HALO_ROWS: HALO_ROWS + 1080]
    assert got.shape == (1080, 1920) and got.device == z.device
    assert torch.equal(got, want)


def test_golden_on_the_card(dev):
    """The float64 golden on the card agrees with the CPU's within 1e-12
    at 135x240 (HIGH, and ULTRA with normals), and the HIGH ``auto`` frame
    (prologue 1, render 1, upsample 1, fused 3 launches) is within 1e-4
    of the card's
    golden, the bound the CPU tests hold the plain path to."""
    from tpuao_torch.golden import render_frame_golden

    cam = CameraParams()
    z, n = F.spheres_on_plane(135, 240, cam, seed=11, with_normals=True)
    d = torch.as_tensor(F.to_hardware_depth(z, cam).astype(np.float32),
                        device=dev)
    nrm = torch.as_tensor(n.astype(np.float32), device=dev)
    for name in ("HIGH", "ULTRA"):
        par = preset(name)
        g = render_frame_golden(d, cam, par, nrm)
        assert g.device == d.device and g.dtype == torch.float64
        c = render_frame_golden(d.cpu(), cam, par, nrm.cpu())
        assert float((g.cpu() - c).abs().max()) <= 1e-12
    K.reset_launch_counts()
    got = render_frame(d, cam, preset("HIGH"), impl="auto")
    assert K.launch_counts() == counts(prepare_levels=1, render_ao_level=1,
                                       blur_upsample_step=1,
                                       fused_render_upsample_step=3)
    want = render_frame_golden(d, cam, preset("HIGH"))
    close(got.double(), want, 1e-4)


@pytest.mark.parametrize("k", [2, 4])
def test_sections_1080p_equal_the_monolithic_frame(dev, k):
    """1080p HIGH in k sequential sections on the card (halo 320; plans
    of 1152 and 1280 rows, bands of 576 and 320) is the monolithic frame
    bit for bit, in both forms, with k times its launches."""
    from tpuao_torch.parallel.sections import (render_frame_sections,
                                               render_frame_sections_fused)

    z = torch.as_tensor(F.spheres_on_plane(1080, 1920, CAM, seed=4),
                        dtype=torch.float32, device=dev)
    want = render_frame(z, CAM)
    K.reset_launch_counts()
    got = render_frame_sections(z, CAM, n_sections=k)
    assert K.launch_counts() == counts(prepare_levels=k, render_ao_level=k,
                                       blur_upsample_step=k,
                                       fused_render_upsample_step=3 * k)
    assert got.shape == (1080, 1920) and got.device == z.device
    assert torch.equal(got, want)
    assert torch.equal(render_frame_sections_fused(z, CAM, n_sections=k),
                       want)


def _tile_call(dev, kernel, lh, lw, batch):
    """A launch of ``kernel`` over ``batch`` levels of (lh, lw) (the lo
    level of a chain step, cropped by one texel each way), as a call."""
    lead = (batch,) if batch > 1 else ()
    z = uniform(dev, lead + (lh, lw), 0.05, 1.0, 40)
    w_full = 4 * lw
    if kernel == "render_ao_level":
        return lambda: K.render_ao_level(z, 1, w_full, CAM, AOParams())
    if kernel == "render_ao_level_normals":
        g = uniform(dev, lead + (lh, lw), -0.02, 0.02, 41)
        pn = AOParams(use_normals=True)
        return lambda: K.render_ao_level_normals(z, 1, w_full, CAM, pn,
                                                 slopes_ds=(g, g))
    c = uniform(dev, lead + (lh, lw), 0.3, 1.0, 42)
    hi = uniform(dev, lead + (2 * lh, 2 * lw), 0.05, 1.0, 43)
    crop = (2 * lh - 1, 2 * lw - 1)
    if kernel == "blur_upsample_step":
        return lambda: K.blur_upsample_step(c, z, hi, AOParams(), w_full,
                                            lo_ao2=c, crop_hw=crop)
    return lambda: K.fused_render_upsample_step(z, c, hi, 1, w_full, CAM,
                                                AOParams(), crop_hw=crop)


TILE_CASES = [(kernel, nt) for kernel, nts in
              {"render_ao_level": (4, 2, 1),
               "render_ao_level_normals": (1,),
               "blur_upsample_step": (3, 2, 1),
               "fused_render_upsample_step": (3, 2, 1)}.items()
              for nt in nts]


@pytest.mark.parametrize("kernel,nt", TILE_CASES)
def test_every_tile_rows_instance_bit_equal_to_the_rule(dev, kernel, nt):
    """Each kernel at each texels-a-thread instance (``launch_opts``),
    forced through the table, equals its output at the rule's instance
    bit for bit: at level 1 of 1080p (544 x 960) and at an odd 37 x 50
    level, one frame and three; the table's entry is exactly the launch's
    key."""
    from tpuao_torch.utils import launch_opts as L

    L.clear_tuned_tiles()
    try:
        for lh, lw, batch in ((544, 960, 1), (37, 50, 1), (37, 50, 3)):
            call = _tile_call(dev, kernel, lh, lw, batch)
            want = call()
            L.set_tuned_tiles(kernel, batch, lh, lw, nt)
            assert L.tile_rows(kernel, batch, lh, lw) == nt
            close(call(), want, 0.0)
            L.clear_tuned_tiles()
    finally:
        L.clear_tuned_tiles()


@pytest.mark.parametrize("kernel,bad", [
    ("render_ao_level", 3), ("render_ao_level", 5),
    ("render_ao_level_normals", 2), ("blur_upsample_step", 4),
    ("fused_render_upsample_step", 4), ("fused_render_upsample_step", -1),
    ("render_ao_level", 0), ("render_ao_level_normals", 0),
    ("blur_upsample_step", 0), ("fused_render_upsample_step", 0)])
def test_a_tile_rows_value_with_no_instance_raises(dev, kernel, bad,
                                                    monkeypatch):
    """The table refuses a value the kernel has no instance for, and the
    launcher refuses one that gets past it (cudaErrorInvalidValue): no
    launch falls back to a rule.  0 is no entry to the table (the launch
    takes the rule), so it goes to the C entry point directly, with the
    arguments the wrapper passes."""
    from tpuao_torch.ops import _build
    from tpuao_torch.utils import launch_opts as L

    call = _tile_call(dev, kernel, 37, 50, 1)
    with pytest.raises(ValueError, match="no instance"):
        L.set_tuned_tiles(kernel, 1, 37, 50, bad)
    if bad == 0:
        launched = []
        monkeypatch.setattr(K, "_launch",
                            lambda entry, *args: launched.append((entry,
                                                                  args)))
        kept = call()  # keeps the output's memory while the entry runs
        [(entry, args)] = launched
        assert args[-3] == L.rule_nt(kernel, 1, 37, 50, 73, 99) != 0
        lib = _build.load()
        assert getattr(lib, entry)(*args[:-3], 0, *args[-2:]) == 1  # Invalid
        torch.cuda.synchronize()
        del kept
        return
    L._TUNED[(kernel, 1, 37, 50)] = bad
    try:
        with pytest.raises(RuntimeError, match="CUDA error"):
            call()
    finally:
        L.clear_tuned_tiles()


def test_launch_census_and_stage_times_read_the_device(dev):
    """``roofline.launch_census`` finds the HIGH frame's AO kernels by
    name with their device time (the profiler may drop records on a busy
    host, so at most, not exactly, 5 calls' launches), and
    ``profiling.stage_times_ms`` times every stage by graph replay."""
    from tpuao_torch.utils.profiling import stage_times_ms
    from tpuao_torch.utils.roofline import launch_census

    z = torch.as_tensor(F.spheres_on_plane(270, 480, CAM, seed=5),
                        dtype=torch.float32, device=dev)
    census = launch_census(lambda: render_frame(z, CAM), calls=5)
    for prefix, per_call in (("::render_kernel<", 1),
                             ("::upsample_kernel<", 1),
                             ("::fused_step_kernel<", 3)):
        got = [v for k, v in census.items() if prefix in k]
        assert got, (prefix, sorted(census))
        n = sum(c for c, _ in got)
        assert 0 < n <= 5 * per_call
        assert all(ms > 0 for _, ms in got)
    st = stage_times_ms(z, CAM, preset("ULTRA"),
                        normals=torch.as_tensor(F.spheres_on_plane(
                            270, 480, CAM, seed=5, with_normals=True)[1],
                            dtype=torch.float32, device=dev))
    assert list(st)[0] == "prepare" and list(st)[-1] == "full_pipeline"
    assert len(st) == 10 and all(ms > 0 for ms in st.values())


@pytest.fixture
def eager_frames():
    """An empty graph cache: the next call of every frame shape runs the
    eager path, the one after captures it (``models/frame_graph``)."""
    from tpuao_torch.models import frame_graph

    frame_graph._clear()
    yield
    frame_graph._clear()


@pytest.mark.parametrize("case", ["HIGH", "HIGH_pallas", "ULTRA", "rig"])
def test_trace_launch_spans_equal_the_launch_counts(dev, case, eager_frames):
    """Each stage span's ``ao_launch`` children are the launches its
    wrapper counted, and tracing does not change a bit of the output."""
    from tpuao_torch.parallel.sharding import render_views_sharded
    from tpuao_torch.utils import trace

    d, n = normals_scene(dev, batch=8 if case == "rig" else 2)
    par = preset("ULTRA" if case == "ULTRA" else "HIGH")
    impl = "pallas" if case == "HIGH_pallas" else "auto"
    n = n if case == "ULTRA" else None

    def run():
        if case == "rig":
            return render_views_sharded(d, CAM, par, impl=impl)
        return render_frame(d, CAM, par, normals=n, impl=impl)

    off = run()
    K.reset_launch_counts()
    trace.enable()
    try:
        on = run()
    finally:
        trace.disable()
        rec = trace.take()
    assert torch.equal(on, off) and rec["dropped"] == 0
    spans = rec["spans"]
    by_stage: dict[str, int] = {}
    for r in spans:
        if r.name == "ao_launch":
            stage = spans[r.parent].name.rstrip("0123456789")
            by_stage[stage] = by_stage.get(stage, 0) + 1
    got = K.launch_counts()
    assert by_stage == {k: v for k, v in {
        "ao_prepare": got["prepare_levels"],
        "ao_render_l": (got["render_ao_level"]
                        + got["render_ao_level_normals"]),
        "ao_upsample_l": got["blur_upsample_step"],
        "ao_fused_l": got["fused_render_upsample_step"]}.items() if v}
    assert sum(by_stage.values()) == sum(got.values()) == {
        "HIGH": 6, "HIGH_pallas": 9, "ULTRA": 9, "rig": 6}[case]


# ---------------------------------------------------------------------------
# render_frame's CUDA graphs (models/frame_graph): bit-equal to the eager
# path, fresh outputs, two streams on one key, the launch counts
# ---------------------------------------------------------------------------


def graph_sides(replays, inputs=True, output=True) -> dict:
    """``frame_graph.graph_counts``'s sides of ``replays`` replays that
    each bound (else copied) the inputs and bound (else cloned) the
    output."""
    return {"bound": replays * (inputs and output),
            "inputs_bound": replays * inputs,
            "inputs_copied": replays * (not inputs),
            "output_bound": replays * output,
            "output_cloned": replays * (not output)}


def graph_against_eager(call, launches=None, sides=(True, True)):
    """``call()`` three times on an empty cache: eager (first sight),
    captured and replayed, then replayed; both replays bit-equal to the
    eager output, each call's launch counts ``launches`` where given, and
    the replays bound the sides ``sides`` (inputs, output) to the call's
    buffers.  Returns the eager output."""
    from tpuao_torch.models import frame_graph as G

    G._clear()
    outs = []
    for _ in range(3):
        K.reset_launch_counts()
        outs.append(call())
        if launches is not None:
            assert K.launch_counts() == launches
    torch.cuda.synchronize()
    assert G.graph_counts() == {
        "captures": 1, "replays": 2, **graph_sides(2, *sides),
        "eager": {**dict.fromkeys(G.REASONS, 0), "first_sight": 1}}
    for got in outs[1:]:
        assert got.dtype == outs[0].dtype and torch.equal(got, outs[0])
        assert got.data_ptr() != outs[0].data_ptr()
    assert outs[1].data_ptr() != outs[2].data_ptr()  # a fresh output
    return outs[0]


HIGH_LAUNCHES = dict(prepare_levels=1, render_ao_level=1,
                     blur_upsample_step=1, fused_render_upsample_step=3)


@pytest.mark.parametrize("batch", [None, 8])
def test_graph_high_1080p_bit_equal_to_eager(dev, batch, eager_frames):
    z = torch.as_tensor(F.spheres_on_plane(1080, 1920, CAM, seed=4),
                        dtype=torch.float32, device=dev)
    if batch is not None:  # eight distinct views
        z = torch.stack([torch.roll(z, 61 * i, dims=-1)
                         for i in range(batch)])
    graph_against_eager(lambda: render_frame(z, CAM, preset("HIGH")),
                        counts(**HIGH_LAUNCHES))


def test_graph_ultra_4k_channel_last_normals_bit_equal_to_eager(
        dev, eager_frames):
    z, n = normals_scene(dev, 2160, 3840, seed=5)
    assert n.shape == (2160, 3840, 3)
    graph_against_eager(
        lambda: render_frame(z, CAM, preset("ULTRA"), normals=n),
        counts(prepare_levels=1, render_ao_level_normals=4,
               blur_upsample_step=4))


def test_graph_colour_uint8_bit_equal_to_eager(dev, eager_frames):
    z = torch.as_tensor(F.spheres_on_plane(270, 480, CAM, seed=6),
                        dtype=torch.float32, device=dev)
    rgb = torch.randint(0, 256, (270, 480, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(6)).to(dev)
    out = graph_against_eager(lambda: render_frame(
        z, CAM, preset("HIGH"), color=rgb, out_dtype="uint8"))
    assert out.dtype == torch.uint8 and out.shape == (270, 480, 3)
    graph_against_eager(lambda: render_frame(z, CAM, out_dtype="uint8"))


def test_graph_replays_the_new_frame_not_the_old(dev, eager_frames):
    """A frame of the key's shape after a replay gets its own AO, and the
    output an earlier call holds is not overwritten."""
    z1, z2 = (torch.as_tensor(F.spheres_on_plane(540, 960, CAM, seed=s),
                              dtype=torch.float32, device=dev)
              for s in (7, 8))
    want1 = render_frame(z1, CAM)  # eager
    got1 = render_frame(z1, CAM)  # captured and replayed
    got2 = render_frame(z2, CAM)  # replayed on the new frame
    want2 = render_frame(z2, CAM, debug_outputs=True)[0]  # eager
    torch.cuda.synchronize()
    assert torch.equal(got1, want1) and torch.equal(got2, want2)
    assert not torch.equal(got1, got2)


def test_graph_two_threads_on_two_streams_share_one_key(dev, eager_frames):
    """Two threads, each on a stream of its own, replay one key 20 times
    without a synchronise; every output is its own frame's."""
    import threading

    from tpuao_torch.models import frame_graph as G

    zs = [torch.as_tensor(F.spheres_on_plane(540, 960, CAM, seed=s),
                          dtype=torch.float32, device=dev) for s in (9, 10)]
    want = [render_frame(z, CAM, debug_outputs=True)[0] for z in zs]
    render_frame(zs[0], CAM)
    render_frame(zs[0], CAM)  # captured
    torch.cuda.synchronize()
    outs, errors = [[], []], []
    start = threading.Barrier(2)

    def work(i):
        try:
            stream = torch.cuda.Stream(dev)
            start.wait(timeout=60)
            with torch.cuda.stream(stream):
                for _ in range(20):
                    outs[i].append(render_frame(zs[i], CAM))
            stream.synchronize()
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    torch.cuda.synchronize()
    for i in (0, 1):
        assert len(outs[i]) == 20
        assert all(torch.equal(o, want[i]) for o in outs[i])
    assert G.graph_counts()["captures"] == 1
    assert G.graph_counts()["replays"] == 41


def test_graph_replay_adds_the_captured_launch_counts(dev, eager_frames):
    """Each replay adds the launches its capture made, once: the counts
    keep meaning kernels the card ran (the capture itself runs none).
    The card's own kernel records of the replays (torch.profiler) name
    the same kernels; it may drop records on a busy host, so at most,
    not exactly, 5 replays' worth."""
    from tpuao_torch.parallel.sharding import render_views_sharded
    from tpuao_torch.utils.roofline import census_by_wrapper, launch_census

    z, n = normals_scene(dev, batch=2)
    for call, want in (
            (lambda: render_frame(z, CAM, preset("HIGH")), HIGH_LAUNCHES),
            (lambda: render_frame(z, CAM, preset("ULTRA"), normals=n,
                                  impl="pallas"),
             dict(prepare_levels=1, render_ao_level_normals=4,
                  blur_upsample_step=4)),
            (lambda: render_views_sharded(z, CAM, preset("HIGH")),
             HIGH_LAUNCHES)):
        # "pallas" reads the raw normals with PyTorch ops: copied in
        graph_against_eager(call, counts(**want),
                            (want is HIGH_LAUNCHES, True))
        K.reset_launch_counts()
        census = census_by_wrapper(launch_census(call, calls=5))
        assert K.launch_counts() == counts(**{k: 6 * v
                                              for k, v in want.items()})
        assert set(census) == set(want), census
        assert all(0 < census[k] <= 5 * v for k, v in want.items()), census
    K.reset_launch_counts()
    render_frame(z, CAM, preset("ULTRA"), normals=n, impl="pallas")
    assert K.render_ao_level_normals.raw_launches == 4


def test_graph_capture_leaves_another_threads_launches_counted(
        dev, eager_frames):
    """While one thread captures a frame's graph, another launches eager
    frames on a stream of its own: the counts hold every launch of the
    other thread once, and the capturing thread's as the card ran them
    (eager, then two replays), none taken off or added twice."""
    import threading

    z = torch.as_tensor(F.spheres_on_plane(540, 960, CAM, seed=11),
                        dtype=torch.float32, device=dev)
    zb = torch.as_tensor(F.spheres_on_plane(270, 480, CAM, seed=12),
                         dtype=torch.float32, device=dev)
    K.reset_launch_counts()
    render_frame(zb, CAM, debug_outputs=True)  # build, warm, count
    torch.cuda.synchronize()
    per_other = K.launch_counts()  # the debug path renders every level
    K.reset_launch_counts()
    stop, started, done = threading.Event(), threading.Event(), []

    def other():
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            while not stop.is_set():
                render_frame(zb, CAM, debug_outputs=True)  # eager
                done.append(1)
                started.set()
        torch.cuda.synchronize()

    t = threading.Thread(target=other)
    t.start()
    try:
        assert started.wait(timeout=60)
        outs = [render_frame(z, CAM) for _ in range(3)]  # capture in #2
    finally:
        stop.set()
        t.join(timeout=120)
    assert not t.is_alive()
    torch.cuda.synchronize()
    assert torch.equal(outs[1], outs[0]) and torch.equal(outs[2], outs[0])
    assert K.launch_counts() == {
        k: 3 * HIGH_LAUNCHES.get(k, 0) + len(done) * n
        for k, n in per_other.items()}


# ---------------------------------------------------------------------------
# a replay on the caller's own buffers (frame_graph's binding,
# csrc/graph_bind.cu): the prologue reads the call's depth and normals in
# place and the last chain step writes the call's fresh output
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["high_1080p", "high_1080p_x8_slice",
                                  "ultra_4k_channel_last",
                                  "ultra_4k_channel_first"])
def test_graph_binds_the_callers_buffers(dev, case, eager_frames):
    """The main paths' replays copy nothing in and clone nothing out, and
    stay bit-equal to the eager path: 1080p HIGH alone and as 8 views
    sliced from a larger pool (as a capture rig passes them), 4K ULTRA
    with channel-last and channel-first normals."""
    if case.startswith("high"):
        pool = torch.as_tensor(np.stack([
            F.spheres_on_plane(1080, 1920, CAM, seed=s) for s in range(12)]),
            dtype=torch.float32, device=dev)
        z = pool[2:10] if case.endswith("slice") else pool[3]
        graph_against_eager(lambda: render_frame(z, CAM, preset("HIGH")),
                            counts(**HIGH_LAUNCHES))
        return
    z, n = normals_scene(dev, 2160, 3840, seed=5)
    if case.endswith("first"):
        n = n.permute(2, 0, 1).contiguous()
    graph_against_eager(
        lambda: render_frame(z, CAM, preset("ULTRA"), normals=n),
        counts(prepare_levels=1, render_ao_level_normals=4,
               blur_upsample_step=4))


def test_graph_a_misaligned_view_has_a_graph_of_its_own(dev, eager_frames):
    """A depth 4 bytes into its buffer takes no 16-byte loads: it gets a
    key and a graph of its own, bound to it, bit-equal; the aligned
    graph's binding refuses it."""
    from tpuao_torch.models import frame_graph as G

    h, w = 540, 960
    base = torch.as_tensor(F.spheres_on_plane(h, w, CAM, seed=13),
                           dtype=torch.float32, device=dev)
    buf = torch.empty(h * w + 4, device=dev)
    buf[1:1 + h * w] = base.flatten()
    odd = buf[1:1 + h * w].view(h, w)
    assert odd.data_ptr() % 16 == 4
    want = render_frame(base, CAM, debug_outputs=True)[0]
    for z in (base, base, odd, odd, odd):
        assert torch.equal(render_frame(z, CAM), want)
    torch.cuda.synchronize()
    counts_ = G.graph_counts()
    assert counts_["captures"] == 2 and counts_["replays"] == 3
    assert counts_["bound"] == 3
    assert len(G._entries) == 2
    aligned = G._entries[G._key(base, None, CAM, AOParams(), "auto")]
    out = torch.empty_like(base)
    assert aligned.bind(odd, None, out) == 1  # cudaErrorInvalidValue
    assert aligned.bind(base, None, out) == 0


def test_graph_outputs_held_across_calls_stay_their_own(dev, eager_frames):
    """Two outputs of one key, held while the next call replays on a
    different depth: each is its own frame, neither overwritten."""
    from tpuao_torch.models import frame_graph as G

    zs = [torch.as_tensor(F.spheres_on_plane(1080, 1920, CAM, seed=s),
                          dtype=torch.float32, device=dev) for s in (14, 15)]
    want = [render_frame(z, CAM, debug_outputs=True)[0] for z in zs]
    render_frame(zs[0], CAM)
    held = [render_frame(z, CAM) for z in zs * 2]  # captured, replays
    torch.cuda.synchronize()
    for i, out in enumerate(held):
        assert torch.equal(out, want[i % 2])
    assert len({o.data_ptr() for o in held}) == 4
    assert G.graph_counts()["bound"] == G.graph_counts()["replays"] == 4


def test_graph_the_callers_depth_freed_right_after_the_call(dev,
                                                            eager_frames):
    """A depth freed as the call returns, its memory at once taken and
    overwritten by the caller on the same stream: the replay read it
    before, so every output is its frame's."""
    from tpuao_torch.models import frame_graph as G

    base = torch.as_tensor(F.spheres_on_plane(540, 960, CAM, seed=16),
                           dtype=torch.float32, device=dev)
    shifts = [0, 0, 37, 101, 203, 307]
    want = [render_frame(torch.roll(base, k, dims=-1), CAM,
                         debug_outputs=True)[0] for k in shifts]
    outs = []
    for k in shifts:
        z = torch.roll(base, k, dims=-1)
        outs.append(render_frame(z, CAM))
        del z
        junk = torch.empty_like(base)  # the freed block, on this stream
        junk.fill_(float("nan"))
        del junk
    torch.cuda.synchronize()
    for got, w in zip(outs, want):
        assert torch.equal(got, w)
    assert G.graph_counts()["bound"] == len(shifts) - 1


def test_graph_two_threads_bind_their_own_buffers(dev, eager_frames):
    """Two threads, each on a stream of its own, replay one key with
    depths of their own, a fresh one each call, without a synchronise:
    every output is its call's frame and every replay bound."""
    import threading

    from tpuao_torch.models import frame_graph as G

    base = torch.as_tensor(F.spheres_on_plane(540, 960, CAM, seed=17),
                           dtype=torch.float32, device=dev)
    shifts = [[11 * j for j in range(8)], [13 * j + 5 for j in range(8)]]
    want = [[render_frame(torch.roll(base, k, dims=-1), CAM,
                          debug_outputs=True)[0] for k in ks]
            for ks in shifts]
    render_frame(base, CAM)
    render_frame(base, CAM)  # captured
    torch.cuda.synchronize()
    outs, errors = [[], []], []
    start = threading.Barrier(2)

    def work(i):
        try:
            stream = torch.cuda.Stream(dev)
            start.wait(timeout=60)
            with torch.cuda.stream(stream):
                for _ in range(3):
                    for k in shifts[i]:
                        outs[i].append(render_frame(
                            torch.roll(base, k, dims=-1), CAM))
            stream.synchronize()
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    torch.cuda.synchronize()
    for i in (0, 1):
        assert len(outs[i]) == 24
        for j, out in enumerate(outs[i]):
            assert torch.equal(out, want[i][j % 8])
    counts_ = G.graph_counts()
    assert counts_["captures"] == 1 and counts_["replays"] == 49
    assert counts_["bound"] == 49


def test_sixteen_k_frame_on_eight_sections(dev):
    """The 16K-class frame (8640 x 15360) on 8 sections through
    ``engine.render_sections``, HIGH ``auto``, reversed-Z hardware depth:
    the same bits with tracing on and off, within 1e-3 of the float64
    golden, and 13,120 rows rendered to keep 8,640 (1408, 6 x 1728 and
    1344 rows)."""
    from tpuao_torch.golden import render_frame_golden
    from tpuao_torch.models.pipeline import AmbientOcclusionEngine
    from tpuao_torch.parallel import sections as SC
    from tpuao_torch.utils import trace

    cam = CameraParams(reversed_z=True, depth_mode="hardware")
    z = torch.as_tensor(F.to_hardware_depth(F.spheres_on_plane(
        8640, 15360, cam, seed=24), cam), dtype=torch.float32, device=dev)
    eng = AmbientOcclusionEngine(cam, device=dev)
    SC._clear()
    off = eng.render_sections(z, 8)
    trace.enable()
    try:
        on = eng.render_sections(z, 8)
    finally:
        trace.disable()
        spans = trace.take()["spans"]
    torch.cuda.synchronize()
    assert torch.equal(on, off)
    del on
    assert [r.name for r in spans].count("ao_section") == 8
    assert spans[0].name == "ao_entry.render_sections"
    counts_ = SC.section_counts()
    SC._clear()
    assert counts_["sections"] == 16
    assert counts_["rows_rendered"] == 2 * 13_120
    assert counts_["rows_kept"] == 2 * 8_640
    want = render_frame_golden(z, cam, AOParams(), device=dev)
    err = float((off.double() - want).abs().max())
    print(f"16K on 8 sections vs the float64 golden {err:.3e}")
    assert err <= 1e-3

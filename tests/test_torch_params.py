"""tpuao_torch.params and tpuao_torch.utils.fixtures against tpuao's.

The port cannot import ``tpuao`` (``tpuao.params`` imports flax, and so
jax), so it carries NumPy-level copies of the pair table, the constants,
the parameter ranges and the scene fixtures.  These tests hold every copy
equal to the JAX package's, and check that importing the port loads no JAX.
"""

import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpuao.params as JP
from tpuao import render_frame as jax_render_frame
from tpuao.ops.render import _pair_constants as jax_pair_constants
from tpuao.utils import fixtures as JF

import tpuao_torch.params as TP
from tpuao_torch import render_frame
from tpuao_torch.ops import kernels as K
from tpuao_torch.utils import fixtures as TF

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so these tests do not crowd the
    CPU that the suite's other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("exhaustive", [True, False])
def test_pair_table_equal(exhaustive):
    jo, jw = JP.build_pair_table(exhaustive)
    to, tw = TP.build_pair_table(exhaustive)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tw, jw)
    assert to.dtype == jo.dtype and tw.dtype == jw.dtype


def test_disc_tables_equal():
    assert TP.SAMPLE_OFFSETS == JP.SAMPLE_OFFSETS
    assert TP.SPARSE_ENTRY_INDICES == JP.SPARSE_ENTRY_INDICES
    np.testing.assert_array_equal(TP.SAMPLE_THICKNESS, JP.SAMPLE_THICKNESS)
    np.testing.assert_array_equal(TP.TAP_MULTIPLICITY, JP.TAP_MULTIPLICITY)
    for i in range(TP.N_ENTRIES):
        assert TP.entry_pairs(i) == JP.entry_pairs(i)


def test_param_ranges_and_pad_multiple_equal():
    assert TP.PARAM_RANGES == JP.PARAM_RANGES
    assert TP.PAD_MULTIPLE == JP.PAD_MULTIPLE


@pytest.mark.parametrize("hw", [(1, 1), (64, 64), (100, 150), (1080, 1920),
                                (2160, 3840), (65, 127)])
def test_padded_shape_equal(hw):
    assert TP.padded_shape(*hw) == JP.padded_shape(*hw)


@pytest.mark.parametrize("level", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("width", [192, 1920, 3840])
def test_sphere_radius_coef_equal(level, width):
    for tanh, diam in ((0.57735, 10.0), (1.2, 6.0)):
        assert (TP.sphere_radius_coef(level, width, tanh, diam)
                == JP.sphere_radius_coef(level, width, tanh, diam))


@pytest.mark.parametrize("tun", [
    {},
    {"blur_tolerance": -1.0, "upsample_tolerance": -12.0,
     "noise_filter_tolerance": 0.0},
    # k_blur hits its 1e-30 floor: blur_tolerance = log10(1/step_size)
    {"blur_tolerance": -float(np.log10(16.0))},
])
def test_upsample_constants_equal(tun):
    gp = JP.GoldenAOParams(**tun)
    tp = TP.AOParams(**tun)
    for lo_w in (120, 240, 480, 960):
        assert (TP.upsample_constants(tp, 1920, lo_w)
                == JP.upsample_constants(gp, 1920, lo_w))


@pytest.mark.parametrize("pair", [("AOParams", "AOParams"),
                                  ("CameraParams", "CameraParams")])
def test_param_fields_and_defaults_equal(pair):
    jcls, tcls = getattr(JP, pair[0]), getattr(TP, pair[1])
    jf = [(f.name, f.default) for f in dataclasses.fields(jcls)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcls)]
    assert tf == jf


@pytest.mark.parametrize("bad", [
    {"strength": 0.0}, {"strength": 11.0}, {"rejection_falloff": 0.5},
    {"blur_tolerance": 0.0}, {"upsample_tolerance": -13.0},
    {"noise_filter_tolerance": 1.0}, {"hierarchy_depth": 5},
    {"hierarchy_depth": 0},
])
def test_aoparams_validate_rejects_like_jax(bad):
    with pytest.raises(ValueError):
        JP.AOParams(**bad).validate()
    with pytest.raises(ValueError):
        TP.AOParams(**bad).validate()


@pytest.mark.parametrize("bad", [
    {"near": 0.0}, {"near": 1.0, "far": 0.5}, {"tan_half_fov_h": 0.0},
    {"tan_half_fov_h": float("inf")}, {"depth_mode": "log"},
])
def test_cameraparams_validate_rejects_like_jax(bad):
    with pytest.raises(ValueError):
        JP.CameraParams(**bad).validate()
    with pytest.raises(ValueError):
        TP.CameraParams(**bad).validate()


def test_params_frozen_and_replace():
    p = TP.AOParams()
    q = p.replace(strength=2.0, hierarchy_depth=2)
    assert (q.strength, q.hierarchy_depth) == (2.0, 2)
    assert p.strength == 1.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.strength = 3.0
    assert TP.CameraParams().replace(near=0.5).near == 0.5


def test_load_config_reads_tpuao_save_config(tmp_path):
    ja = JP.AOParams(strength=2.0, rejection_falloff=4.0, hierarchy_depth=3)
    jc = JP.CameraParams(near=0.5, far=50.0, depth_mode="linear")
    path = JP.save_config(str(tmp_path / "cfg.json"), ja, jc)
    ta, tc = TP.load_config(path)
    assert TP.params_to_dict(ta) == JP.params_to_dict(ja)
    assert TP.params_to_dict(tc) == JP.params_to_dict(jc)
    d = json.loads(Path(path).read_text())
    d["ao"]["bogus"] = 1
    with pytest.raises(ValueError, match="unknown AOParams fields"):
        TP.params_from_dict(TP.AOParams, d["ao"])


def test_from_tpuao_gives_the_same_frame():
    ja = JP.AOParams(strength=2.0, rejection_falloff=4.0,
                     blur_tolerance=-4.0, hierarchy_depth=3)
    jc = JP.CameraParams(near=0.2, far=80.0, tan_half_fov_h=0.7,
                         reversed_z=False)
    ta, tc = TP.from_tpuao(JP.params_to_dict(ja), JP.params_to_dict(jc))
    assert isinstance(ta, TP.AOParams) and isinstance(tc, TP.CameraParams)
    z = JF.spheres_on_plane(64, 128, n_spheres=3, seed=5, backend="numpy")
    hw = JF.to_hardware_depth(z, JP.GoldenCameraParams(
        near=0.2, far=80.0, reversed_z=False)).astype(np.float32)
    want = np.asarray(jax_render_frame(hw, jc, ja, impl="jnp"))
    got = render_frame(hw, tc, ta, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_from_tpuao_validates():
    d = JP.params_to_dict(JP.AOParams())
    d["strength"] = 50.0
    with pytest.raises(ValueError):
        TP.from_tpuao(d, JP.params_to_dict(JP.CameraParams()))


@pytest.mark.parametrize("seed", [0, 7])
def test_spheres_on_plane_equal(seed):
    cam_j = JP.GoldenCameraParams(depth_mode="linear", tan_half_fov_h=0.8)
    cam_t = TP.CameraParams(depth_mode="linear", tan_half_fov_h=0.8)
    zj, nj = JF.spheres_on_plane(48, 80, cam_j, n_spheres=4, seed=seed,
                                 with_normals=True, backend="numpy",
                                 eye=(0.1, 0.0, -0.5))
    zt, nt = TF.spheres_on_plane(48, 80, cam_t, n_spheres=4, seed=seed,
                                 with_normals=True, eye=(0.1, 0.0, -0.5))
    np.testing.assert_array_equal(zt, zj)
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_array_equal(
        TF.spheres_on_plane(48, 80, seed=seed),
        JF.spheres_on_plane(48, 80, seed=seed, backend="numpy"))


def test_simple_fixtures_equal():
    np.testing.assert_array_equal(TF.flat_plane(8, 12, 0.4),
                                  JF.flat_plane(8, 12, 0.4))
    for axis in (0, 1):
        np.testing.assert_array_equal(TF.step_edge(8, 12, axis=axis),
                                      JF.step_edge(8, 12, axis=axis))
    np.testing.assert_array_equal(TF.corner(8, 12), JF.corner(8, 12))
    for s in (0, 3):
        for a, b in zip(TF.sphere_scene_params(4, s),
                        JF.sphere_scene_params(4, s)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("reversed_z", [True, False])
def test_to_hardware_depth_equal(reversed_z):
    z = np.linspace(1e-4, 1.0, 50).reshape(5, 10)
    jc = JP.GoldenCameraParams(reversed_z=reversed_z)
    tc = TP.CameraParams(reversed_z=reversed_z)
    np.testing.assert_array_equal(TF.to_hardware_depth(z, tc),
                                  JF.to_hardware_depth(z, jc))


def test_import_loads_no_jax():
    """Importing the port in a fresh interpreter loads no jax, flax,
    optax or tpuao module (the card machine has no jax)."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import tpuao_torch, tpuao_torch.models.pipeline\n"
        "import tpuao_torch.ops.kernels, tpuao_torch.ops._build\n"
        "import tpuao_torch.utils.fixtures, tpuao_torch.utils.timing\n"
        "import tpuao_torch.ops.temporal, tpuao_torch.models.presets\n"
        "import tpuao_torch.utils.camera\n"
        "import tpuao_torch.serving, tpuao_torch.client\n"
        "import tpuao_torch.utils.frameio, tpuao_torch.utils.native\n"
        "import tpuao_torch.utils.batching, tpuao_torch.utils.resilience\n"
        "import tpuao_torch.utils.io, tpuao_torch.parallel.sharding\n"
        "import tpuao_torch.cli, tpuao_torch.utils.debug_dump, runpy\n"
        "import tpuao_torch.models.autodiff\n"
        "import tpuao_torch.parallel.spatial, tpuao_torch.parallel.grid\n"
        "import tpuao_torch.parallel.sections\n"
        "import tpuao_torch.golden, tpuao_torch.golden.temporal\n"
        "import tpuao_torch.utils.roofline, tpuao_torch.utils.launch_opts\n"
        "import tpuao_torch.utils.autotune, tpuao_torch.utils.profiling\n"
        "sys.argv = ['tpuao_torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('tpuao_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'tpuao'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_numpy_input_defaults_to_cpu():
    """NumPy input runs on the CPU when the caller asks for it, and a CPU
    tensor stays there whatever ``device`` says (the default device is
    the card: ``test_numpy_input_defaults_to_the_card``)."""
    z = TF.spheres_on_plane(64, 64, seed=1)
    cam = TP.CameraParams(depth_mode="linear")
    out = render_frame(z, cam, device="cpu")
    assert isinstance(out, torch.Tensor)
    assert out.device == torch.device("cpu") and out.dtype == torch.float32
    assert render_frame(torch.as_tensor(z), cam).device == out.device


def test_numpy_input_defaults_to_the_card():
    """Every entry point puts NumPy input on the card unless ``device=``
    says otherwise; with no card it raises, naming the device and the
    ``device="cpu"`` escape, and never runs on the CPU unasked."""
    from tpuao_torch import serving as S
    from tpuao_torch.models.pipeline import (AmbientOcclusionEngine,
                                             TemporalAOEngine,
                                             render_frame_temporal,
                                             render_sequence_temporal,
                                             single_scale_ao)
    from tpuao_torch.parallel.sharding import render_views

    z = TF.spheres_on_plane(32, 48, seed=1)
    cam = TP.CameraParams(depth_mode="linear")
    calls = {
        "render_frame": lambda: render_frame(z, cam),
        "single_scale_ao": lambda: single_scale_ao(z, cam),
        "AmbientOcclusionEngine": lambda: AmbientOcclusionEngine(cam).render(
            z),
        "TemporalAOEngine": lambda: TemporalAOEngine(cam).render(z),
        "render_frame_temporal": lambda: render_frame_temporal(z, None,
                                                               cam)[0],
        "render_sequence_temporal": lambda: render_sequence_temporal(
            np.stack([z, z]), cam),
        "render_views": lambda: render_views(np.stack([z, z]), cam),
    }
    assert S.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        for name, call in calls.items():
            assert call().device.type == "cuda", name
        srv = S.make_server(0)
        try:
            assert srv.device.type == "cuda"
        finally:
            srv.server_close()
        return
    for name, call in list(calls.items()) + [
            ("make_server", lambda: S.make_server(0))]:
        with pytest.raises(RuntimeError,
                           match='device cuda: no CUDA device.*device="cpu"'):
            call()


# The compile-time pair offsets of the CUDA kernels: csrc/common.cuh spells
# the (dx, dy) of the exhaustive and sparse tables out as constexpr arrays,
# which the tiled kernels (render.cu, fused.cu) read at compile time; the
# host table the wrappers pass (ops/kernels.pair_table) still carries them
# and the kernels refuse one that differs.  These tests parse the arrays
# out of the source and hold them equal to pair_table and to the JAX
# package's _pair_constants, so the two cannot drift.

COMMON = (Path(__file__).resolve().parent.parent / "tpuao_torch" / "csrc" /
          "common.cuh")


def constexpr_table(name: str) -> list[tuple[int, int]]:
    """The ``constexpr int <name>[N][2] = {...};`` array of common.cuh as
    a list of (dx, dy), checked against its declared length N."""
    src = COMMON.read_text()
    m = re.search(r"constexpr\s+int\s+" + name +
                  r"\s*\[\s*(\d+)\s*\]\s*\[\s*2\s*\]\s*=\s*\{(.*?)\};", src,
                  re.S)
    assert m, f"{name} not found in {COMMON}"
    pairs = [(int(a), int(b)) for a, b in
             re.findall(r"\{\s*(-?\d+)\s*,\s*(-?\d+)\s*\}", m.group(2))]
    assert len(pairs) == int(m.group(1))
    return pairs


@pytest.mark.parametrize("exhaustive,name,n", [
    (True, "kExhaustivePairs", 34), (False, "kSparsePairs", 10)])
def test_constexpr_offsets_equal_the_pair_tables(exhaustive, name, n):
    offsets = constexpr_table(name)
    assert len(offsets) == n
    for radius_coef in (0.5, 3.0):  # the offsets do not depend on the level
        table = K.pair_table(exhaustive, radius_coef)
        assert list(zip(table["dx"].tolist(), table["dy"].tolist())) == \
            offsets
    jax = [(dx, dy) for dx, dy, _, _ in
           jax_pair_constants(JP.AOParams(exhaustive=exhaustive))]
    assert jax == offsets


def test_the_sparse_offsets_are_a_subset_and_taps_stay_in_the_halo():
    dense = set(constexpr_table("kExhaustivePairs"))
    sparse = constexpr_table("kSparsePairs")
    assert set(sparse) <= dense
    assert len(set(sparse)) == len(sparse) and len(dense) == 34
    # every tap (and its mirror) within the 16-texel halo the kernels stage
    for dx, dy in dense:
        assert max(abs(dx), abs(dy)) <= 16 and dx % 4 == 0 and dy % 4 == 0
        assert (-dx, -dy) not in dense  # one entry per mirrored pair


def test_pair_table_layout_matches_the_kernels_struct():
    # tpuao::Pair is {int dx; int dy; float inv_r; float half_w;}
    table = K.pair_table(True, 1.0)
    assert table.dtype.itemsize == 16
    assert [table.dtype.fields[f][1] for f in ("dx", "dy", "inv_r",
                                               "half_w")] == [0, 4, 8, 12]
    assert table.dtype["dx"] == np.int32 and table.dtype["inv_r"] == \
        np.float32
    assert not table.flags.writeable
    # the plain version's constants: the same (dx, dy) in the same order
    plain = [(dx, dy) for dx, dy, _, _ in
             K.R._pair_constants(TP.AOParams(exhaustive=True))]
    assert plain == list(zip(table["dx"].tolist(), table["dy"].tolist()))


def test_chip_smoke_chain_work_counts():
    """The byte count under the upsample step's roofline shares
    (chip_smoke.chain_work: each input read once, each output written
    once): one ULTRA 1080p chain frame -- steps 4->3 (no pre-min), 3->2,
    2->1 and 1->0 (pre-min), the last cropped to 1080 x 1920 -- moves
    7,606,080 floats; the 4K step 1->0 with pre-min 22,917,120."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    hp, wp = TP.padded_shape(1080, 1920)
    lv = [(hp >> l, wp >> l) for l in range(5)]
    floats = sum(cs.chain_work(lv[l], *((1080, 1920) if l == 1 else lv[l - 1]),
                               lo_inputs=2 if l == 4 else 3)[1]
                 for l in (4, 3, 2, 1)) // 4
    assert floats == 7_606_080
    hp4, wp4 = TP.padded_shape(2160, 3840)
    assert cs.chain_work((4, hp4 // 2, wp4 // 2), 2160, 3840,
                         lo_inputs=3)[1] // 4 == 4 * 22_917_120
    assert cs.chain_work((hp4 // 2, wp4 // 2), 2160, 3840,
                         lo_inputs=3)[1] // 4 == 22_917_120


# The roofline (tpuao_torch/utils/roofline.py): tpuao's byte model, copied,
# and the H100's peaks.

ROOFLINE_CASES = [(h, w, d, n, b) for h, w in ((1080, 1920), (100, 150),
                                               (64, 64), (4320, 7680))
                  for d in (1, 2, 3, 4) for n in (False, True)
                  for b in (True, False)]


@pytest.mark.parametrize("h,w,depth,use_normals,blur", ROOFLINE_CASES)
def test_roofline_byte_model_equals_tpuao(h, w, depth, use_normals, blur):
    """``stage_traffic_bytes`` and ``min_traffic_bytes`` equal tpuao's on
    every shape, depth, normals and blur setting, with and without
    single_scale, at 4 and 2 bytes a texel."""
    from tpuao.utils import roofline as JR

    from tpuao_torch.utils import roofline as TR

    for single_scale in (False, True):
        for dtype_bytes in (4, 2):
            kw = {"depth_levels": depth, "use_normals": use_normals,
                  "enable_blur": blur, "single_scale": single_scale,
                  "dtype_bytes": dtype_bytes}
            assert TR.stage_traffic_bytes(h, w, **kw) == \
                JR.stage_traffic_bytes(h, w, **kw)
            assert TR.min_traffic_bytes(h, w, **kw) == \
                JR.min_traffic_bytes(h, w, **kw)


def test_roofline_floors_keys_and_peaks():
    """``floors_ms`` gives tpuao's keys against the H100's peaks (3.35
    TB/s, 67 TFLOP/s FP32): the memory floor alone without operations,
    the larger of the two with them."""
    from tpuao.utils import roofline as JR

    from tpuao_torch.utils import roofline as TR

    assert (TR.PEAK_BYTES, TR.PEAK_FLOPS) == (3.35e12, 67e12)
    for name in ("HBM_GBPS_ACHIEVED", "KERNEL_FIXED_MS", "entry_census"):
        assert not hasattr(TR, name)  # TPU-measured or XLA-only
    want = set(JR.floors_ms(1.0, 1080, 1920, flops=1e9))
    got = TR.floors_ms(0.1, 1080, 1920, ops=1e9)
    assert set(got) == want == {"mem_floor_ms", "flop_floor_ms", "floor_ms",
                                "pct_of_roofline"}
    mem = TR.min_traffic_bytes(1080, 1920) / 3.35e12 * 1e3
    assert got["mem_floor_ms"] == pytest.approx(mem)
    assert got["flop_floor_ms"] == pytest.approx(1e9 / 67e12 * 1e3)
    assert got["floor_ms"] == max(mem, got["flop_floor_ms"])
    assert got["pct_of_roofline"] == pytest.approx(100 * mem / 0.1)
    assert set(TR.floors_ms(0.1, 1080, 1920)) == {
        "mem_floor_ms", "floor_ms", "pct_of_roofline"}


def test_roofline_work_gives_the_kernel_tables_bounds():
    """The per-kernel work moved out of chip_smoke.py gives the bounds of
    PERF.md's kernel table (phase 12, printed to 4 places): the render at
    level 1 of 1080p, 4K and 8K and level 4 of 1080p, the normals render
    at levels 1-4 of four 1080p frames, the ULTRA chain of four steps at
    four frames, the fused steps 3->2 .. 1->0, the windowed resolve at
    1080p; chip_smoke imports these very functions."""
    from tpuao_torch.utils import roofline as TR

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name in ("bound", "render_work", "chain_work", "WINDOWED_OPS"):
        assert getattr(cs, name) is getattr(TR, name)

    def ms(work):
        b_ms, by = TR.bound(*work)
        return round(b_ms, 4), by

    hp, wp = TP.padded_shape(1080, 1920)
    lv = [(hp >> l, wp >> l) for l in range(5)]
    assert ms(TR.render_work(lv[1])) == (0.0061, "operations")
    assert ms(TR.render_work(lv[4])) == (0.0001, "operations")
    assert ms(TR.render_work((1088, 1920))) == (0.0246, "operations")
    assert ms(TR.render_work((2176, 3840))) == (0.0983, "operations")
    normals = [TR.render_work((4,) + lv[l], planes=2) for l in range(1, 5)]
    assert ms(tuple(map(sum, zip(*normals)))) == (0.0482, "operations")
    chain = [TR.chain_work((4,) + lv[l], *((1080, 1920) if l == 1 else
                                           lv[l - 1]),
                           lo_inputs=2 if l == 4 else 3) for l in (4, 3, 2, 1)]
    assert ms(tuple(map(sum, zip(*chain)))) == (0.0363, "bytes")
    fused = [TR.chain_work(lv[l], *((1080, 1920) if l == 1 else lv[l - 1]),
                           npairs=34) for l in (3, 2, 1)]
    assert ms(tuple(map(sum, zip(*fused)))) == (0.0096, "operations")
    assert ms((1080 * 1920 * TR.WINDOWED_OPS, 4 * 6 * 1080 * 1920)) == \
        (0.0149, "bytes")


def test_roofline_stage_work_keys_are_the_stage_profiles():
    """``stage_work`` has ``stage_times_ms``'s stages but the whole
    pipeline, each with the work of the kernel that times it."""
    from tpuao_torch.models.presets import preset
    from tpuao_torch.utils import roofline as TR

    for name in ("VERY_LOW", "HIGH", "ULTRA"):
        p = preset(name)
        d = p.hierarchy_depth
        work = TR.stage_work(1080, 1920, p)
        assert list(work) == ["prepare"] + [f"render_l{l}" for l in
                                            range(1, d + 1)] + \
            [f"upsample_l{l}" for l in range(d, 0, -1)]
        hp, wp = TP.padded_shape(1080, 1920)
        assert work["render_l1"] == TR.render_work(
            (1, hp // 2, wp // 2), 34 if p.exhaustive else 10,
            planes=2 if p.use_normals else 0)
        assert work["upsample_l1"] == TR.chain_work(
            (1, hp // 2, wp // 2), 1080, 1920, lo_inputs=2 if d == 1 else 3)
    assert TR.stage_work(1080, 1920, preset("HIGH"), batch=4)["prepare"] == \
        (0.0, 4 * TR.stage_traffic_bytes(1088, 1920)["prepare"])

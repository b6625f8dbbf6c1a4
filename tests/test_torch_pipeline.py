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
from tpuao_torch.utils import trace

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


# -- spans and counters (tpuao_torch.utils.trace) -----------------------------


@pytest.fixture
def traced():
    """Tracing on for the test, off and emptied after it."""
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.take()


def test_trace_spans_nest_and_share_their_entry_call(traced):
    with trace.span("a", frames=2):
        with trace.span("b"):
            with trace.span("c"):
                pass
        with trace.span("d"):
            pass
    with trace.span("e"):
        pass
    rec = trace.take()
    spans = rec["spans"]
    assert [r.name for r in spans] == list("abcde")
    assert [r.parent for r in spans] == [-1, 0, 1, 0, -1]
    assert [r.frames for r in spans] == [2, 0, 0, 0, 0]
    assert all(r.start_ns <= r.end_ns for r in spans)
    assert spans[0].start_ns <= spans[1].start_ns <= spans[2].start_ns
    assert spans[2].end_ns <= spans[1].end_ns <= spans[3].start_ns
    assert rec["dropped"] == 0 and trace.take()["spans"] == []


def test_trace_take_leaves_an_open_span_out(traced):
    """A span open across ``take()`` writes no end into the next list,
    and the spans opened inside it after the take have no parent."""
    with trace.span("open"):
        with trace.span("before"):
            pass
        first = trace.take()["spans"]
        with trace.span("x"):
            with trace.span("y"):
                pass
    with trace.span("z"):
        pass
    assert [(r.name, r.end_ns) for r in first] == [
        ("open", 0), ("before", first[1].end_ns)]
    spans = trace.take()["spans"]
    assert [(r.name, r.parent) for r in spans] == [
        ("x", -1), ("y", 0), ("z", -1)]
    assert all(r.end_ns >= r.start_ns > 0 for r in spans)
    assert spans[1].end_ns <= spans[0].end_ns <= spans[2].start_ns


def test_trace_self_time_is_the_duration_less_its_children(traced):
    R = trace.Record
    spans = [R("a", 0, 100, -1, 1), R("b", 10, 30, 0, 0),
             R("c", 40, 60, 0, 0), R("d", 45, 50, 2, 0),
             R("e", 200, 210, -1, 1)]
    assert trace.self_ns(spans) == [60, 20, 15, 5, 10]
    with trace.span("outer"):
        for _ in range(3):
            with trace.span("inner"):
                sum(range(1000))
    spans = trace.take()["spans"]
    own = trace.self_ns(spans)
    dur = [r.end_ns - r.start_ns for r in spans]
    assert own[0] == dur[0] - sum(dur[1:]) and own[1:] == dur[1:]
    assert min(own) >= 0


def test_trace_off_records_nothing():
    from tpuao_torch.parallel.sharding import render_views_sharded

    assert not trace.ON
    trace.take()
    z, cam, _, _ = scene(64, 96, batch=2)
    render_frame(z[0], cam, AOParams(), device="cpu")
    render_views_sharded(z, cam, AOParams(), device="cpu")
    rec = trace.take()
    assert rec["spans"] == [] and rec["dropped"] == 0


def test_trace_cap_counts_dropped():
    trace.enable(cap=3)
    try:
        with trace.span("a"):
            for _ in range(4):
                with trace.span("b"):
                    pass
    finally:
        trace.disable()
    rec = trace.take()
    assert [r.name for r in rec["spans"]] == ["a", "b", "b"]
    assert rec["dropped"] == 2 and trace.take()["dropped"] == 0
    with pytest.raises(ValueError, match="cap"):
        trace.enable(cap=0)
    assert not trace.ON


def test_trace_clock_joins_the_profilers(traced):
    """A span around one aten op, put on torch.profiler's clock by the
    anchor, holds the op's interval there to within 50 us."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("mm"):
            a @ a
    rec = trace.take()
    (span,) = rec["spans"]
    epoch_ns, perf_ns = rec["anchor"]
    s, e = (t + epoch_ns - perf_ns for t in (span.start_ns, span.end_ns))
    (op,) = [ev for ev in prof.profiler.kineto_results.events()
             if ev.name() == "aten::mm"]
    slack = 50_000
    assert s - slack <= op.start_ns() <= op.end_ns() <= e + slack


def _ladder(impl: str, normals: bool) -> list[str]:
    """The stages ``ao_pipeline``'s docstring lists at depth 4: under
    ``auto`` without normals the render at level 4, the upsample step
    4 -> 3 and three fused steps; otherwise a render at every level and an
    upsample step from every level."""
    if impl == "auto" and not normals:
        return ["ao_render_l4", "ao_upsample_l4", "ao_fused_l3",
                "ao_fused_l2", "ao_fused_l1"]
    return ([f"ao_render_l{l}" for l in range(1, 5)]
            + [f"ao_upsample_l{l}" for l in range(4, 0, -1)])


@pytest.mark.parametrize("preset_name,impl,views", [
    ("HIGH", "auto", False), ("HIGH", "pallas", False),
    ("ULTRA", "auto", False), ("HIGH", "auto", True)])
def test_frame_path_spans(traced, preset_name, impl, views):
    from tpuao_torch.models.presets import preset
    from tpuao_torch.parallel.sharding import render_views_sharded

    z, cam, _, _ = scene(64, 96, batch=2)
    params = preset(preset_name)
    n = None
    if params.use_normals:
        n = torch.nn.functional.normalize(
            torch.rand(2, 64, 96, 3, generator=torch.Generator().manual_seed(
                1)) - 0.5, dim=-1)
    if views:
        render_views_sharded(z, cam, params, normals=n, impl=impl,
                             device="cpu")
    else:
        render_frame(z, cam, params, normals=n, impl=impl, device="cpu")
    spans = trace.take()["spans"]
    entry = ["ao_entry.render_views"] if views else []
    entry += ["ao_entry.render_frame", "ao_prepare"]
    entry += ["ao_slopes"] if n is not None else []
    stages = _ladder(impl, n is not None)
    # the CPU runs the plain versions: no launch
    assert [r.name for r in spans] == entry + stages
    frame = 1 if views else 0  # render_frame's span
    assert spans[0].parent == -1 and spans[0].frames == 2
    assert spans[frame].parent == frame - 1 and spans[frame].frames == 2
    for r in spans[frame + 1:]:
        assert r.parent == frame and r.frames == 0


# ---------------------------------------------------------------------------
# models/frame_graph on the CPU: the key, the engage rules and the cache,
# with the capture stubbed (the graphs themselves run on the card:
# tests/test_torch_kernels_cuda.py)
# ---------------------------------------------------------------------------


@pytest.fixture
def graphs():
    from tpuao_torch.models import frame_graph

    frame_graph._clear()
    yield frame_graph
    frame_graph._clear()


def test_frame_graph_key_holds_what_decides_the_launches(graphs):
    from tpuao_torch.utils import launch_opts as L

    z = torch.zeros(2, 64, 96)
    cam, par = CameraParams(depth_mode="linear"), AOParams()
    key = graphs._key(z, None, cam, par, "auto")
    same = graphs._key(torch.ones(2, 64, 96), None,
                       CameraParams(depth_mode="linear"), AOParams(), "auto")
    assert key == same and hash(key) == hash(same)
    changed = [
        graphs._key(z, None, cam, par.replace(strength=1.5), "auto"),
        graphs._key(z, None, cam.replace(near=0.2), par, "auto"),
        graphs._key(z[:1], None, cam, par, "auto"),
        graphs._key(z.double(), None, cam, par, "auto"),
        graphs._key(torch.zeros(2, 96, 64).transpose(-1, -2), None, cam,
                    par, "auto"),
        graphs._key(z, torch.zeros(2, 64, 96, 3), cam, par, "auto"),
        graphs._key(z, None, cam, par, "pallas"),
    ]
    try:
        L.set_tuned_tiles("fused_render_upsample_step", 2, 32, 48, 2)
        changed.append(graphs._key(z, None, cam, par, "auto"))
        L.clear_tuned_tiles()  # the same table as before, a new generation
        changed.append(graphs._key(z, None, cam, par, "auto"))
        L.restore_tuned_tiles({})  # autotune's restore after a sweep
        changed.append(graphs._key(z, None, cam, par, "auto"))
    finally:
        L.clear_tuned_tiles()
    assert len({key, *changed}) == len(changed) + 1


@pytest.mark.parametrize("reason", ["cpu", "grad", "debug", "capturing",
                                    "tensor_params"])
def test_frame_graph_eager_calls_by_reason(graphs, monkeypatch, reason):
    """Each call the graphs must not take runs the eager path, bit-equal,
    counted under its reason; nothing is captured or replayed."""
    z, cam, _, _ = scene(64, 96, batch=2)
    z = torch.as_tensor(z)
    par = AOParams()
    impl = "jnp" if reason == "grad" else "auto"
    want = render_frame(z, cam, par, impl=impl)
    graphs._clear()
    if reason != "cpu":  # as if on the card
        monkeypatch.setattr(graphs, "_on_card", lambda depth: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: reason == "capturing")
    if reason == "tensor_params":
        par = par.replace(strength=torch.tensor(1.0))
    if reason == "grad":
        z = z.clone().requires_grad_()
    got = render_frame(z, cam, par, impl=impl,
                       debug_outputs=reason == "debug")
    if reason == "debug":
        got = got[0]
    if reason == "grad":
        assert got.requires_grad
    assert torch.equal(got.detach(), want)
    assert graphs.graph_counts() == {
        "captures": 0, "replays": 0, **dict.fromkeys(graphs.SIDES, 0),
        "eager": {**dict.fromkeys(graphs.REASONS, 0), reason: 1}}


def test_frame_graph_bypassed_by_the_paths_that_call_the_pipeline(
        graphs, monkeypatch):
    """The temporal loop, sections, the spatial mode and autodiff call
    ``ao_pipeline`` directly: the cache sees none of their frames."""
    from tpuao_torch.models.autodiff import ao_loss
    from tpuao_torch.models.pipeline import render_sequence_temporal
    from tpuao_torch.parallel.sections import render_frame_sections
    from tpuao_torch.parallel.spatial import render_frame_spatial

    monkeypatch.setattr(graphs, "_on_card", lambda depth: True)
    z, cam, _, _ = scene(256, 96, batch=2)
    z = torch.as_tensor(z)
    par = AOParams(hierarchy_depth=2)
    render_sequence_temporal(z, cam, par)
    render_frame_sections(z[0], cam, par, n_sections=2)
    render_frame_spatial(z[0], cam, par, mesh=["cpu"] * 2)
    ao_loss(par, z[0], torch.ones(256, 96), cam)
    assert graphs.graph_counts() == {
        "captures": 0, "replays": 0, **dict.fromkeys(graphs.SIDES, 0),
        "eager": dict.fromkeys(graphs.REASONS, 0)}


def _stub_capture(graphs, monkeypatch, sizes, bound=100):
    """``_capture`` stubbed to an entry of ``sizes[key]`` pool bytes, and
    the cache's bound set to ``bound`` bytes."""
    import types

    monkeypatch.setattr(graphs, "_bound", lambda device: bound)
    monkeypatch.setattr(graphs, "_capture",
                        lambda depth, normals, program, sides:
                        types.SimpleNamespace(nbytes=sizes[program]))

    def call(key):
        """``_entry_for`` as ``replay`` calls it, with its counts."""
        entry, reason = graphs._entry_for(key, torch.zeros(4, 4), None, key)
        if reason is None:
            graphs._counts["replays"] += 1
        else:
            graphs._eager[reason] += 1
        return entry, reason

    return call


def test_frame_graph_first_sight_then_capture_then_hits(graphs, monkeypatch):
    call = _stub_capture(graphs, monkeypatch, {"a": 10})
    assert call("a") == (None, "first_sight")
    entry, reason = call("a")
    assert reason is None and entry.nbytes == 10
    assert call("a") == (entry, None)  # a hit: no new capture
    assert graphs.graph_counts()["captures"] == 1
    assert list(graphs._entries) == ["a"]


def test_frame_graph_cache_evicts_the_least_recent(graphs, monkeypatch):
    sizes = {"a": 10, "b": 10, "c": 10, "d": 10, "e": 90, "f": 500}
    call = _stub_capture(graphs, monkeypatch, sizes, bound=100)
    monkeypatch.setattr(graphs, "MAX_ENTRIES", 3)
    monkeypatch.setattr(graphs, "PAYBACK", 1)  # every capture paid for

    def capture(key):
        call(key)
        return call(key)[0]

    for key in "abc":
        capture(key)
    call("a")  # a hit makes "a" the most recent
    capture("d")  # four entries: the least recent, "b", goes
    assert list(graphs._entries) == ["c", "a", "d"]
    capture("e")  # 120 bytes: "c" then "a" go, down to 100
    assert list(graphs._entries) == ["d", "e"]
    capture("f")  # larger than the bound alone: the newest stays
    assert list(graphs._entries) == ["f"]
    assert graphs.graph_counts()["captures"] == 6
    assert graphs.pool_bytes() == 500
    # an evicted key runs eager from then on, and captures nothing
    for key in "abcde":
        assert call(key) == (None, "evicted")
    assert list(graphs._entries) == ["f"]
    assert graphs.graph_counts()["captures"] == 6


@pytest.mark.parametrize("n_keys", [40, 200])
def test_frame_graph_more_keys_than_the_cache_do_not_thrash(
        graphs, monkeypatch, n_keys):
    """Keys that outnumber the cache, called round-robin (a per-view rig
    of ``n_keys`` distinct views): no key captures twice, and once each
    has had its turn, the cache's keys replay and the rest run eager."""
    import collections

    call = _stub_capture(graphs, monkeypatch,
                         collections.defaultdict(lambda: 1), bound=10 ** 9)
    keys = [f"k{i}" for i in range(n_keys)]

    def rounds(n):
        for _ in range(n):
            for key in keys:
                call(key)
        return graphs.graph_counts()

    settled = rounds(30)
    assert settled["captures"] <= (n_keys if n_keys <= 4 * graphs.MAX_ENTRIES
                                   else 0)
    last = rounds(10)
    assert last["captures"] == settled["captures"]
    replays = last["replays"] - settled["replays"]
    eager = {r: n - settled["eager"][r] for r, n in last["eager"].items()}
    if n_keys == 40:  # the cache's 32 replay, the 8 evicted run eager
        assert len(graphs._entries) == graphs.MAX_ENTRIES
        assert replays == 10 * graphs.MAX_ENTRIES
        assert eager["evicted"] == 10 * (n_keys - graphs.MAX_ENTRIES)
    else:  # more keys than the seen list holds: every call is a first
        assert not graphs._entries and replays == 0
        assert eager["first_sight"] == 10 * n_keys


def test_frame_graph_captures_beyond_the_cache_wait_for_replays(
        graphs, monkeypatch):
    """Fresh keys, each called twice and never again: past the first
    ``MAX_ENTRIES`` captures, a key captures only once ``PAYBACK`` more
    replays have paid for it."""
    import collections

    call = _stub_capture(graphs, monkeypatch,
                         collections.defaultdict(lambda: 1), bound=10 ** 9)
    for i in range(4 * graphs.MAX_ENTRIES):
        call(f"fresh{i}")
        call(f"fresh{i}")
    counts = graphs.graph_counts()
    assert counts["captures"] == graphs.MAX_ENTRIES
    assert counts["eager"]["budget"] == 3 * graphs.MAX_ENTRIES
    hot = next(reversed(graphs._entries))
    for _ in range(graphs.PAYBACK):
        call(hot)  # replays of a cached key pay for one capture more
    assert call("late") == (None, "first_sight")
    assert call("late")[1] is None
    assert graphs.graph_counts()["captures"] == graphs.MAX_ENTRIES + 1


def test_frame_graph_a_failed_capture_runs_eager_from_then_on(
        graphs, monkeypatch):
    tries = []

    def fail(depth, normals, program, sides):
        tries.append(program)
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(graphs, "_capture", fail)
    depth = torch.zeros(4, 4)
    assert graphs._entry_for("k", depth, None, "k") == (None, "first_sight")
    with pytest.warns(RuntimeWarning, match="runs eager"):
        assert graphs._entry_for("k", depth, None, "k") == (None,
                                                            "uncapturable")
    assert graphs._entry_for("k", depth, None, "k") == (None, "uncapturable")
    assert tries == ["k"] and graphs.graph_counts()["captures"] == 0


def test_frame_graph_key_separates_the_16_byte_alignment_classes(graphs):
    """The prologue picks its 16-byte loads from its inputs' alignment: a
    view 1 to 3 floats into a buffer gets a key of its own, one 4 floats
    in shares the aligned key."""
    cam, par = CameraParams(depth_mode="linear"), AOParams()
    plane = 64 * 96
    buf, nbuf = torch.zeros(plane + 4), torch.zeros(3 * plane + 4)
    keys = [graphs._key(buf[i:i + plane].view(64, 96), None, cam, par,
                        "auto") for i in range(5)]
    assert keys[0] == keys[4] and keys[1] == keys[2] == keys[3]
    assert keys[0] != keys[1]
    z = buf[:plane].view(64, 96)
    nkeys = [graphs._key(z, nbuf[i:i + 3 * plane].view(64, 96, 3), cam, par,
                         "auto") for i in (0, 1, 4)]
    assert nkeys[0] == nkeys[2] != nkeys[1]


class _FakeGraph:
    """A frame graph as the CPU tests see one: each replay runs the
    program again, on the inputs the last bind pointed it at (else the
    ones it was captured with), into the output the last bind named (else
    the captured one) -- what the card's graph reads and writes."""

    def __init__(self, program, depth, normals, ao):
        self.program = program
        self.inputs, self.out = (depth, normals), ao

    def replay(self):
        self.out.copy_(self.program(*self.inputs))


@pytest.fixture
def card_graphs(graphs, monkeypatch):
    """``frame_graph`` on CPU tensors as if on the card: the capture runs
    the program once and gives a ``_FakeGraph``; ``_find`` finds the
    prologue where it was asked to bind the inputs and the last chain
    step where it was asked to bind the output, less what ``fake.lose``
    takes off, and its ``bind`` returns ``fake.err``."""
    import types

    fake = types.SimpleNamespace(lose=0, err=0, records=[])

    def record(depth, normals, program, in_place):
        d, n = depth, normals
        if not in_place:
            d = torch.empty_like(depth)
            n = None if normals is None else torch.empty_like(normals)
        fake.records.append(in_place)
        ao = program(d, n)
        return _FakeGraph(program, d, n, ao), d, n, ao, {}, 0

    def find(graph, depth, normals, ao):
        found = ((depth is not None) | 2 * (ao is not None)) & ~fake.lose

        def bind(d, n, out):
            if found & 1:
                graph.inputs = (d, n)
            if found & 2:
                graph.out = out
            return fake.err

        return found, bind if found else None

    stream = types.SimpleNamespace(wait_event=lambda event: None)
    monkeypatch.setattr(graphs, "_on_card", lambda depth: True)
    monkeypatch.setattr(graphs, "_record", record)
    monkeypatch.setattr(graphs, "_find", find)
    monkeypatch.setattr(graphs, "_bound", lambda device: 10 ** 12)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: stream)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", lambda: types.SimpleNamespace(
        record=lambda stream: None))
    return fake


# case: what differs from a float32 depth-only frame under "auto" with
# blur; the sides the graph binds, (inputs, output)
BIND_CASES = {
    "float32": (True, True),
    "normals": (True, True),
    "float16": (False, True),  # prepare_levels casts it first
    "column_strided": (False, True),  # prepare_levels copies it first
    "pallas_normals": (False, True),  # its raw-normals pyramid reads them
    "no_blur": (True, False),  # a nearest 2x by PyTorch ops
    "prologue_copies": (False, True),  # the capture's prologue reads a copy
}


@pytest.mark.parametrize("case", sorted(BIND_CASES))
def test_frame_graph_replays_bind_what_the_graph_lets_bind(card_graphs,
                                                           graphs, case):
    """Each replay reads the call's depth and normals and writes a fresh
    output, either in place or through the static buffers, as the call
    and the captured nodes allow; every output is its call's frame, and
    each side of each replay is counted once."""
    from tpuao_torch.models.pipeline import ao_pipeline
    from tpuao_torch.utils import fixtures as F

    inputs, output = BIND_CASES[case]
    card_graphs.lose = 1 if case == "prologue_copies" else 0
    impl = "pallas" if case == "pallas_normals" else "auto"
    par = AOParams(hierarchy_depth=2, enable_blur=case != "no_blur")
    cam, frames = CameraParams(depth_mode="linear"), []
    for seed in (3, 4):
        z, n = (torch.as_tensor(np.stack(x), dtype=torch.float32)
                for x in zip(*(
                    F.spheres_on_plane(64, 96, cam, seed=seed + i,
                                       with_normals=True, backend="numpy")
                    for i in range(2))))
        n = n if "normals" in case else None
        if case == "float16":
            z = z.half()
        if case == "column_strided":
            z = z.transpose(-1, -2).contiguous().transpose(-1, -2)
        frames.append((z, n))
    if n is not None:
        par = par.replace(use_normals=True)
    wants = [ao_pipeline(z, cam, par, n, impl=impl)[0] for z, n in frames]
    outs = [render_frame(z, cam, par, normals=n, impl=impl)
            for z, n in (frames * 3)[:5]]
    for i, got in enumerate(outs):
        assert torch.equal(got, wants[i % 2])
    assert len({o.data_ptr() for o in outs}) == 5  # fresh, none aliased
    entry = next(iter(graphs._entries.values()))
    assert entry.binds == (inputs, output)
    assert (entry.depth is None) == inputs
    assert card_graphs.records == ([True, False] if case == "prologue_copies"
                                   else [inputs])
    counts = graphs.graph_counts()
    replays = 4
    assert counts["captures"] == 1 and counts["replays"] == replays
    assert counts["eager"] == {**dict.fromkeys(graphs.REASONS, 0),
                               "first_sight": 1}
    assert counts["inputs_bound"] == replays * inputs
    assert counts["inputs_copied"] == replays * (not inputs)
    assert counts["output_bound"] == replays * output
    assert counts["output_cloned"] == replays * (not output)
    assert counts["bound"] == replays * (inputs and output)
    assert counts["inputs_bound"] + counts["inputs_copied"] == replays
    assert counts["output_bound"] + counts["output_cloned"] == replays


def test_frame_graph_a_bind_error_runs_eager_from_then_on(card_graphs,
                                                          graphs):
    """A graph that cannot be bound to a call's buffers warns once, and
    its key runs the eager path from then on, bit-equal."""
    import warnings

    card_graphs.err = 700
    z, cam, _, _ = scene(64, 96, batch=2)
    z = torch.as_tensor(z)
    want = render_frame(z, cam)  # first sight
    with pytest.warns(RuntimeWarning, match="binding the graph"):
        assert torch.equal(render_frame(z, cam), want)  # captured, eager
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch.equal(render_frame(z, cam), want)
    assert not graphs._entries
    assert graphs.graph_counts() == {
        "captures": 1, "replays": 0, **dict.fromkeys(graphs.SIDES, 0),
        "eager": {**dict.fromkeys(graphs.REASONS, 0), "first_sight": 1,
                  "uncapturable": 2}}


def test_launch_tally_takes_only_its_own_threads_launches():
    """In a ``kernels.tally_launches`` block this thread's launches go to
    the tally (a capture's), another thread's meanwhile to the counts;
    ``add_launches`` adds the tally once a call (a replay's)."""
    import threading

    from tpuao_torch.ops import kernels as K

    K.reset_launch_counts()
    try:
        with K.tally_launches() as tally:
            K._count(K.render_ao_level)
            t = threading.Thread(target=lambda: [
                K._count(K.blur_upsample_step) for _ in range(3)])
            t.start()
            t.join()
            K._count(K.render_ao_level_normals)
            K._count(K.render_ao_level_normals, "raw_launches")
        assert tally == {(K.render_ao_level, "launches"): 1,
                         (K.render_ao_level_normals, "launches"): 1,
                         (K.render_ao_level_normals, "raw_launches"): 1}
        assert K.launch_counts() == {**dict.fromkeys(K.launch_counts(), 0),
                                     "blur_upsample_step": 3}
        assert K.render_ao_level_normals.raw_launches == 0
        K._count(K.render_ao_level)  # the block is closed: counted
        for _ in range(2):
            K.add_launches(tally)
        assert K.launch_counts() == {**dict.fromkeys(K.launch_counts(), 0),
                                     "render_ao_level": 3,
                                     "render_ao_level_normals": 2,
                                     "blur_upsample_step": 3}
        assert K.render_ao_level_normals.raw_launches == 2
    finally:
        K.reset_launch_counts()


def test_census_by_wrapper_sorts_the_card_records():
    """``roofline.census_by_wrapper`` on kernel names as torch.profiler
    gives them (``launch_census``'s shortening): the render's mode picks
    its wrapper, prepare's and copies' kernels are left out."""
    from tpuao_torch.utils.roofline import census_by_wrapper

    census = {"tpuao::render_kernel<34, 0, 2>": (4, 0.1),
              "tpuao::render_kernel<34, 1, 1>": (8, 0.2),
              "tpuao::render_kernel<10, 2, 1>": (1, 0.1),
              "tpuao::upsample_kernel<1>": (4, 0.1),
              "tpuao::fused_step_kernel<34, 2>": (6, 0.3),
              "tpuao::fused_step_kernel<34, 1>": (6, 0.3),
              "elementwise_kernel<128, 2, ...>": (9, 0.1),
              "Memcpy DtoD (Device -> Device)": (8, 0.1)}
    assert census_by_wrapper(census) == {
        "render_ao_level": 4, "render_ao_level_normals": 9,
        "blur_upsample_step": 4, "fused_render_upsample_step": 12}

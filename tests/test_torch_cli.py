"""The port's CLI (``python -m tpuao_torch``) against tpuao's, on the CPU.

Both ``main`` functions run in-process on the same files: the port's with
``--device cpu`` (every impl runs the plain versions there), tpuao's on
JAX's CPU backend.  Output files agree within 1e-5 (PFM) or one 8-bit code
(PNG: float noise can cross a rounding edge); usage errors exit with
tpuao's codes.
"""

import json
import math
import threading

import numpy as np
import pytest
import torch

from tpuao import cli as JCLI
from tpuao.utils.debug_dump import load_debug_buffers

from tpuao_torch import cli as CLI
from tpuao_torch.models.pipeline import render_frame
from tpuao_torch.params import AOParams, CameraParams
from tpuao_torch.serving import make_server
from tpuao_torch.utils import fixtures as F
from tpuao_torch.utils.frameio import load_pfm, save_pfm

TOL = 1e-5
H, W = 48, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, so these tests do not crowd the
    CPU that the suite's other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _depth(seed=7, h=H, w=W, eye=(0.0, 0.0, 0.0)):
    z, n = F.spheres_on_plane(h, w, CameraParams(depth_mode="linear"),
                              n_spheres=3, seed=seed, with_normals=True,
                              eye=eye)
    return z.astype(np.float32), n.astype(np.float32)


def _both(args, tmp_path, out_name, port_extra=("--device", "cpu")):
    """Run tpuao's and the port's ``main`` on ``args`` with the output
    ``out_name`` in separate directories; returns both output paths."""
    outs = {}
    for pkg, main, extra in (("jax", JCLI.main, ()),
                             ("port", CLI.main, tuple(port_extra))):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        outs[pkg] = d / out_name
        assert main(["render", *args, str(outs[pkg]), *extra]) == 0, pkg
    return outs["jax"], outs["port"]


def _close_files(a, b):
    if str(a).endswith(".png"):
        from PIL import Image

        x = np.asarray(Image.open(a)).astype(int)
        y = np.asarray(Image.open(b)).astype(int)
        assert x.shape == y.shape
        assert np.abs(x - y).max() <= 1
        assert (x == y).mean() > 0.99
    else:
        x, y = load_pfm(str(a)), load_pfm(str(b))
        assert x.shape == y.shape
        np.testing.assert_allclose(y, x, atol=TOL)


def test_parser_flags_match_tpuao():
    """The port's commands and flags are tpuao's, plus ``render --device``
    and ``tune --batch`` (a tuned launch's key holds its frames a
    call)."""
    def flags(ap):
        sub = ap._subparsers._group_actions[0].choices
        return {name: sorted(o for act in p._actions
                             for o in act.option_strings) +
                [act.dest for act in p._actions if not act.option_strings]
                for name, p in sub.items()}

    want = flags(JCLI._build_parser())
    want["render"] = sorted(want["render"][:-2] + ["--device"]) + \
        want["render"][-2:]
    want["tune"] = sorted(want["tune"][:-1] + ["--batch"]) + \
        want["tune"][-1:]
    assert flags(CLI._build_parser()) == want


def _normals_png(path, n):
    from PIL import Image

    enc = np.clip((n + 1.0) / 2.0, 0.0, 1.0)
    Image.fromarray((enc * 255).round().astype(np.uint8)).save(path)


def _projection():
    near, far = 0.3, 100.0
    x = 1.0 / math.tan(math.radians(70.0) / 2)
    p = np.zeros((4, 4))
    p[0, 0], p[1, 1] = x, x * 16 / 9
    p[2, 2], p[2, 3] = near / (far - near), near * far / (far - near)
    p[3, 2] = -1.0  # reversed-Z, right-handed
    return p, far


CASES = ["pfm", "png", "ultra_png_normals", "color", "projection_file",
         "projection_inline"]


@pytest.mark.parametrize("case", CASES)
def test_render_matches_tpuao(case, tmp_path):
    from PIL import Image

    z, n = _depth()
    src = str(tmp_path / "d.pfm")
    save_pfm(src, z)
    out = "ao.pfm"
    if case == "pfm":
        args = [src, "--depth-mode", "linear", "--strength", "2.0"]
    elif case == "png":
        src = str(tmp_path / "d.png")
        Image.fromarray((np.clip(z, 0, 1) * 65535).astype(np.uint16)).save(
            src)
        args, out = [src], "ao.png"
    elif case == "ultra_png_normals":
        _normals_png(tmp_path / "n.png", n)
        args = [src, "--depth-mode", "linear", "--preset", "ULTRA",
                "--normals", str(tmp_path / "n.png")]
    elif case == "color":
        color = np.random.default_rng(0).uniform(0, 1, (H, W, 3))
        save_pfm(str(tmp_path / "c.pfm"), color.astype(np.float32))
        args = [src, "--depth-mode", "linear", "--color",
                str(tmp_path / "c.pfm")]
    else:
        p, far = _projection()
        z_eye = np.clip(z, 1e-3, 1.0) * far
        hw = ((p[2, 2] * -z_eye + p[2, 3]) / (p[3, 2] * -z_eye)).astype(
            np.float32)
        save_pfm(src, hw)
        if case == "projection_file":
            spec = str(tmp_path / "proj.txt")
            with open(spec, "w") as fh:
                fh.write("# unity reversed-Z\n")
                fh.write("\n".join(" ".join(str(v) for v in r) for r in p))
        else:
            spec = ",".join(repr(float(v)) for v in p.ravel())
        args = [src, "--projection", spec]
    a, b = _both(args, tmp_path, out)
    _close_files(a, b)
    if case == "color":
        assert load_pfm(str(b)).shape == (H, W, 3)


def _sequence(tmp_path, n=7, moving=False):
    seq = tmp_path / "seq"
    seq.mkdir()
    views = []
    for t in range(n):
        eye = (0.02 * t, 0.0, 0.03 * t) if moving else (0.0, 0.0, 0.0)
        save_pfm(str(seq / f"f{t:03d}.pfm"),
                 _depth(seed=7 if moving else t, eye=eye)[0])
        v = np.eye(4)
        v[:3, 3] = [-e for e in eye]
        views.append(v.ravel().tolist())
    vp = tmp_path / "views.json"
    vp.write_text(json.dumps(views))
    return str(seq / "f*.pfm"), str(vp)


def _dirs_close(a, b, n):
    for t in range(n):
        _close_files(a / f"f{t:03d}_ao.pfm", b / f"f{t:03d}_ao.pfm")


def test_sequence_matches_tpuao_with_a_short_tail(tmp_path):
    """7 frames at --batch 3: two full batches and a tail of one, which the
    port renders as it is (tpuao pads it)."""
    glob, _ = _sequence(tmp_path)
    a, b = _both([glob, "--depth-mode", "linear", "--batch", "3"],
                 tmp_path, "out")
    _dirs_close(a, b, 7)


@pytest.mark.parametrize("mode", ["static", "camera_path",
                                  "camera_path_level1"])
def test_temporal_matches_tpuao(mode, tmp_path):
    glob, vp = _sequence(tmp_path, n=4, moving=mode != "static")
    args = [glob, "--depth-mode", "linear", "--temporal", "--batch", "3",
            "--history-weight", "0.8"]
    if mode != "static":
        args += ["--camera-path", vp]
    if mode == "camera_path_level1":
        args += ["--resolve-level", "1"]
    a, b = _both(args, tmp_path, "out")
    _dirs_close(a, b, 4)


@pytest.mark.parametrize("form", ["npz", "zarr"])
def test_debug_dump_matches_tpuao(form, tmp_path):
    if form == "zarr":
        pytest.importorskip("tensorstore")
    z, _ = _depth()
    src = str(tmp_path / "d.pfm")
    save_pfm(src, z)
    # the npz form under "pallas" (a padded combined_0), the zarr form
    # under the default impl
    name, impl = ("dbg.npz", "pallas") if form == "npz" else ("dbg", "auto")
    dumps = {k: str(tmp_path / f"{k}_{name}") for k in ("jax", "port")}
    _both([src, "--depth-mode", "linear", "--impl", impl,
           "--debug-dump", dumps["jax"]], tmp_path, "ao.pfm",
          port_extra=("--device", "cpu", "--debug-dump", dumps["port"]))
    want, got = (load_debug_buffers(dumps[k]) for k in ("jax", "port"))
    assert sorted(got) == sorted(want)
    assert "pyramid/0" in got and "ao_levels/4" in got
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k], v, atol=TOL, err_msg=k)
    assert got["combined_0"].shape == ((64, 64) if impl == "pallas"
                                       else (H, W))


def _usage_case(case, tmp_path):
    z, _ = _depth(h=32, w=32)
    src = str(tmp_path / "d.pfm")
    save_pfm(src, z)
    out = str(tmp_path / "o.pfm")
    if case == "depth_3_channel":
        save_pfm(src, np.zeros((8, 8, 3), np.float32))
        return ["render", src, out]
    if case == "normals_1_channel":
        save_pfm(str(tmp_path / "n.pfm"), z)
        return ["render", src, out, "--depth-mode", "linear", "--normals",
                str(tmp_path / "n.pfm")]
    if case == "far_below_near":
        return ["render", src, out, "--depth-mode", "linear", "--far",
                "0.05"]
    if case == "temporal_single_frame":
        return ["render", src, out, "--temporal"]
    if case == "sequence_sections":
        return ["render", str(tmp_path / "?.pfm"), str(tmp_path / "o"),
                "--sections", "2"]
    if case == "sections_debug_dump":
        return ["render", src, out, "--sections", "2", "--debug-dump",
                str(tmp_path / "x.npz")]
    if case == "no_frames":
        return ["render", str(tmp_path / "none_*.pfm"), str(tmp_path / "o")]
    if case == "server_engine_flags":
        return ["render", src, out, "--server", "http://127.0.0.1:9",
                "--preset", "LOW", "--autotune-cache", "x.json"]
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "depth_3_channel", "normals_1_channel", "far_below_near",
    "temporal_single_frame", "sequence_sections", "sections_debug_dump",
    "no_frames", "server_engine_flags"])
def test_usage_errors_exit_like_tpuao(case, tmp_path, capsys):
    argv = _usage_case(case, tmp_path)
    assert JCLI.main(argv) == 2
    capsys.readouterr()
    port = argv + (["--device", "cpu"] if "--server" not in argv else [])
    assert CLI.main(port) == 2
    assert capsys.readouterr().err.startswith("error:")


@pytest.mark.parametrize("argv", [
    ["render", "d.pfm", "o.pfm", "--server", "http://127.0.0.1:9",
     "--device", "cpu"]])
def test_what_the_port_rejects_exits_2(argv, capsys):
    """``--device`` is engine state to a remote render.  Nothing is read
    or rendered before the exit."""
    assert CLI.main(argv) == 2
    assert "server-side" in capsys.readouterr().err


def _tile_cache(tmp_path) -> str:
    """A cache file of two tuned launches, as ``tune --save`` writes."""
    from tpuao_torch.utils import autotune
    from tpuao_torch.utils import launch_opts as L

    L.clear_tuned_tiles()
    L.set_tuned_tiles("render_ao_level", 1, 4, 8, 2)
    L.set_tuned_tiles("fused_render_upsample_step", 1, 32, 64, 3)
    path = autotune.save_tuned(str(tmp_path / "tiles.json"))
    L.clear_tuned_tiles()
    return path


def test_render_autotune_cache_loads_the_table(tmp_path):
    """``render --autotune-cache`` on ``--device cpu`` loads the cache
    before the frame, and the frame is what it is without one (tile rows
    change no result)."""
    from tpuao_torch.utils import launch_opts as L

    path = _tile_cache(tmp_path)
    z, _ = _depth()
    src, dst = str(tmp_path / "d.pfm"), str(tmp_path / "o.pfm")
    save_pfm(src, z)
    try:
        assert CLI.main(["render", src, dst, "--depth-mode", "linear",
                         "--device", "cpu", "--autotune-cache", path]) == 0
        assert L._TUNED == {("render_ao_level", 1, 4, 8): 2,
                            ("fused_render_upsample_step", 1, 32, 64): 3}
    finally:
        L.clear_tuned_tiles()
    np.testing.assert_array_equal(load_pfm(dst), render_frame(
        z, CameraParams(depth_mode="linear"), device="cpu").numpy())


def test_serve_autotune_cache_loads_the_table(tmp_path, monkeypatch,
                                              capsys):
    """``serve --autotune-cache`` reaches the server's parser, which loads
    the cache and says how many entries before it builds the server."""
    from tpuao_torch import serving
    from tpuao_torch.utils import launch_opts as L

    class Built(Exception):
        pass

    def fake(port, engine=None, **kw):
        assert len(L._TUNED) == 2  # loaded first
        raise Built

    path = _tile_cache(tmp_path)
    monkeypatch.setattr(serving, "make_server", fake)
    try:
        with pytest.raises(Built):
            CLI.main(["serve", "0", "--device", "cpu", "--autotune-cache",
                      path])
    finally:
        L.clear_tuned_tiles()
    assert "autotune cache: 2 entries" in capsys.readouterr().out


def test_render_sections_matches_tpuao(tmp_path):
    """``render --sections 2`` on a 704-row frame (two sections of 384 kept
    rows, halo 320): tpuao's file within 2e-6, its sections' own bound,
    and the port's whole frame bit for bit."""
    z, _ = _depth(h=704)
    src = str(tmp_path / "d.pfm")
    save_pfm(src, z)
    a, b = _both([src, "--depth-mode", "linear", "--sections", "2"],
                 tmp_path, "ao.pfm")
    got = load_pfm(str(b))
    assert got.shape == (704, W)
    np.testing.assert_allclose(got, load_pfm(str(a)), atol=2e-6)
    np.testing.assert_array_equal(got, render_frame(
        z, CameraParams(depth_mode="linear"), device="cpu").numpy())


def test_serve_views_reaches_the_server_with_a_mesh(monkeypatch):
    """``serve --views 2 --device cpu`` goes through to the server's
    parser, which builds a mesh of 2 CPU entries (and leaves the batch to
    default to the mesh's size)."""
    from tpuao_torch import serving

    class Built(Exception):
        pass

    seen = {}

    def fake(port, engine=None, **kw):
        seen.update(kw, port=port)
        raise Built

    monkeypatch.setattr(serving, "make_server", fake)
    with pytest.raises(Built):
        CLI.main(["serve", "0", "--views", "2", "--device", "cpu"])
    assert seen["mesh"] == (torch.device("cpu"),) * 2
    assert seen["device"] == "cpu" and seen["batch_size"] == 0
    assert seen["port"] == 0


def test_render_through_the_port_server(tmp_path):
    z, _ = _depth()
    src, dst = str(tmp_path / "d.pfm"), str(tmp_path / "o.pfm")
    save_pfm(src, z)
    srv = make_server(0, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        assert CLI.main(["render", src, dst, "--server", url,
                         "--depth-mode", "linear", "--strength",
                         "1.5"]) == 0
        # the server's engine renders linear depth: hardware is refused
        assert CLI.main(["render", src, dst, "--server", url,
                         "--depth-mode", "hardware"]) == 2
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    want = render_frame(z, CameraParams(depth_mode="linear"),
                        AOParams(strength=1.5), device="cpu").numpy()
    np.testing.assert_array_equal(load_pfm(dst), want)


def test_info_prints_json(capsys):
    assert CLI.main(["info"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["torch"] == torch.__version__
    assert out["cuda_available"] == torch.cuda.is_available()
    assert out["device_count"] == len(out["devices"])
    assert "tpuao_torch" in out


def test_no_card_exits_1_naming_the_cpu_flag(tmp_path, capsys, monkeypatch):
    """Without a card and without ``--device cpu``, ``render`` exits 1 and
    says how to render on the CPU; it writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst = tmp_path / "d.pfm", tmp_path / "o.pfm"
    save_pfm(str(src), _depth()[0])
    assert CLI.main(["render", str(src), str(dst)]) == 1
    assert "--device cpu" in capsys.readouterr().err
    assert not dst.exists()


@pytest.mark.parametrize("fn", ["save_ao_image", "save_composite_image",
                                "load_depth_image"])
def test_io_copies_equal_tpuao(fn, tmp_path):
    """``utils/io.py``'s copies write and read what tpuao's do."""
    from tpuao.utils import io as JIO

    from tpuao_torch.utils import io as TIO

    rng = np.random.default_rng(3)
    ao = rng.uniform(-0.1, 1.1, (H, W))
    color = rng.uniform(0, 1, (H, W, 3))
    if fn == "load_depth_image":
        TIO.save_ao_image(ao, str(tmp_path / "img.png"))
        np.testing.assert_array_equal(
            TIO.load_depth_image(str(tmp_path / "img.png"), 0.1, 0.9),
            JIO.load_depth_image(str(tmp_path / "img.png"), 0.1, 0.9))
        return
    args = (ao,) if fn == "save_ao_image" else (color, ao)
    a = getattr(JIO, fn)(*args, str(tmp_path / "a.png"))
    b = getattr(TIO, fn)(*args, str(tmp_path / "b.png"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()

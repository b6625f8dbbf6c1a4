"""tpuao_torch.serving against tpuao.serving, side by side on the CPU.

Both servers run in-process on 127.0.0.1:0 with ``batch_size=4`` and get
the requests of chip_smoke.py's serving phase at 96x128: stateless direct
requests with tunables, concurrent batched ones, an ULTRA normals request,
``out=png``, 8-frame dolly sessions at ``resolve_level`` 0 and 1, a 3-frame
motion-vector session and a DELETE, plus the guard rails.  Status codes
must be identical and AO equal to 1e-5 (float32 against float32; the
port's pair test rounds in another order).  The two faults of the
reference that ROADMAP queue 3 lists are pinned with the port's intended
behaviour.  Frames are made with numpy from a seed.
"""

import io
import json
import math
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpuao import serving as JS
from tpuao.models import pipeline as JP

from tpuao_torch import serving as S
from tpuao_torch.models import pipeline as TP
from tpuao_torch.models.pipeline import (AmbientOcclusionEngine,
                                         TemporalAOEngine, render_frame)
from tpuao_torch.params import AOParams, CameraParams
from tpuao_torch.utils import fixtures as F
from tpuao_torch.utils import resilience
from tpuao_torch.utils.frameio import dumps_pfm, loads_pfm

TOL = 1e-5
H, W = 96, 128
CAM = CameraParams(depth_mode="linear")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def start(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


def stop(srv):
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def pair():
    """(port base URL, tpuao base URL, port server, tpuao server)."""
    mine = S.make_server(0, batch_size=4, device="cpu")
    theirs = JS.make_server(0, batch_size=4)
    yield start(mine), start(theirs), mine, theirs
    stop(mine)
    stop(theirs)


def post(base, qs, body, method="POST", path="/ao"):
    """-> (status, payload, headers)."""
    req = urllib.request.Request(f"{base}{path}?{qs}" if qs else
                                 f"{base}{path}", data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def both(pair, qs, body, **kw):
    """The same request to both servers; statuses must agree."""
    a, b = post(pair[0], qs, body, **kw), post(pair[1], qs, body, **kw)
    assert a[0] == b[0], (qs, a[0], a[1][:200], b[0], b[1][:200])
    return a, b


def same_ao(a, b):
    got, want = loads_pfm(a[1]), loads_pfm(b[1])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL)
    return got


def scene(seed, normals=False, eye=None):
    out = F.spheres_on_plane(H, W, CAM, n_spheres=3, seed=seed,
                             with_normals=normals, eye=eye)
    return tuple(x.astype(np.float32) for x in out) if normals else \
        out.astype(np.float32)


def views(n):
    out = []
    for t in range(n):
        v = np.eye(4)
        v[:3, 3] = [-0.05 * t, 0.0, -0.04 * t]
        out.append(v)
    return out


def vq(v):
    return ",".join(repr(float(x)) for x in np.asarray(v).ravel())


def test_stateless_requests_side_by_side(pair):
    zs = [scene(s) for s in range(4)]
    for i, z in enumerate(zs):  # the direct route, with tunables
        qs = f"strength={1.0 + 0.5 * i}&rejection_falloff={2.0 + i}"
        got = same_ao(*both(pair, qs, dumps_pfm(z)))
        want = render_frame(z, CAM, AOParams(strength=1.0 + 0.5 * i,
                                             rejection_falloff=2.0 + i),
                            device="cpu")
        np.testing.assert_array_equal(got, want.numpy())
    # camera overrides ride per request
    a, b = both(pair, "fov=80&far=50", dumps_pfm(zs[0]))
    got = same_ao(a, b)
    cam80 = CAM.replace(far=50.0, tan_half_fov_h=math.tan(math.radians(40)))
    np.testing.assert_array_equal(got, render_frame(zs[0], cam80,
                                                    device="cpu").numpy())
    # ULTRA: a normals frame flips use_normals
    z, n = scene(7, normals=True)
    got = same_ao(*both(pair, "", dumps_pfm(z) + dumps_pfm(n)))
    want = AmbientOcclusionEngine(CAM, AOParams(use_normals=True),
                                  device="cpu").render(z, normals=n)
    np.testing.assert_array_equal(got, want.numpy())
    # composite without normals, positional override
    col = np.random.default_rng(3).uniform(0, 1, (H, W, 3)).astype(
        np.float32)
    same_ao(*both(pair, "buffers=depth,color",
                  dumps_pfm(zs[1]) + dumps_pfm(col)))
    # out=png: the same 8-bit encoding, codes within one step
    a, b = both(pair, "out=png", dumps_pfm(zs[1]))
    assert a[2]["Content-Type"] == b[2]["Content-Type"] == "image/png"
    from PIL import Image

    ca, cb = (np.asarray(Image.open(io.BytesIO(x[1]))).astype(int)
              for x in (a, b))
    assert ca.shape == (H, W) and np.abs(ca - cb).max() <= 1


@pytest.mark.parametrize("qs,body", [
    ("nonsense=1", "z"), ("out=jpg", "z"), ("strength=50", "z"),
    ("far=0.05", "z"), ("near=0", "z"), ("fov=200", "z"),
    ("", "z3"), ("buffers=depth,normals", "z"), ("buffers=color,depth", "zz"),
    ("view=" + ",".join(["0"] * 16), "z"), ("reset=1", "z"),
    ("history_weight=0.5", "z"), ("resolve_level=1", "z"),
    ("session=bad/chars", "z"), ("session=s9&view=1,2,3", "z"),
    ("session=s9&resolve_level=2", "z"),
    ("session=s9&view=" + ",".join(["0"] * 16) + "&motion="
     + ",".join(["0"] * 16), "z"),
    ("buffers=depth,mv", "zm"), ("session=s9&buffers=mv,depth", "zm"),
    ("session=s9&buffers=depth,mv", "zz"),
    ("session=s9&buffers=depth,mv&motion=" + ",".join(["0"] * 16), "zm"),
    ("", "normals-mismatch"), ("", "empty")])
def test_guard_rails_same_status(pair, qs, body):
    z = scene(2)
    mv = np.zeros((H, W, 3), np.float32)
    bodies = {"z": dumps_pfm(z), "z3": dumps_pfm(np.zeros((8, 8, 3))),
              "zz": dumps_pfm(z) + dumps_pfm(z),
              "zm": dumps_pfm(z) + dumps_pfm(mv),
              "normals-mismatch": dumps_pfm(z) + dumps_pfm(
                  np.zeros((8, 8, 3))),
              "empty": b" "}
    a, b = both(pair, qs, bodies[body])
    assert a[0] == 400
    assert a[1] == b[1]  # the same message


def test_batched_route_side_by_side(pair):
    zs = [scene(20 + s) for s in range(4)]
    res = {}

    def go(i, k):
        res[i, k] = post(pair[k], "", dumps_pfm(zs[i]))

    ts = [threading.Thread(target=go, args=(i, k)) for i in range(4)
          for k in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    for i, z in enumerate(zs):
        assert res[i, 0][0] == res[i, 1][0] == 200
        got = same_ao(res[i, 0], res[i, 1])
        np.testing.assert_array_equal(got, render_frame(z, CAM,
                                                        device="cpu").numpy())
    for base in pair[:2]:
        st = json.loads(post(base, "", None, method="GET",
                             path="/stats")[1])
        b = st["batcher"]
        assert st["batched"] >= 4 and b["frames"] >= 4
        # the invariant that holds at any timing (the reference's own
        # test asserts frames + padded == 2 * flushes, which a slow host
        # breaks: a lone request flushes on rung 1)
        assert b["frames"] + b["padded"] == sum(
            int(r) * n for r, n in b["rung_flushes"].items())


@pytest.mark.parametrize("rl", [0, 1])
def test_dolly_session_side_by_side(pair, rl):
    frames = [scene(5, eye=(0.05 * t, 0.0, 0.04 * t)) for t in range(8)]
    ref = TemporalAOEngine(CAM, resolve_level=rl, device="cpu")
    sid = f"dolly{rl}"
    for t, (z, v) in enumerate(zip(frames, views(8))):
        a, b = both(pair, f"session={sid}&resolve_level={rl}&view={vq(v)}",
                    dumps_pfm(z))
        assert a[0] == 200
        assert a[2]["X-TPUAO-Session-Frame"] == \
            b[2]["X-TPUAO-Session-Frame"] == str(t)
        got = same_ao(a, b)
        np.testing.assert_array_equal(got, ref.render(z, view=v).numpy())
    # reset drops history: frame 0 again
    a, b = both(pair, f"session={sid}&resolve_level={rl}&reset=1",
                dumps_pfm(frames[0]))
    assert a[2]["X-TPUAO-Session-Frame"] == "0"
    same_ao(a, b)
    # a change of resolve_level mid-stream is a 400 in both
    a, b = both(pair, f"session={sid}&resolve_level={1 - rl}",
                dumps_pfm(frames[1]))
    assert a[0] == 400
    # DELETE: 200, then 404
    for code in (200, 404):
        a, b = both(pair, "", None, method="DELETE",
                    path=f"/session/{sid}")
        assert a[0] == code


def test_mv_session_and_tunables_side_by_side(pair):
    z0 = scene(5)
    frames = [np.roll(z0, 2 * t, axis=1) for t in range(3)]
    mv = np.zeros((H, W, 3), np.float32)
    mv[..., 1] = -2.0
    ref = TemporalAOEngine(CAM, device="cpu")
    for t, z in enumerate(frames):
        qs, body = "session=mv", dumps_pfm(z)
        if t:
            qs += "&buffers=depth,mv"
            body += dumps_pfm(mv)
        got = same_ao(*both(pair, qs, body))
        want = ref.render(z, motion=None if t == 0 else mv[..., :2])
        np.testing.assert_array_equal(got, want.numpy())
    # temporal tunables are per-frame overlays
    same_ao(*both(pair, "session=mv&history_weight=0.5&strength=2",
                  dumps_pfm(frames[0])))
    # camera binds at creation; a re-send is fine, a change is a 400
    for qs, code in (("session=cam&fov=80", 200), ("session=cam&fov=80", 200),
                     ("session=cam&fov=60", 400)):
        a, b = both(pair, qs, dumps_pfm(frames[0]))
        assert a[0] == code
    for base in pair[:2]:
        for sid in ("mv", "cam"):
            post(base, "", None, method="DELETE", path=f"/session/{sid}")


def test_get_routes_side_by_side(pair):
    for path in ("/config", "/healthz", "/nope"):
        a, b = both(pair, "", None, method="GET", path=path)
        if path == "/config":
            assert json.loads(a[1]) == json.loads(b[1])
    for method, path in (("POST", "/elsewhere"), ("DELETE", "/x"),
                         ("DELETE", "/session/never")):
        a, b = both(pair, "", b"x" if method == "POST" else None,
                    method=method, path=path)
        assert a[0] == 404


def test_resumed_level1_session_keeps_its_level(pair):
    """Reference fault (tpuao/serving.py:350): an omitted resolve_level on
    a resumed level-1 session is coerced to 0 and rejected.  The port
    resumes the session at its own level."""
    z = scene(8)
    for base in pair[:2]:
        assert post(base, "session=r1&resolve_level=1", dumps_pfm(z))[0] \
            == 200
    mine = post(pair[0], "session=r1", dumps_pfm(z))
    theirs = post(pair[1], "session=r1", dumps_pfm(z))
    assert theirs[0] == 400 and b"resolve_level is fixed" in theirs[1]
    assert mine[0] == 200 and mine[2]["X-TPUAO-Session-Frame"] == "1"
    ref = TemporalAOEngine(CAM, resolve_level=1, device="cpu")
    ref.render(z)
    np.testing.assert_array_equal(loads_pfm(mine[1]), ref.render(z).numpy())
    # a new session without resolve_level is level 0 in both
    for base in pair[:2]:
        post(base, "", None, method="DELETE", path="/session/r1")
        post(base, "session=r0", dumps_pfm(z))
    assert pair[2].sessions["r0"]["engine"].resolve_level == 0
    for base in pair[:2]:
        post(base, "", None, method="DELETE", path="/session/r0")


def test_warm_server_warms_the_motion_vector_session(monkeypatch):
    """Reference fault (tpuao/serving.py:600): warm_server never renders
    a motion-vector frame.  The port's does, at each resolve level."""
    seen, jseen = [], []
    real, jreal = S.render_frame_temporal, JP.render_frame_temporal

    def spy(*a, **kw):
        seen.append((np.ndim(kw.get("motion")), kw.get("resolve_level")))
        return real(*a, **kw)

    def jspy(*a, **kw):
        jseen.append(np.ndim(kw.get("motion")))
        return jreal(*a, **kw)

    monkeypatch.setattr(S, "render_frame_temporal", spy)
    monkeypatch.setattr(JP, "render_frame_temporal", jspy)
    srv, jsrv = S.make_server(0, batch_size=2, device="cpu"), JS.make_server(0)
    try:
        warmed = S.warm_server(srv, (32, 48), ["temporal", "temporal_l1"])
        JS.warm_server(jsrv, (32, 48), ["temporal"])
    finally:
        srv.server_close()
        jsrv.server_close()
    assert (3, 0) in seen and (3, 1) in seen  # (H, W, 2) motion vectors
    assert 3 not in jseen  # the reference warms matrices only
    assert srv.warmed and "depth[temporal static+moving+mv]" in warmed
    assert "depth[temporal_l1 static+moving+mv]" in warmed
    assert "depth[batch 1]" in warmed and "depth[batch 2]" in warmed
    with pytest.raises(ValueError, match="unknown warmup"):
        S.warm_server(srv, (32, 48), ["depthx"])


def test_mesh_and_device_arguments():
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        S.make_server(0, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            S.make_server(0, device="cuda")
    srv = S.make_server(0, device=torch.device("cpu"))
    try:
        assert srv.device == torch.device("cpu") and srv.batcher is None
        assert srv.to_device(None) is None
        assert srv.to_device(np.zeros((2, 2), np.float32)).device == \
            srv.device
    finally:
        srv.server_close()


def test_retries_transient_faults_and_500s_persistent(monkeypatch):
    monkeypatch.setattr(resilience.time, "sleep", lambda s: None)
    real = S.render_frame
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("CUDA error: the launch timed out and was "
                               "terminated")
        return real(*a, **kw)

    monkeypatch.setattr(S, "render_frame", flaky)
    srv = S.make_server(0, device="cpu")
    base = start(srv)
    try:
        z = scene(2)
        code, body, _ = post(base, "", dumps_pfm(z))
        assert code == 200 and calls["n"] == 2
        np.testing.assert_array_equal(loads_pfm(body),
                                      render_frame(z, CAM,
                                                   device="cpu").numpy())

        def sticky(*a, **kw):
            calls["n"] += 1
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")

        monkeypatch.setattr(S, "render_frame", sticky)
        n0 = calls["n"]
        code, body, _ = post(base, "", dumps_pfm(z))
        assert code == 500 and calls["n"] == n0 + 1  # never retried
        assert b"illegal memory access" in body
        st = json.loads(post(base, "", None, method="GET",
                             path="/stats")[1])
        assert (st["ok"], st["errors"], st["direct"]) == (1, 1, 2)
    finally:
        stop(srv)
    srv2 = S.make_server(0, batch_size=2, device="cpu")
    try:
        assert getattr(srv2.batcher._render, "__wrapped__", None) is not None
    finally:
        srv2.server_close()


def test_failed_session_frames_restore_history(monkeypatch):
    srv = S.make_server(0, device="cpu")
    base = start(srv)
    try:
        z = [scene(s) for s in (1, 2, 3)]
        post(base, "session=hf", dumps_pfm(z[0]))
        post(base, "session=hf", dumps_pfm(z[1]))
        real = TP.render_frame_temporal

        def boom(*a, **kw):
            raise RuntimeError("injected persistent fault")

        monkeypatch.setattr(TP, "render_frame_temporal", boom)
        for qs in ("session=hf", "session=hf&reset=1"):
            assert post(base, qs, dumps_pfm(z[2]))[0] == 500
        monkeypatch.setattr(TP, "render_frame_temporal", real)
        code, body, hdr = post(base, "session=hf", dumps_pfm(z[2]))
        assert code == 200 and hdr["X-TPUAO-Session-Frame"] == "2"
        eng = TemporalAOEngine(CAM, device="cpu")
        eng.render(z[0])
        eng.render(z[1])
        np.testing.assert_array_equal(loads_pfm(body),
                                      eng.render(z[2]).numpy())
    finally:
        stop(srv)


def test_session_table_ttl_and_clear_caches():
    srv = S.make_server(0, device="cpu")
    srv.max_sessions = 1
    base = start(srv)
    try:
        z = dumps_pfm(scene(4))
        assert post(base, "session=a", z)[0] == 200
        code, body, hdr = post(base, "session=b", z)
        assert code == 503 and hdr["Retry-After"] and \
            b"session table full" in body
        assert post(base, "session=a", z)[0] == 200  # existing still fine
        srv.session_ttl = 0.0  # the next request sweeps "a"
        assert post(base, "", z)[0] == 200
        assert "a" not in srv.sessions
        srv.session_ttl = 600.0
        assert post(base, "session=b", z)[0] == 200
        code, body, _ = post(base, "", b"", path="/maintenance/clear-caches")
        assert code == 200 and set(json.loads(body)) == {"dropped"}
        st = json.loads(post(base, "", None, method="GET",
                             path="/stats")[1])
        assert st["cache_clears"] == 1 and st["sessions"] == 1
        # nothing warm-up built is dropped: still ready, still renders
        assert post(base, "", None, method="GET", path="/healthz")[0] == 200
        assert post(base, "", z)[0] == 200
    finally:
        stop(srv)


def test_healthz_gates_until_the_first_render():
    srv = S.make_server(0, device="cpu")
    base = start(srv)
    try:
        code, body, _ = post(base, "", None, method="GET", path="/healthz")
        assert code == 503 and b"warming" in body
        post(base, "", dumps_pfm(scene(1)))
        assert post(base, "", None, method="GET", path="/healthz")[0] == 200
    finally:
        stop(srv)


def test_main_parses_like_the_example(capsys):
    with pytest.raises(SystemExit):
        S.main(["0", "--warmup-buffers", "normals"])
    assert "--warmup-buffers needs --warmup" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        S.main(["--help"])
    assert "--device" in capsys.readouterr().out

"""tpuao_torch.client against both servers, on the CPU.

The wire protocol is unchanged by the port, so the port's client must
talk to ``tpuao_torch.serving`` and to ``tpuao.serving`` alike: the same
frames back (1e-5 between the servers, float32 each), the same error
mapping (400 -> ValueError, 5xx -> RuntimeError), the same session
behaviour.  Frames are made with numpy from a seed.
"""

import threading
import urllib.request as ur

import numpy as np
import pytest
import torch

from tpuao import serving as JS

from tpuao_torch import serving as S
from tpuao_torch.client import AOClient, TemporalSession, request_ao
from tpuao_torch.models.pipeline import TemporalAOEngine, render_frame
from tpuao_torch.params import AOParams, CameraParams
from tpuao_torch.utils import fixtures as F

TOL = 1e-5
CAM = CameraParams(depth_mode="linear")
H, W = 64, 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def servers():
    """{"torch": (base, server), "jax": (base, server)}, batch_size=2."""
    out = {name: (_serve(srv), srv) for name, srv in (
        ("torch", S.make_server(0, batch_size=2, device="cpu")),
        ("jax", JS.make_server(0, batch_size=2)))}
    yield out
    for _, srv in out.values():
        srv.shutdown()
        srv.server_close()


@pytest.fixture(scope="module")
def scene():
    z, n = F.spheres_on_plane(H, W, CAM, n_spheres=3, seed=6,
                              with_normals=True)
    col = np.random.default_rng(0).uniform(0, 1, (H, W, 3))
    return z.astype(np.float32), n.astype(np.float32), col.astype(np.float32)


@pytest.mark.parametrize("which", ["torch", "jax"])
def test_render_matches_the_port_locally(servers, scene, which):
    z, nrm, col = scene
    c = AOClient(servers[which][0])
    for kw, params in (({}, AOParams()), ({"strength": 2.0},
                                          AOParams(strength=2.0))):
        np.testing.assert_allclose(c.render(z, **kw),
                                   render_frame(z, CAM, params,
                                                device="cpu").numpy(),
                                   atol=TOL)
    np.testing.assert_allclose(
        c.render(z, normals=nrm),
        render_frame(z, CAM, AOParams(use_normals=True),
                     normals=nrm, device="cpu").numpy(), atol=TOL)
    rgb = c.render(z, color=col)  # sends buffers=depth,color
    assert rgb.shape == (H, W, 3)
    np.testing.assert_allclose(rgb, render_frame(z, CAM, color=col,
                                                 device="cpu").numpy(),
                               atol=TOL)
    png = c.render(z, out="png")
    assert isinstance(png, bytes) and png[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_allclose(request_ao(servers[which][0], z, fov=70.0),
                               c.render(z, fov=70.0), atol=0)


def test_both_servers_agree_through_the_client(servers, scene):
    z, nrm, _ = scene
    a, b = (AOClient(servers[k][0]) for k in ("torch", "jax"))
    np.testing.assert_allclose(a.render(z, rejection_falloff=4.0),
                               b.render(z, rejection_falloff=4.0), atol=TOL)
    outs = [c.render_many([z, np.flip(z, 1).copy(), z], workers=3)
            for c in (a, b)]
    for x, y in zip(*outs):
        np.testing.assert_allclose(x, y, atol=TOL)
    np.testing.assert_array_equal(outs[0][0], outs[0][2])
    with pytest.raises(ValueError, match="holds 1 buffers"):
        a.render_many([z, z], normals=[nrm])


@pytest.mark.parametrize("which", ["torch", "jax"])
def test_client_side_validation_no_round_trip(servers, scene, which):
    z, _, _ = scene
    base, srv = servers[which]
    c = AOClient(base)
    before = srv.stats["requests"]
    with pytest.raises(ValueError, match="unknown override"):
        c.render(z, strengh=2.0)
    with pytest.raises(ValueError, match="outside"):
        c.render(z, strength=1e9)
    with pytest.raises(ValueError, match="fov"):
        c.render(z, fov=270.0)
    with pytest.raises(ValueError, match="out must be"):
        c.render(z, out="jpeg")
    with pytest.raises(ValueError, match="depth must be"):
        c.render(np.zeros((4, 8, 3), np.float32))
    ses = c.session("v")
    with pytest.raises(ValueError, match="not several"):
        ses.render(z, view=np.eye(4), mv=np.zeros((H, W, 2)))
    with pytest.raises(ValueError, match="mv must be"):
        ses.render(z, mv=np.zeros((H, W, 3)))
    with pytest.raises(ValueError, match="view must be"):
        ses.render(z, view=np.eye(3))
    with pytest.raises(ValueError, match="unknown override"):
        ses.render(z, history_wieght=0.5)
    with pytest.raises(ValueError, match="resolve_level"):
        TemporalSession(c, "x", {}, resolve_level=2)
    with pytest.raises(ValueError, match="camera override"):
        TemporalSession(c, "x", {"strength": 1.0})
    assert srv.stats["requests"] == before  # all failed pre-flight


@pytest.mark.parametrize("which", ["torch", "jax"])
def test_server_error_mapping(servers, scene, which, monkeypatch):
    z, nrm, _ = scene
    c = AOClient(servers[which][0])
    with pytest.raises(ValueError, match="normals frame"):
        c.render(z, normals=nrm[:48])

    def boom(*a, **kw):
        raise RuntimeError("render exploded (not transient)")

    monkeypatch.setattr(S if which == "torch" else JS, "render_frame", boom)
    with pytest.raises(RuntimeError, match="HTTP 500"):
        c.render(z, strength=1.5)  # the direct route


def test_transport_retry(servers, scene, monkeypatch):
    z, nrm, _ = scene
    base = servers["torch"][0]
    real = ur.urlopen
    calls = {"n": 0}

    def flaky(req, timeout=None):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ConnectionResetError("peer reset mid-request")
        return real(req, timeout=timeout)

    monkeypatch.setattr(ur, "urlopen", flaky)
    c = AOClient(base, backoff_s=0.0)
    assert c.render(z).shape == z.shape and calls["n"] == 2
    before = calls["n"]
    with pytest.raises(ValueError, match="normals frame"):
        c.render(z, normals=nrm[:48])
    assert calls["n"] == before + 1  # a 400 is never re-sent

    def dead(req, timeout=None):
        calls["n"] += 1
        raise ConnectionResetError("always")

    monkeypatch.setattr(ur, "urlopen", dead)
    before = calls["n"]
    with pytest.raises(ConnectionResetError):
        AOClient(base, retries=1, backoff_s=0.0).render(z)
    assert calls["n"] == before + 2
    before = calls["n"]
    with pytest.raises(ConnectionResetError):  # sessions never re-send
        AOClient(base, retries=3, backoff_s=0.0).session("t").render(z)
    assert calls["n"] == before + 1


@pytest.mark.parametrize("which", ["torch", "jax"])
def test_wait_ready_healthy_stats_config(scene, which):
    srv = (S.make_server(0, device="cpu") if which == "torch"
           else JS.make_server(0))
    base = _serve(srv)
    try:
        c = AOClient(base)
        assert not c.healthy()
        with pytest.raises(TimeoutError):
            c.wait_ready(timeout=0.3, interval=0.1)
        c.render(scene[0])
        assert c.wait_ready(timeout=5.0, interval=0.05) < 5.0
        assert c.stats()["ok"] == 1
        assert c.config()["camera"]["depth_mode"] == "linear"
        with pytest.raises(RuntimeError, match="wrong base_url"):
            AOClient(base + "/nope").healthy()
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("rl", [0, 1])
def test_temporal_session_on_both_servers(servers, rl):
    frames = [F.spheres_on_plane(H, W, CAM, n_spheres=3, seed=5,
                                 eye=(0.05 * t, 0.0, 0.0)).astype(np.float32)
              for t in range(3)]
    vs = []
    for t in range(3):
        v = np.eye(4)
        v[0, 3] = -0.05 * t
        vs.append(v)
    outs = {}
    for which in ("torch", "jax"):
        c = AOClient(servers[which][0])
        with c.session(f"s{rl}", resolve_level=rl, fov=70.0) as ses:
            outs[which] = [ses.render(z, view=v) for z, v in zip(frames, vs)]
            assert ses.last_frame_index == 2
            ses.reset()
            outs[which].append(ses.render(frames[0]))
            assert ses.last_frame_index == 0
        assert f"s{rl}" not in servers[which][1].sessions  # DELETE on exit
        ses.close()  # idempotent
    for a, b in zip(outs["torch"], outs["jax"]):
        np.testing.assert_allclose(a, b, atol=TOL)
    cam70 = CAM.replace(tan_half_fov_h=float(np.tan(np.radians(35.0))))
    ref = TemporalAOEngine(cam70, resolve_level=rl, device="cpu")
    for got, z, v in zip(outs["torch"], frames, vs):
        np.testing.assert_array_equal(got, ref.render(z, view=v).numpy())


def test_session_mv_on_both_servers(servers):
    z0 = F.spheres_on_plane(H, W, CAM, n_spheres=3, seed=5).astype(
        np.float32)
    z1 = np.roll(z0, 2, axis=1)
    mv = np.zeros((H, W, 2), np.float32)
    mv[..., 1] = -2.0
    got = {}
    for which in ("torch", "jax"):
        with AOClient(servers[which][0]).session("mvs") as ses:
            got[which] = (ses.render(z0), ses.render(z1, mv=mv))
    for a, b in zip(got["torch"], got["jax"]):
        np.testing.assert_allclose(a, b, atol=TOL)
    ref = TemporalAOEngine(CAM, device="cpu")
    ref.render(z0)
    np.testing.assert_array_equal(got["torch"][1],
                                  ref.render(z1, motion=mv).numpy())


def test_session_close_swallows_http_errors():
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Fail(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_DELETE(self):
            self.send_response(500)
            self.send_header("Content-Length", "0")
            self.end_headers()

    srv = HTTPServer(("127.0.0.1", 0), Fail)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        c = AOClient(f"http://127.0.0.1:{srv.server_address[1]}")
        with pytest.raises(RuntimeError, match="original"):
            with c.session("s"):
                raise RuntimeError("original failure")
    finally:
        srv.shutdown()
        srv.server_close()


def test_full_session_table_is_a_runtime_error():
    srv = S.make_server(0, device="cpu")
    srv.max_sessions = 0
    base = _serve(srv)
    try:
        with pytest.raises(RuntimeError, match="HTTP 503"):
            AOClient(base).session("c").render(
                np.full((16, 16), 0.5, np.float32))
    finally:
        srv.shutdown()
        srv.server_close()

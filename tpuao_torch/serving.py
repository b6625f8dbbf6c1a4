"""HTTP AO serving: PFM depth in -> PFM (or PNG) AO out.

Counterpart of ``tpuao/serving.py``, with the same routes, rules, status
codes and wire format, so a client of either server talks to both.  One
``AmbientOcclusionEngine`` per process; decoded frames go to the server's
``device`` (``make_server(device=...)``, default the card), and on a CUDA
device every render goes through the port's kernels.  PyTorch runs eagerly, so
nothing compiles: a tunable, a camera or a frame shape costs the same on
its first request as on its hundredth.

API (stdlib HTTP, threaded):

  POST /ao            body = 1-3 concatenated PFM frames (PFM headers are
                      self-delimiting):
                        1 frame  = 'Pf' depth            -> AO out
                        2 frames = depth + 'PF' normals  -> AO out
                        3 frames = depth + normals + 'PF' color
                                                         -> composited out
      ?buffers=depth,color        overrides the positional meaning (a
                                  trailing ``mv`` is a session's per-pixel
                                  motion vectors, see below)
      ?strength=2.0&rejection_falloff=5.0&...   per-request tunables
      ?near=0.1&far=100&fov=60                  per-request camera
      ?out=pfm (default) | png

      ?session=<id>   TEMPORAL session: the server keeps this stream's
                      ``(ao, depth)`` history on its device and resolves
                      each frame against it.  Per-frame camera motion
                      rides ``?view=`` (16 comma-separated floats: this
                      frame's world->eye matrix) or ``?motion=`` (the
                      current->previous eye transform); object motion rides
                      a trailing ``mv`` 'PF' buffer whose first two
                      channels are (di, dj) pixel offsets current->previous
                      (exclusive with view=/motion=).  ``?reset=1`` drops
                      history; ``history_weight=``/``depth_tolerance=`` are
                      per-frame tunables; ``?resolve_level=0|1`` picks the
                      history resolution at creation (omitted on a resumed
                      session: the session's own level).  Camera overrides
                      bind at creation and are rejected mid-stream.
                      Sessions always render on the direct path; idle ones
                      are evicted after ``session_ttl`` seconds; the
                      ``X-TPUAO-Session-Frame`` header returns the frame's
                      index in the session.
  DELETE /session/<id>  drop a session's history
  GET  /config        the engine's AOParams/CameraParams JSON
  GET  /healthz       200 once a frame has rendered (``warm_server``)
  GET  /stats         requests/ok/errors, direct/batched/temporal routing,
                      latency p50/p95/max over the last 1024 requests, and
                      the micro-batcher's flush counters
  POST /maintenance/clear-caches   drop the host-side tables (the pair
                      table and the normals path's per-level m2 tables) and
                      release the CUDA caching allocator's free blocks.
                      There are no compiled programs to drop; the kernel
                      library stays loaded, so /healthz stays as it was.

A caller error is 400, a full session table 503 with ``Retry-After``, a
render fault 500.  Run it with ``python -m tpuao_torch.serving``.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, urlparse

import numpy as np
import torch

from tpuao_torch.models.pipeline import (AmbientOcclusionEngine,
                                         TemporalAOEngine, render_frame,
                                         render_frame_temporal,
                                         resolve_device)
from tpuao_torch.params import (PARAM_RANGES, TEMPORAL_PARAM_RANGES,
                                CameraParams, TemporalParams,
                                params_to_dict)
from tpuao_torch.utils.batching import MicroBatcher, to_host
from tpuao_torch.utils.frameio import dumps_pfm, loads_pfm_multi
from tpuao_torch.utils.resilience import retry_transient

_SESSION_ID_RE = r"[A-Za-z0-9_.-]{1,64}"


class ServerBusy(Exception):
    """Transient resource exhaustion -> HTTP 503 (a full session table,
    which TTL eviction clears); distinct from ``ValueError`` -> 400."""


def _sweep_sessions(srv, now=None):
    """Evict idle temporal sessions.  Runs on every /ao POST and DELETE,
    so the TTL holds when the remaining traffic is stateless.  The caller
    holds ``srv.sessions_lock``."""
    now = time.monotonic() if now is None else now
    for k in [k for k, s in srv.sessions.items()
              if now - s["last"] > srv.session_ttl]:
        del srv.sessions[k]


def _apply_camera_overrides(camera, cam_over):
    """Validated per-request camera: ``fov`` (degrees) converts to
    ``tan_half_fov_h``; the result is range-checked like the tunables."""
    fov = cam_over.pop("fov", None)
    if fov is not None:
        if not 0 < fov < 180:
            raise ValueError(f"fov={fov} outside (0, 180)")
        cam_over["tan_half_fov_h"] = math.tan(math.radians(fov) / 2)
    return camera.replace(**cam_over).validate()


class AOHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet by default
        if self.server.verbose:
            super().log_message(fmt, *args)

    def _send(self, code, body, ctype="application/octet-stream",
              headers=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        path = urlparse(self.path).path
        if path == "/healthz":
            if self.server.warmed:
                self._send(200, b"ok", "text/plain")
            else:
                self._send(503, b"warming: no frame rendered yet",
                           "text/plain")
        elif path == "/stats":
            srv = self.server
            with srv.stats_lock:
                stats = dict(srv.stats)
                lat = sorted(srv.latencies)
            if lat:
                stats["latency_ms"] = {
                    "count": len(lat),
                    "p50": round(lat[len(lat) // 2], 2),
                    "p95": round(lat[int(len(lat) * 0.95)
                                     if len(lat) > 1 else 0], 2),
                    "max": round(lat[-1], 2)}
            stats["sessions"] = len(srv.sessions)
            if srv.batcher is not None:
                stats["batcher"] = srv.batcher.stats()
            self._send(200, json.dumps(stats, indent=2).encode(),
                       "application/json")
        elif path == "/config":
            eng = self.server.engine
            body = json.dumps({"ao": params_to_dict(eng.params),
                               "camera": params_to_dict(eng.camera)},
                              indent=2).encode()
            self._send(200, body, "application/json")
        else:
            self._send(404, b"not found", "text/plain")

    def _count(self, key):
        with self.server.stats_lock:
            self.server.stats[key] += 1

    def do_DELETE(self):
        path = urlparse(self.path).path
        m = re.fullmatch(rf"/session/({_SESSION_ID_RE})", path)
        if not m:
            self._send(404, b"not found", "text/plain")
            return
        with self.server.sessions_lock:
            _sweep_sessions(self.server)
            dropped = self.server.sessions.pop(m.group(1), None)
        if dropped is None:
            self._send(404, b"no such session", "text/plain")
        else:
            self._send(200, b"session dropped", "text/plain")

    def _render_session(self, sid, depth, normals, color, mat, is_view,
                        reset, tunables, t_tunables, cam_over,
                        resolve_level):
        """One temporal-session frame (under the server render lock).
        Returns ``(ao, frame_index)``.

        ``resolve_level`` None (omitted) creates a level-0 session and
        resumes an existing one at its own level.  Every attempt, and a
        terminal failure, restores the session's pre-frame history:
        ``TemporalAOEngine.render`` advances ``_prev_view``/``_state``, so
        a fault mid-frame would otherwise make the next frame derive its
        motion from half-updated state."""
        srv = self.server
        now = time.monotonic()
        with srv.lock:
            # the render serializes on srv.lock; the table takes its own
            # lock (srv.lock first, always)
            with srv.sessions_lock:
                _sweep_sessions(srv, now)
                ses = srv.sessions.get(sid)
                if ses is None:
                    if len(srv.sessions) >= srv.max_sessions:
                        raise ServerBusy(
                            f"session table full ({srv.max_sessions}); "
                            "DELETE /session/<id> or wait for TTL "
                            "eviction")
                    camera = srv.engine.camera
                    if cam_over:
                        camera = _apply_camera_overrides(camera,
                                                         dict(cam_over))
                    ses = {"engine": TemporalAOEngine(
                               camera, srv.engine.params,
                               impl=srv.engine.impl,
                               out_dtype=srv.engine.out_dtype,
                               resolve_level=resolve_level or 0),
                           "last": now, "frames": 0, "created": True}
                    srv.sessions[sid] = ses
            if not ses.pop("created", False) and cam_over:
                # identical re-sends are fine (the client sends the session
                # camera on every frame so a TTL-evicted stream rebinds);
                # only a change is an error
                bound = _apply_camera_overrides(srv.engine.camera,
                                                dict(cam_over))
                if params_to_dict(ses["engine"].camera) != \
                        params_to_dict(bound):
                    raise ValueError(
                        "camera is fixed per session (reprojection "
                        "assumes one camera per sequence); re-sending "
                        "the SAME camera is fine, changing it needs a "
                        "new session= (or DELETE first)")
            ses["last"] = now
            engine = ses["engine"]
            if resolve_level is not None and \
                    resolve_level != engine.resolve_level:
                raise ValueError(
                    "resolve_level is fixed per session (the history "
                    f"lives at that resolution); this session is level "
                    f"{engine.resolve_level} -- start a new session= "
                    "(or DELETE first) to change it")
            # snapshot BEFORE applying reset: a reset frame that fails
            # restores the pre-reset history and frame counter
            saved = (engine._state, engine._prev_view,
                     engine._params, engine._tparams, ses["frames"])
            if reset:
                engine.reset()
                ses["frames"] = 0
            start_state = (engine._state, engine._prev_view)  # post-reset
            # per-request overlays, validated before either is applied
            params = engine.params.replace(**tunables).validate() \
                if tunables else engine.params
            if normals is not None and not params.use_normals:
                params = params.replace(use_normals=True)
            tparams = engine.tparams.replace(**t_tunables).validate() \
                if t_tunables else engine.tparams

            def attempt():
                engine._state, engine._prev_view = start_state
                engine._params, engine._tparams = params, tparams
                return to_host(engine.render(
                    depth, normals=normals, color=color,
                    motion=None if (mat is None or is_view) else mat,
                    view=mat if (mat is not None and is_view) else None))

            try:
                ao = retry_transient(attempt)()
            except BaseException:
                (engine._state, engine._prev_view,
                 engine._params, engine._tparams) = saved[:4]
                ses["frames"] = saved[4]
                raise
            engine._params, engine._tparams = saved[2], saved[3]
            frame = ses["frames"]
            ses["frames"] = frame + 1
            # refresh after the render: ``now`` predates the wait on
            # srv.lock, and a long wait must not backdate the TTL
            ses["last"] = time.monotonic()
            return ao, frame

    def do_POST(self):
        url = urlparse(self.path)
        srv = self.server
        if url.path == "/maintenance/clear-caches":
            with srv.lock:  # behind any in-flight render
                dropped = clear_host_caches()
            self._count("cache_clears")
            self._send(200, json.dumps({"dropped": dropped}).encode(),
                       "application/json")
            return
        if url.path != "/ao":
            self._send(404, b"not found", "text/plain")
            return
        t0 = time.perf_counter()
        self._count("requests")
        with srv.sessions_lock:
            _sweep_sessions(srv)
        try:
            q = dict(parse_qsl(url.query))
            out_fmt = q.pop("out", "pfm")
            if out_fmt not in ("pfm", "png"):
                raise ValueError(f"unknown out={out_fmt}")
            buf_names = q.pop("buffers", None)
            sid = q.pop("session", None)
            reset = q.pop("reset", "0") not in ("0", "", "false")
            rl_s = q.pop("resolve_level", None)
            if rl_s is not None and rl_s not in ("0", "1"):
                raise ValueError("resolve_level must be 0 or 1, "
                                 f"got {rl_s!r}")
            resolve_level = None if rl_s is None else int(rl_s)
            view_s = q.pop("view", None)
            motion_s = q.pop("motion", None)
            tunables = {k: float(v) for k, v in q.items()
                        if k in PARAM_RANGES}
            t_tunables = {k: float(v) for k, v in q.items()
                          if k in TEMPORAL_PARAM_RANGES}
            cam_over = {k: float(q[k]) for k in ("near", "far", "fov")
                        if k in q}
            unknown = (set(q) - set(tunables) - set(t_tunables)
                       - set(cam_over))
            if unknown:
                raise ValueError(f"unknown query params: {sorted(unknown)}")
            if sid is None and (reset or view_s is not None
                                or motion_s is not None or t_tunables
                                or rl_s is not None):
                raise ValueError("reset/view/motion/resolve_level/"
                                 "temporal tunables need session=")
            if sid is not None and not re.fullmatch(_SESSION_ID_RE, sid):
                raise ValueError(
                    f"session= must match {_SESSION_ID_RE}")
            if view_s is not None and motion_s is not None:
                raise ValueError("pass view= or motion=, not both")
            mat = None
            if view_s is not None or motion_s is not None:
                vals = [float(x) for x in
                        (view_s or motion_s).split(",")]
                if len(vals) != 16:
                    raise ValueError("view=/motion= must be 16 comma-"
                                     f"separated floats, got {len(vals)}")
                mat = np.asarray(vals, np.float64).reshape(4, 4)
            n = int(self.headers.get("Content-Length", "0"))
            if not 0 < n <= srv.max_body:
                raise ValueError(
                    f"body size {n} outside (0, {srv.max_body}]")
            frames = loads_pfm_multi(self.rfile.read(n))
            names = ([s.strip() for s in buf_names.split(",") if s.strip()]
                     if buf_names is not None
                     else ["depth", "normals", "color"][:len(frames)])
            if len(names) != len(frames):
                raise ValueError(f"buffers= names {len(names)} frames but "
                                 f"the body holds {len(frames)}")
            has_mv = bool(names) and names[-1] == "mv"
            core = names[1:-1] if has_mv else names[1:]
            if not names or names[0] != "depth" or core not in (
                    [], ["normals"], ["color"], ["normals", "color"]):
                raise ValueError(
                    "buffers= must be depth[,normals][,color][,mv] in "
                    f"order, got {names}")
            if has_mv:
                if sid is None:
                    raise ValueError("an mv buffer needs session=")
                if mat is not None:
                    raise ValueError("pass an mv buffer or view=/motion=, "
                                     "not both")
            bufs = dict(zip(names, frames))
            depth = bufs["depth"]
            if depth.ndim != 2:
                # a 3-channel first frame would read as a leading batch
                raise ValueError("first frame must be a single-channel "
                                 f"'Pf' depth, got shape {depth.shape}")
            normals = bufs.get("normals")
            if normals is not None and (
                    normals.ndim != 3 or normals.shape[-1] != 3
                    or normals.shape[:2] != depth.shape):
                raise ValueError("normals frame must be 'PF' (H, W, 3) "
                                 f"matching depth {depth.shape}, got "
                                 f"{normals.shape}")
            color = bufs.get("color")
            if color is not None and color.shape[:2] != depth.shape:
                raise ValueError(f"color frame shape {color.shape} does "
                                 f"not match depth {depth.shape}")
            mv = bufs.get("mv")
            if mv is not None:
                if (mv.ndim != 3 or mv.shape[-1] != 3
                        or mv.shape[:2] != depth.shape):
                    raise ValueError("mv frame must be 'PF' (H, W, 3) "
                                     f"matching depth {depth.shape}, got "
                                     f"{mv.shape}")
                mat = srv.to_device(np.ascontiguousarray(mv[..., :2]))
            eng = srv.engine
            direct = bool(tunables or cam_over or srv.batcher is None)
            self._count("temporal" if sid is not None
                        else "direct" if direct else "batched")
            extra_headers = ()
            if sid is not None:
                ao, frame_idx = self._render_session(
                    sid, srv.to_device(depth), srv.to_device(normals),
                    srv.to_device(color), mat, view_s is not None, reset,
                    tunables, t_tunables, cam_over, resolve_level)
                # frame 0 on a frame the client thought was mid-stream
                # means TTL eviction restarted the accumulation
                extra_headers = (("X-TPUAO-Session-Frame",
                                  str(frame_idx)),)
            elif direct:
                with srv.lock:
                    params = eng.params.replace(**tunables).validate() \
                        if tunables else eng.params
                    if normals is not None and not params.use_normals:
                        params = params.replace(use_normals=True)
                    camera = eng.camera
                    if cam_over:
                        camera = _apply_camera_overrides(camera, cam_over)
                    # the retried call includes the copy to the host: a
                    # fault of an asynchronous launch surfaces there.
                    # render_frame is looked up per call so tests can
                    # replace ``serving.render_frame``.
                    ao = retry_transient(
                        lambda *a, **kw: to_host(render_frame(*a, **kw)))(
                        srv.to_device(depth), camera, params,
                        normals=srv.to_device(normals),
                        color=srv.to_device(color), impl=eng.impl)
            else:
                # default-tunable requests ride the micro-batcher
                ao = srv.batcher.submit(
                    depth, normals=normals, color=color).result()
            # encode inside the try: an encode fault is a counted 500
            if out_fmt == "png":
                from tpuao_torch.utils.io import encode_ao_png

                body, ctype = encode_ao_png(ao), "image/png"
            else:
                body, ctype = dumps_pfm(ao), "application/x-pfm"
        except ServerBusy as e:
            self._count("errors")
            self._send(503, str(e).encode(), "text/plain",
                       headers=(("Retry-After", "5"),))
            return
        except ValueError as e:
            self._count("errors")
            self._send(400, str(e).encode(), "text/plain")
            return
        except Exception as e:  # render fault: a counted 500
            self._count("errors")
            self._send(500, f"{type(e).__name__}: {e}".encode(),
                       "text/plain")
            return
        srv.warmed = True
        with srv.stats_lock:
            srv.stats["ok"] += 1
            srv.latencies.append((time.perf_counter() - t0) * 1e3)
        self._send(200, body, ctype, headers=extra_headers)


def clear_host_caches() -> int:
    """Drop the kernels' host-side tables (``ops/kernels.py``'s
    ``pair_table`` and ``_m2_table``) and release the CUDA caching
    allocator's free blocks; returns the number of table entries
    dropped."""
    from tpuao_torch.ops import kernels as K

    dropped = 0
    for fn in (K.pair_table, K._m2_table):
        dropped += fn.cache_info().currsize
        fn.cache_clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return dropped


def warm_server(srv, shape, buffers=()) -> list[str]:
    """Render every path the /ao handler can take for one frame shape, so
    the first real request pays no set-up; returns the names warmed.

    On a CUDA server the first render builds the kernels' library.  For
    every combination of ``buffers``' ``normals``/``color`` (the empty
    depth-only one included) it renders the direct path and, with a
    micro-batcher, every rung of its ladder.  ``"temporal"`` adds the
    ``?session=`` paths: a static and a moving camera, and a motion-vector
    frame; ``"temporal_l1"`` adds the same at ``resolve_level=1``.  Marks
    the server warm."""
    from itertools import combinations

    h, w = shape
    buffers = set(buffers)
    temporal = "temporal" in buffers or "temporal_l1" in buffers
    levels = (0, 1) if "temporal_l1" in buffers else (0,)
    buffers -= {"temporal", "temporal_l1"}
    unknown = buffers - {"normals", "color"}
    if unknown:
        raise ValueError(f"unknown warmup buffers {sorted(unknown)} "
                         "(choose from normals,color,temporal,"
                         "temporal_l1)")
    zz = np.full((h, w), 0.5, np.float32)
    nrm = np.zeros((h, w, 3), np.float32)
    nrm[..., 2] = 1.0
    col = np.full((h, w, 3), 0.5, np.float32)
    eng = srv.engine
    dev = srv.to_device
    warmed = []
    wants = sorted(buffers)
    for combo in (c for r in range(len(wants) + 1)
                  for c in combinations(wants, r)):
        kw = {}
        if "normals" in combo:
            kw["normals"] = nrm
        if "color" in combo:
            kw["color"] = col
        dkw = {k: dev(v) for k, v in kw.items()}
        params = (eng.params.replace(use_normals=True)
                  if "normals" in combo else eng.params)
        to_host(render_frame(dev(zz), eng.camera, params, impl=eng.impl,
                             **dkw))
        name = "depth" + ("+" + "+".join(combo) if combo else "")
        warmed.append(name)
        for rl in levels if temporal else ():
            tp = TemporalParams()
            common = dict(impl=eng.impl, out_dtype=eng.out_dtype,
                          resolve_level=rl, **dkw)
            _, st = render_frame_temporal(dev(zz), None, eng.camera, params,
                                          tp, **common)
            for motion in (np.eye(4, dtype=np.float32),
                           dev(np.zeros((h, w, 2), np.float32))):
                to_host(render_frame_temporal(dev(zz), st, eng.camera,
                                              params, tp, motion=motion,
                                              **common)[0])
            tag = "temporal" if rl == 0 else "temporal_l1"
            warmed.append(f"{name}[{tag} static+moving+mv]")
        if srv.batcher is not None:
            rungs = srv.batcher.warm(zz, **kw)
            warmed.extend(f"{name}[batch {r}]" for r in rungs)
    srv.warmed = True
    return warmed


class AOServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that also shuts the micro-batcher down."""

    batcher = None

    def server_close(self):
        if self.batcher is not None:
            self.batcher.close()
        super().server_close()

    def to_device(self, a):
        """A decoded host buffer on the server's device (None stays)."""
        return None if a is None else torch.as_tensor(a, device=self.device)


def make_server(port: int = 0, engine: AmbientOcclusionEngine | None = None,
                verbose: bool = False, batch_size: int = 0, mesh=None,
                device="cuda") -> AOServer:
    """Build (not start) the server on 127.0.0.1; ``port=0`` picks a free
    port.  Decoded frames go to ``device`` ("cuda", the default, "cpu",
    a ``torch.device``); on a CUDA device every render launches the
    kernels, and with no card there this raises.  ``batch_size > 0``
    routes default-tunable requests through a
    ``utils.batching.MicroBatcher``; requests that override tunables or
    the camera render directly.  ``mesh`` is accepted only as None: the
    view-sharded fleet is ROADMAP item 9 (multi-GPU)."""
    if mesh is not None:
        raise NotImplementedError(
            "make_server(mesh=...): view-sharded serving across cards is "
            "not ported yet (ROADMAP item 9, multi-GPU)")
    device = resolve_device(device)
    srv = AOServer(("127.0.0.1", port), AOHandler)
    srv.device = device
    srv.engine = engine or AmbientOcclusionEngine(
        CameraParams(depth_mode="linear"))
    srv.lock = threading.Lock()  # one frame in flight per process
    srv.verbose = verbose
    srv.warmed = False  # /healthz turns 200 after the first render
    srv.stats_lock = threading.Lock()
    srv.stats = {"requests": 0, "ok": 0, "errors": 0,
                 "direct": 0, "batched": 0, "temporal": 0,
                 "cache_clears": 0}
    srv.sessions = {}  # temporal sessions: id -> {engine, last, frames}
    srv.sessions_lock = threading.Lock()  # table only, never held on render
    srv.session_ttl = 600.0  # idle seconds before history is evicted
    srv.max_sessions = 64
    srv.latencies = deque(maxlen=1024)  # end-to-end ms, ok requests only
    # the largest legal body is an 8K depth + 'PF' normals + 'PF' color
    # request: ~133 + 398 + 398 MB; reject above 1 GiB
    srv.max_body = 1024 << 20
    if batch_size:
        eng = srv.engine

        def batched_render(d, normals=None, color=None):
            # a normals flush flips use_normals like the direct path
            # (flushes are homogeneous); the copy to the host is inside
            # the retried call
            params = eng.params
            if normals is not None and not params.use_normals:
                params = params.replace(use_normals=True)
            return to_host(render_frame(
                srv.to_device(d), eng.camera, params,
                normals=srv.to_device(normals), color=srv.to_device(color),
                impl=eng.impl))

        srv.batcher = MicroBatcher(retry_transient(batched_render),
                                   batch_size=batch_size)
    return srv


def build_parser():
    """The command line of ``python -m tpuao_torch.serving``."""
    import argparse

    ap = argparse.ArgumentParser(description="tpuao_torch AO serving "
                                 "endpoint (PyTorch / CUDA)")
    ap.add_argument("port", nargs="?", type=int, default=8080)
    ap.add_argument("--device", default="cuda",
                    help="where frames render: cuda (default) or cpu")
    ap.add_argument("--config", help="engine config JSON (save_config)")
    ap.add_argument("--batch", type=int, default=0,
                    help="micro-batch size for default-tunable requests")
    ap.add_argument("--warmup", metavar="HxW",
                    help="render every path once for this frame shape "
                    "before serving")
    ap.add_argument("--warmup-buffers", metavar="LIST",
                    help="with --warmup: comma list from {normals,color,"
                    "temporal,temporal_l1}; every combination of normals "
                    "and color is warmed, 'temporal' adds the ?session= "
                    "paths")
    return ap


def main(argv=None) -> None:
    """``python -m tpuao_torch.serving [port] [--device cpu] ...``: the
    front end of ``examples/serve.py`` for the port (frames render on the
    card unless ``--device cpu``)."""
    ap = build_parser()
    a = ap.parse_args(argv)
    if a.warmup_buffers and not a.warmup:
        ap.error("--warmup-buffers needs --warmup HxW")
    eng = AmbientOcclusionEngine.from_config(a.config) if a.config else None
    srv = make_server(a.port, eng, verbose=True, batch_size=a.batch,
                      device=a.device)
    if a.warmup:
        h, w = (int(v) for v in a.warmup.split("x"))
        bufs = ([s.strip() for s in a.warmup_buffers.split(",")
                 if s.strip()] if a.warmup_buffers else ())
        try:
            warmed = warm_server(srv, (h, w), bufs)
        except ValueError as e:
            ap.error(str(e))
        print(f"warmed up for {h}x{w}: {', '.join(warmed)}")
    print(f"tpuao_torch serving on http://127.0.0.1:{srv.server_address[1]} "
          f"on {srv.device} (POST /ao, GET /config, GET /healthz)",
          flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()

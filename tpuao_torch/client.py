"""Thin HTTP client for the AO serving endpoint.

Counterpart of ``tpuao/client.py``, with the same classes, methods and
wire protocol, so it talks to either package's server
(``tpuao_torch.serving`` or ``tpuao.serving``).  It imports only NumPy,
the PFM bytes codec (``utils.frameio``) and the tunable tables
(``params``), so capture rigs and render farms need no device to use it.

    from tpuao_torch.client import AOClient
    c = AOClient("http://gpu-host:8080")
    c.wait_ready()                      # /healthz gates on warm-up
    ao = c.render(depth)                                  # (H, W) f32
    ao = c.render(depth, strength=2.0, fov=70.0)          # per request
    ao = c.render(depth, normals=nrm)                     # 'PF' normals
    rgb = c.render(depth, normals=nrm, color=col)         # composited
    png = c.render(depth, out="png")                      # encoded bytes

Tunables are validated client-side against ``PARAM_RANGES`` (fail fast,
no round trip); the server re-validates.  Server-side 400s surface as
``ValueError`` with the server's message, 5xx as ``RuntimeError`` -- the
same split the serving layer makes between caller errors and backend
faults.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np

from tpuao_torch.params import PARAM_RANGES, TEMPORAL_PARAM_RANGES
from tpuao_torch.utils.frameio import dumps_pfm, loads_pfm

_CAMERA_KEYS = ("near", "far", "fov")


class AOClient:
    """Client for one AO server. ``base_url`` like ``http://host:port``.

    ``retries`` re-sends a render request after TRANSPORT-level faults
    (connection refused/reset, a server restart mid-request) -- renders
    are pure, so a re-send is safe.  HTTP-status errors are never
    retried here: 400s are caller errors, and the server already
    retries its own transient device-fault class internally before
    500ing (each layer retries exactly its own fault class)."""

    def __init__(self, base_url: str, timeout: float = 600.0,
                 retries: int = 2, backoff_s: float = 1.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.retries = retries
        self.backoff_s = backoff_s

    # -- plumbing ------------------------------------------------------------

    def _get(self, path: str) -> bytes:
        with urllib.request.urlopen(self.base_url + path,
                                    timeout=self.timeout) as r:
            return r.read()

    def _get_json(self, path: str) -> dict:
        return json.loads(self._get(path))

    # -- observability -------------------------------------------------------

    def healthy(self) -> bool:
        """True once the server has rendered a frame (GET /healthz).

        503 reads as "still warming" -> False.  Any OTHER status raises
        (a 404 means a mistyped base_url, not a warming server -- it
        must fail fast, not be polled for 900 s); transport errors
        (refused / reset / mid-restart) propagate to the caller."""
        try:
            self._get("/healthz")
            return True
        except urllib.error.HTTPError as e:
            if e.code == 503:
                return False
            raise RuntimeError(
                f"unexpected HTTP {e.code} from {self.base_url}/healthz "
                "(wrong base_url?)") from None

    def wait_ready(self, timeout: float = 900.0,
                   interval: float = 2.0) -> float:
        """Poll /healthz until ready; returns seconds waited.

        A server warms up before it serves (building the kernels, a
        first render per path) -- callers should gate traffic on this,
        not on TCP connect.  Transport-level faults (not yet
        listening, connection refused/reset mid-restart) keep polling;
        a non-503 HTTP status still fails fast via ``healthy``."""
        import http.client

        t0 = time.monotonic()
        while True:
            try:
                if self.healthy():
                    return time.monotonic() - t0
            # OSError covers URLError AND the bare socket faults urllib
            # lets through (RemoteDisconnected is a ConnectionResetError);
            # HTTPException covers the rest of the mid-restart zoo
            except (OSError, http.client.HTTPException):
                pass
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"server {self.base_url} not ready after {timeout} s")
            time.sleep(interval)

    def config(self) -> dict:
        """The engine's current AOParams/CameraParams (GET /config)."""
        return self._get_json("/config")

    def stats(self) -> dict:
        """Server observability counters (GET /stats)."""
        return self._get_json("/stats")

    # -- rendering -----------------------------------------------------------

    def render(self, depth, normals=None, color=None, *, out: str = "pfm",
               **overrides):
        """POST one frame; returns (H, W[, 3]) float32, or PNG bytes.

        ``depth`` is (H, W) float32 in the server engine's depth
        convention (the stock server expects normalized linear depth);
        ``normals``/``color`` are optional (H, W, 3) buffers riding the
        same body as concatenated PFM frames.  ``overrides`` are the
        per-request knobs: any tunable in ``PARAM_RANGES`` plus camera
        ``near``/``far``/``fov``."""
        if out not in ("pfm", "png"):
            raise ValueError(f"out must be 'pfm' or 'png', got {out!r}")
        q = {}
        for k, v in overrides.items():
            if k in PARAM_RANGES:
                lo, hi = PARAM_RANGES[k]
                v = float(v)
                if not lo <= v <= hi:
                    raise ValueError(
                        f"{k}={v} outside [{lo}, {hi}]")
            elif k == "fov":
                v = float(v)
                if not 0 < v < 180:
                    raise ValueError(f"fov={v} outside (0, 180)")
            elif k in _CAMERA_KEYS:
                v = float(v)
            else:
                raise ValueError(
                    f"unknown override {k!r}: tunables are "
                    f"{sorted(PARAM_RANGES)} plus camera {_CAMERA_KEYS}")
            q[k] = repr(v)
        depth = np.asarray(depth, np.float32)
        if depth.ndim != 2:
            raise ValueError(f"depth must be (H, W), got {depth.shape}")
        frames = [depth]
        if normals is not None:
            frames.append(np.asarray(normals, np.float32))
        if color is not None:
            frames.append(np.asarray(color, np.float32))
            if normals is None:
                # positional meaning of frame 2 defaults to normals
                q["buffers"] = "depth,color"
        if out != "pfm":
            q["out"] = out
        body = b"".join(dumps_pfm(f) for f in frames)
        payload, _ = self._post_ao(q, body, self.retries)
        return payload if out == "png" else loads_pfm(payload)

    def _post_ao(self, q: dict, body: bytes,
                 retries: int) -> tuple[bytes, dict]:
        """POST /ao; returns ``(payload, response headers)``."""
        import http.client

        qs = ("?" + urllib.parse.urlencode(q)) if q else ""
        attempt = 0
        while True:
            req = urllib.request.Request(f"{self.base_url}/ao{qs}",
                                         data=body)
            try:
                with urllib.request.urlopen(req,
                                            timeout=self.timeout) as r:
                    return r.read(), dict(r.headers)
            except urllib.error.HTTPError as e:
                msg = e.read().decode(errors="replace")
                if e.code == 400:  # caller error; the message says why
                    raise ValueError(
                        f"server rejected request: {msg}") from None
                raise RuntimeError(
                    f"server error HTTP {e.code}: {msg}") from None
            except (OSError, http.client.HTTPException):
                # transport fault (refused/reset/mid-restart): stateless
                # renders are pure, re-sending is safe (sessions pass
                # retries=0 -- see TemporalSession)
                if attempt >= retries:
                    raise
                attempt += 1
                time.sleep(self.backoff_s * attempt)


    def render_many(self, depths, *, normals=None, color=None,
                    workers: int = 8, **kw):
        """Render a sequence of depth frames via concurrent requests.

        The server's ``MicroBatcher`` only batches requests that are IN
        FLIGHT TOGETHER -- a sequential client loop leaves every flush
        at size 1, paying the full per-launch dispatch per frame.  This
        fans the frames out over ``workers``
        threads so same-shape frames actually share batched flushes.

        ``normals``/``color`` may be ``None``, ONE (H, W, 3) buffer
        shared by every frame (a fixed camera's normals), or a sequence
        with one buffer per depth frame.  Returns results in input
        order; a failed frame re-raises its error after the pool
        drains."""
        from concurrent.futures import ThreadPoolExecutor

        depths = list(depths)

        def per_frame(buf, name):
            if buf is None:
                return [None] * len(depths)
            if isinstance(buf, np.ndarray) and buf.ndim == 3:
                return [buf] * len(depths)  # one buffer, every frame
            buf = list(buf)
            if len(buf) != len(depths):
                raise ValueError(f"{name} holds {len(buf)} buffers for "
                                 f"{len(depths)} depth frames")
            return buf

        nrms = per_frame(normals, "normals")
        cols = per_frame(color, "color")
        with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
            futs = [pool.submit(self.render, d, normals=n, color=c, **kw)
                    for d, n, c in zip(depths, nrms, cols)]
            return [f.result() for f in futs]


    # -- temporal sessions ---------------------------------------------------

    def session(self, session_id: str | None = None,
                resolve_level: int = 0,
                **camera_overrides) -> "TemporalSession":
        """Open a handle on a server temporal session (``?session=``).

        ``camera_overrides`` (``near``/``far``/``fov``) bind at session
        creation -- the server rejects camera changes mid-stream (the
        reprojection assumes one camera per sequence).
        ``resolve_level=1`` selects the server's half-res level-1
        resolve (the moving-camera fast path; fixed per session like the
        camera).  Use as a context manager to DELETE the server-side
        history on exit."""
        import uuid

        return TemporalSession(self, session_id or uuid.uuid4().hex,
                               camera_overrides, resolve_level)


class TemporalSession:
    """One temporally-accumulated stream against a server session.

    The server keeps this stream's ``(ao, depth)`` history device-side;
    each ``render`` resolves the new frame against it.  Pass ``view=``
    (this frame's 4x4 world->eye matrix) or ``motion=`` (the current->
    previous eye transform) for a moving camera, or ``mv=`` ((H, W, 2)
    per-pixel current->previous offsets in pixels -- the OBJECT-motion
    path, spec golden/temporal.py; rides the body as a 'PF' buffer);
    omit all three when static.

    The session camera rides EVERY frame (the server accepts identical
    re-sends and rejects only changes), so a stream resumed after the
    server TTL-evicted its history rebinds the right camera
    automatically.  ``last_frame_index`` mirrors the server's
    ``X-TPUAO-Session-Frame`` header: if it comes back 0 on a frame you
    thought was mid-stream, the accumulation restarted (TTL eviction)
    -- correct but un-accumulated output.

    Transport-level retries are DISABLED for session frames: a re-send
    after a lost response would advance the server's history twice
    (stateless renders are pure; temporal frames are not).  On a
    transport fault, call ``reset()`` and re-stream from a key frame.
    """

    def __init__(self, client: AOClient, session_id: str, cam: dict,
                 resolve_level: int = 0):
        self.client = client
        self.id = session_id
        for k in cam:
            if k not in _CAMERA_KEYS:
                raise ValueError(f"unknown camera override {k!r}")
        self._cam = {k: repr(float(v)) for k, v in cam.items()}
        if resolve_level not in (0, 1):
            raise ValueError(f"resolve_level must be 0 or 1, "
                             f"got {resolve_level!r}")
        if resolve_level:
            # rides every frame like the camera: a TTL-evicted stream
            # must rebind the same history resolution on resume
            self._cam["resolve_level"] = str(resolve_level)
        self._pending_reset = False
        self._closed = False
        self.last_frame_index = None

    def render(self, depth, normals=None, color=None, *, view=None,
               motion=None, mv=None, reset: bool = False, out: str = "pfm",
               **tunables):
        if self._closed:
            raise ValueError(f"session {self.id} is closed")
        if sum(x is not None for x in (view, motion, mv)) > 1:
            raise ValueError("pass view=, motion=, or mv=, not several")
        if out not in ("pfm", "png"):
            raise ValueError(f"out must be 'pfm' or 'png', got {out!r}")
        q = {"session": self.id}
        if reset or self._pending_reset:
            q["reset"] = "1"
        for key, mat in (("view", view), ("motion", motion)):
            if mat is not None:
                mat = np.asarray(mat, np.float64)
                if mat.shape != (4, 4):
                    raise ValueError(f"{key} must be (4, 4), "
                                     f"got {mat.shape}")
                q[key] = ",".join(repr(float(x)) for x in mat.ravel())
        for k, v in tunables.items():
            ranges = (TEMPORAL_PARAM_RANGES if k in TEMPORAL_PARAM_RANGES
                      else PARAM_RANGES if k in PARAM_RANGES else None)
            if ranges is None:
                raise ValueError(
                    f"unknown override {k!r}: tunables are "
                    f"{sorted(PARAM_RANGES)} + "
                    f"{sorted(TEMPORAL_PARAM_RANGES)}")
            lo, hi = ranges[k]
            v = float(v)
            if not lo <= v <= hi:
                raise ValueError(f"{k}={v} outside [{lo}, {hi}]")
            q[k] = repr(v)
        q.update(self._cam)  # every frame: idempotent re-bind on resume
        depth = np.asarray(depth, np.float32)
        if depth.ndim != 2:
            raise ValueError(f"depth must be (H, W), got {depth.shape}")
        frames = [depth]
        names = ["depth"]
        if normals is not None:
            frames.append(np.asarray(normals, np.float32))
            names.append("normals")
        if color is not None:
            frames.append(np.asarray(color, np.float32))
            names.append("color")
        if mv is not None:
            # (H, W, 2) pixel offsets current->previous; PFM has no
            # 2-channel form, so it rides as 'PF' with a zero third plane
            mv = np.asarray(mv, np.float32)
            if mv.shape != depth.shape + (2,):
                raise ValueError(f"mv must be {depth.shape + (2,)}, "
                                 f"got {mv.shape}")
            frames.append(np.concatenate(
                [mv, np.zeros(depth.shape + (1,), np.float32)], axis=-1))
            names.append("mv")
        if names != ["depth", "normals", "color"][:len(names)]:
            q["buffers"] = ",".join(names)
        if out != "pfm":
            q["out"] = out
        body = b"".join(dumps_pfm(f) for f in frames)
        payload, headers = self.client._post_ao(q, body, retries=0)
        self._pending_reset = False
        idx = headers.get("X-TPUAO-Session-Frame")
        self.last_frame_index = int(idx) if idx is not None else None
        return payload if out == "png" else loads_pfm(payload)

    def reset(self):
        """Mark the next frame as a scene cut (rides ``?reset=1``)."""
        self._pending_reset = True

    def close(self):
        """DELETE the server-side history (idempotent, best-effort).

        ALL faults -- transport-level and HTTP-status alike -- are
        swallowed: close() runs from ``__exit__`` during
        error unwinding, where a raise would mask the exception that
        actually broke the stream, and a failed DELETE costs nothing --
        the server's own TTL eviction reclaims the history anyway."""
        if self._closed:
            return
        self._closed = True
        import http.client

        req = urllib.request.Request(
            f"{self.client.base_url}/session/{self.id}", method="DELETE")
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.client.timeout):
                pass
        except (urllib.error.HTTPError, OSError,
                http.client.HTTPException):
            pass  # best-effort; 404 = never-rendered session, no state

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def request_ao(url: str, depth, normals=None, color=None, *,
               out: str = "pfm", timeout: float = 600.0, **overrides):
    """One-shot convenience: ``AOClient(url).render(...)``."""
    return AOClient(url, timeout=timeout).render(
        depth, normals=normals, color=color, out=out, **overrides)

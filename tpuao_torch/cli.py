"""Command-line front end of the port: ``python -m tpuao_torch <command>``.

The counterpart of ``tpuao/cli.py`` (same commands, flags, files and exit
codes), rendering on the card unless ``--device cpu``:

  info    torch / CUDA / device report (JSON)
  render  depth image(s) in -> AO image(s) out, every tunable as a flag
  tune    sweep the tile rows of one frame shape's launches on the card
          (``utils/autotune``), optionally merged into a JSON cache
  serve   start the HTTP endpoint (``tpuao_torch.serving``)

``render`` speaks PFM natively (``utils/frameio``: 1-channel 'Pf' depth,
3-channel 'PF' normals/colour) and PNG on either side: an 8/16-bit
grayscale input PNG is normalised linear depth in [0, 1] (``--depth-mode
linear`` is implied unless overridden), and a ``.png`` output is the AO
buffer as 8-bit grayscale.

Where the JAX package tunes its scoped-VMEM budget, ``tune`` times the
texels a thread of each kernel launch (``utils/launch_opts``), and
``render``/``serve --autotune-cache PATH`` load what it saved; ``tune``
also takes ``--batch N`` (the launch's frames are part of its key).
``render --sections N`` renders one frame in N row sections, one after
another (``tpuao_torch.parallel.sections``): the frame's result at a
bounded peak device memory.  ``serve --views N`` serves over a mesh of N
devices (N CPU entries with ``--device cpu``).  With no card and no
``--device cpu``, ``render`` exits 1, and ``tune`` always does: nothing
falls back to the CPU unasked.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from tpuao_torch.params import PARAM_RANGES


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tpuao_torch", description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("info", help="torch / CUDA / device report")

    r = sub.add_parser("render", help="depth image(s) in -> AO image(s) out")
    r.add_argument("input", help="depth frame (.pfm 'Pf', or grayscale "
                   ".png), or a quoted glob for a frame sequence")
    r.add_argument("output", help="AO output (.pfm, or 8-bit .png); a "
                   "directory when input is a sequence")
    r.add_argument("--device", help="where frames render: cuda (default) "
                   "or cpu")
    r.add_argument("--normals", help="normals frame: 3-channel 'PF' .pfm "
                   "(raw signed components) or .png (standard (n+1)/2 "
                   "encoding, remapped to [-1, 1]); glob in sequence mode")
    r.add_argument("--color", help="colour frame to composite (.pfm/.png); "
                   "glob in sequence mode")
    r.add_argument("--batch", type=int, default=4,
                   help="frames per device batch in sequence mode "
                   "(with --server: concurrent in-flight requests)")
    r.add_argument("--out-format", choices=("pfm", "png"), default="pfm",
                   help="output format in sequence mode")
    r.add_argument("--config", help="engine config JSON (save_config)")
    r.add_argument("--preset", help="quality preset "
                   "(VERY_LOW|LOW|MEDIUM|HIGH|ULTRA)")
    for name, (lo, hi) in PARAM_RANGES.items():
        r.add_argument(f"--{name.replace('_', '-')}", type=float,
                       dest=name, help=f"tunable in [{lo}, {hi}]")
    r.add_argument("--depth-mode", choices=("hardware", "linear"),
                   help="input depth convention (default: hardware for "
                   ".pfm, linear for .png)")
    r.add_argument("--near", type=float, help="camera near plane")
    r.add_argument("--far", type=float, help="camera far plane")
    r.add_argument("--projection", metavar="FILE_OR_16_FLOATS",
                   help="build the camera from a 4x4 projection matrix: a "
                   "path to a whitespace/comma-separated 16-float file, or "
                   "the 16 floats inline (comma-separated, row-major). "
                   "Derives near/far/fov/Z-convention and sets "
                   "depth_mode=hardware; --near/--far/--fov then override")
    r.add_argument("--projection-convention", choices=("unity", "gl"),
                   default="unity",
                   help="clip-space convention of --projection: 'unity' = "
                   "D3D [0,1] depth, 'gl' = [-1,1] NDC (default: unity)")
    r.add_argument("--fov", type=float,
                   help="horizontal field of view, degrees")
    r.add_argument("--impl", default="auto",
                   choices=("auto", "jnp", "pallas", "fused"))
    r.add_argument("--sections", type=int, default=1,
                   help="render the frame in N halo-overlapped row "
                   "sections, one after another (bounds peak device "
                   "memory for huge frames; the result is the whole "
                   "frame's)")
    r.add_argument("--debug-dump", metavar="PATH",
                   help="also dump the intermediate-buffer pyramid "
                   "(.npz file, or a zarr directory)")

    r.add_argument("--temporal", action="store_true",
                   help="sequence mode: temporal accumulation across "
                   "frames; frames render in order through a "
                   "TemporalAOEngine")
    r.add_argument("--camera-path", metavar="FILE",
                   help="JSON list of per-frame 4x4 world->eye view "
                   "matrices (16 floats each, row-major) for --temporal "
                   "reprojection; omit for a static camera")
    r.add_argument("--history-weight", type=float,
                   help="--temporal: max history fraction kept per frame "
                   "(default 0.9)")
    r.add_argument("--depth-tolerance", type=float,
                   help="--temporal: relative reprojected-depth mismatch "
                   "at which history is dropped (default 0.1)")
    r.add_argument("--no-temporal-clamp", action="store_true",
                   help="--temporal: disable the 3x3 anti-ghosting "
                   "neighborhood clamp")
    r.add_argument("--resolve-level", type=int, default=0, choices=(0, 1),
                   help="--temporal: 0 = full-res resolve (default), "
                   "1 = half-res level-1 resolve")

    r.add_argument("--autotune-cache", metavar="PATH",
                   help="load per-launch tile rows tuned by `tpuao_torch "
                   "tune --save PATH` before rendering")
    r.add_argument("--server", metavar="URL",
                   help="render remotely via a running `serve` endpoint "
                   "(thin client, tpuao_torch.client: no local device is "
                   "touched); tunables and --near/--far/--fov ride as "
                   "per-request query knobs, while server-side state flags "
                   "(--config/--preset/--impl/--sections/--debug-dump/"
                   "--autotune-cache/--device) are rejected; --depth-mode "
                   "is checked against the server's engine (GET /config)")

    t = sub.add_parser("tune", help="sweep the tile rows of one frame "
                       "shape's kernel launches (on the card)")
    t.add_argument("shape", help="frame shape HxW, e.g. 1440x2560")
    t.add_argument("--normals", action="store_true",
                   help="tune the normals-weighted program (its launches "
                   "are other kernels)")
    t.add_argument("--impl", default="auto",
                   choices=("auto", "pallas", "fused"))
    t.add_argument("--batch", type=int, default=1,
                   help="frames a call (part of each launch's key)")
    t.add_argument("--candidates", metavar="NT,NT,...",
                   help="texels a thread to sweep (default: every instance "
                   "each kernel has: render 4,2,1, normals 1, chain steps "
                   "3,2,1)")
    t.add_argument("--save", metavar="PATH",
                   help="merge the winners into this JSON cache file")

    # never parsed: main() hands a "serve" argv to _cmd_serve as it is; this
    # subparser exists for --help and for flag parity with the JAX CLI
    s = sub.add_parser("serve", help="start the HTTP AO endpoint")
    s.add_argument("args", nargs=argparse.REMAINDER,
                   help="arguments passed through to "
                   "tpuao_torch.serving (port, --device, --batch, ...)")
    return ap


# -- image IO ---------------------------------------------------------------

def _load_image(path: str) -> tuple[np.ndarray, bool]:
    """Load a frame; returns (array, was_png)."""
    if path.lower().endswith(".png"):
        from PIL import Image

        img = np.asarray(Image.open(path))
        scale = 65535.0 if img.dtype == np.uint16 else 255.0
        return np.asarray(img, np.float32) / scale, True
    from tpuao_torch.utils.frameio import load_pfm

    return load_pfm(path), False


def _load_normals_frame(path: str) -> np.ndarray:
    """Load and check a normals frame; a PNG normal map's (n + 1) / 2
    encoding is remapped to signed components in [-1, 1], a 'PF' .pfm is
    raw."""
    normals, was_png = _load_image(path)
    if normals.ndim != 3 or 3 not in (normals.shape[0], normals.shape[-1]):
        raise ValueError("--normals must be a 3-channel buffer, got "
                         f"shape {normals.shape}")
    return normals * 2.0 - 1.0 if was_png else normals


def _match_streams(a, dpaths) -> dict:
    """Glob the --normals/--color patterns; each must match depth 1:1."""
    import glob as globlib

    out = {}
    for pat, name in ((a.normals, "--normals"), (a.color, "--color")):
        if pat:
            p = sorted(globlib.glob(pat))
            if len(p) != len(dpaths):
                raise ValueError(f"{name} matches {len(p)} files, "
                                 f"depth matches {len(dpaths)}")
            out[name] = p
    return out


def _save_image(path: str, arr: np.ndarray) -> None:
    if path.lower().endswith(".png"):
        from tpuao_torch.utils.io import save_ao_image

        save_ao_image(arr, path)
        return
    from tpuao_torch.utils.frameio import save_pfm

    save_pfm(path, np.asarray(arr, np.float32))


def _is_glob(path: str) -> bool:
    return any(c in path for c in "*?[")


def _batches(streams, bs: int) -> list:
    """Path lists per batch of ``bs`` frames: a list of depth paths, or a
    tuple (depth, normals[, colour]) when there are several streams."""
    out = []
    for i in range(0, len(streams[0]), bs):
        sl = tuple(s[i:i + bs] for s in streams)
        out.append(sl if len(streams) > 1 else sl[0])
    return out


def _out_path(a, dpath: str) -> str:
    stem = os.path.splitext(os.path.basename(dpath))[0]
    return os.path.join(a.output, f"{stem}_ao.{a.out_format}")


def _kinds(a) -> str:
    return "depth" + ("+normals" if a.normals else "") + \
        ("+color" if a.color else "")


# -- subcommands ------------------------------------------------------------

def _cmd_info(_a) -> int:
    import torch

    import tpuao_torch

    avail = torch.cuda.is_available()
    names = ([torch.cuda.get_device_name(i)
              for i in range(torch.cuda.device_count())] if avail else [])
    print(json.dumps({
        "tpuao_torch": tpuao_torch.__version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": avail,
        "device_count": len(names),
        "devices": names,
    }, indent=2))
    return 0


def _read_matrix16(spec: str):
    """--projection value -> 16 floats: a file path (whitespace/comma
    separated, '#' comments allowed) or the 16 values inline."""
    import re

    if os.path.exists(spec):
        with open(spec) as f:
            text = " ".join(line.split("#")[0] for line in f)
    else:
        text = spec
    vals = [float(v) for v in re.split(r"[\s,]+", text.strip()) if v]
    if len(vals) != 16:
        raise ValueError(
            f"--projection needs 16 floats, got {len(vals)} from {spec!r}")
    return np.array(vals).reshape(4, 4)


def _build_component(a, was_png: bool):
    """CLI flags -> validated (camera, params)."""
    from tpuao_torch.models.pipeline import AmbientOcclusionEngine
    from tpuao_torch.models.presets import preset
    from tpuao_torch.params import AOParams, CameraParams

    if a.config:
        eng = AmbientOcclusionEngine.from_config(a.config, impl=a.impl)
        params, camera = eng.params, eng.camera
    else:
        params = preset(a.preset) if a.preset else AOParams()
        camera = CameraParams()
    if a.projection:
        camera = CameraParams.from_projection(
            _read_matrix16(a.projection),
            convention=a.projection_convention)
    tunables = {k: getattr(a, k) for k in PARAM_RANGES
                if getattr(a, k) is not None}
    if tunables:
        params = params.replace(**tunables)
    cam_kw = {}
    if a.near is not None:
        cam_kw["near"] = a.near
    if a.far is not None:
        cam_kw["far"] = a.far
    if a.fov is not None:
        import math

        cam_kw["tan_half_fov_h"] = math.tan(math.radians(a.fov) / 2)
    # --projection implies hardware depth; the PNG->linear default must not
    # override it
    depth_mode = a.depth_mode or (
        None if a.projection else ("linear" if was_png else None))
    if depth_mode:
        cam_kw["depth_mode"] = depth_mode
    if cam_kw:
        camera = camera.replace(**cam_kw)
    if a.normals and not params.use_normals:
        params = params.replace(use_normals=True)  # --normals implies it
    if a.fov is not None and not 0 < a.fov < 180:
        raise ValueError(f"--fov {a.fov} outside (0, 180)")
    return camera.validate(), params.validate()


def _cmd_render_remote(a) -> int:
    """``--server``: POST frames to a running endpoint (``client.py``).

    Image decode/encode and the PNG normal remap stay local; the render
    happens wherever the server runs.  The flags that configure the
    server's engine are rejected rather than ignored, and the depth
    convention is checked against the server's (GET /config): an explicit
    --depth-mode mismatch is an error, an implicit one a warning.
    """
    import urllib.error

    bad = [f for f, on in (("--config", a.config), ("--preset", a.preset),
                           ("--impl", a.impl != "auto"),
                           ("--sections", a.sections > 1),
                           ("--debug-dump", a.debug_dump),
                           ("--autotune-cache", a.autotune_cache),
                           ("--device", a.device)) if on]
    if bad:
        print(f"error: {', '.join(bad)} configure the server-side engine; "
              "set them where the server runs", file=sys.stderr)
        return 2
    from tpuao_torch.client import AOClient

    overrides = {k: getattr(a, k) for k in PARAM_RANGES
                 if getattr(a, k) is not None}
    overrides.update({k: getattr(a, k) for k in ("near", "far", "fov")
                      if getattr(a, k) is not None})
    client = AOClient(a.server)
    try:
        server_mode = client.config()["camera"]["depth_mode"]
    except (RuntimeError, TimeoutError, OSError) as e:
        print(f"error: cannot reach {a.server}/config: {e}",
              file=sys.stderr)
        return 1
    local_default = ("linear" if a.input.lower().endswith(".png")
                     else "hardware")
    if a.depth_mode and a.depth_mode != server_mode:
        print(f"error: --depth-mode {a.depth_mode} but the server engine "
              f"renders depth_mode={server_mode!r} (a static knob; "
              "restart the server with the right engine or convert the "
              "input)", file=sys.stderr)
        return 2
    if not a.depth_mode and server_mode != local_default:
        print(f"note: server renders depth_mode={server_mode!r}; a local "
              f"render of this input would default to {local_default!r}. "
              f"Pass --depth-mode {server_mode} to confirm the input "
              "matches the server's convention and silence this.",
              file=sys.stderr)

    def one(dpath, npath, cpath, opath):
        depth, _ = _load_image(dpath)
        normals = _load_normals_frame(npath) if npath else None
        color = _load_image(cpath)[0] if cpath else None
        out_png = opath.lower().endswith(".png")
        res = client.render(depth, normals=normals, color=color,
                            out="png" if out_png else "pfm", **overrides)
        if out_png:
            with open(opath, "wb") as f:
                f.write(res)
        else:
            from tpuao_torch.utils.frameio import save_pfm

            save_pfm(opath, res)
        return depth.shape

    try:
        if not _is_glob(a.input):
            shape = one(a.input, a.normals, a.color, a.output)
            print(f"{a.input} {shape[1]}x{shape[0]} -> {a.output} "
                  f"(rendered by {a.server})")
            return 0
        import glob as globlib

        dpaths = sorted(globlib.glob(a.input))
        if not dpaths:
            print(f"error: no files match {a.input!r}", file=sys.stderr)
            return 2
        streams = _match_streams(a, dpaths)
        os.makedirs(a.output, exist_ok=True)
        npaths = streams.get("--normals", [None] * len(dpaths))
        cpaths = streams.get("--color", [None] * len(dpaths))

        def job(i):
            one(dpaths[i], npaths[i], cpaths[i], _out_path(a, dpaths[i]))

        # --batch remotely = concurrent in-flight requests, so the
        # server's micro-batcher sees more than one frame a flush
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=max(1, a.batch)) as pool:
            list(pool.map(job, range(len(dpaths))))
        print(f"{len(dpaths)} frames -> {a.output} "
              f"(rendered by {a.server})")
        return 0
    except (RuntimeError, TimeoutError, urllib.error.URLError) as e:
        # transport and server faults exit 1; ValueError (validation)
        # goes to main()'s usage-error exit 2
        print(f"error: {e}", file=sys.stderr)
        return 1


def _cmd_render(a) -> int:
    if a.temporal and not _is_glob(a.input):
        print("error: --temporal accumulates across a frame sequence; "
              "pass a quoted glob input", file=sys.stderr)
        return 2
    if a.temporal and a.server:
        print("error: --temporal is local sequence state; the remote "
              "server renders stateless frames", file=sys.stderr)
        return 2
    if a.server:
        return _cmd_render_remote(a)
    from tpuao_torch.models.pipeline import resolve_device

    try:
        device = resolve_device(a.device)
    except RuntimeError:
        print(f"error: --device {a.device or 'cuda'}: no CUDA device "
              "here; pass --device cpu to render on the CPU",
              file=sys.stderr)
        return 1
    if a.autotune_cache:
        from tpuao_torch.utils import autotune

        autotune.load_tuned(a.autotune_cache)
    if _is_glob(a.input):
        return _cmd_render_sequence(a, device)
    from tpuao_torch.models.pipeline import AmbientOcclusionEngine

    depth, was_png = _load_image(a.input)
    if depth.ndim != 2:
        print(f"error: depth must be single-channel, got {depth.shape}",
              file=sys.stderr)
        return 2
    camera, params = _build_component(a, was_png)
    normals = _load_normals_frame(a.normals) if a.normals else None
    color = _load_image(a.color)[0] if a.color else None

    eng = AmbientOcclusionEngine(camera, params, impl=a.impl, device=device)
    if a.sections > 1:
        if a.debug_dump:
            print("error: --debug-dump needs the monolithic path (drop "
                  "--sections)", file=sys.stderr)
            return 2
        ao = eng.render_sections(depth, a.sections, normals=normals,
                                 color=color)
    elif a.debug_dump:
        ao, dbg = eng.render(depth, normals=normals, color=color,
                             debug_outputs=True)
        from tpuao_torch.utils.debug_dump import dump_debug_buffers

        dump_debug_buffers(dbg, a.debug_dump)
    else:
        ao = eng.render(depth, normals=normals, color=color)
    ao = ao.cpu().numpy()  # the one copy to the host
    _save_image(a.output, ao)
    print(f"{a.input} {depth.shape[1]}x{depth.shape[0]} -> {a.output} "
          f"(ao mean {float(np.mean(ao)):.4f}, "
          f"min {float(np.min(ao)):.4f}, on {device})")
    return 0


def _cmd_render_sequence(a, device) -> int:
    """Glob input -> directory of AO frames, in batches of ``--batch``
    through ``utils.frameio.FramePrefetcher`` (decode of batch k+1 overlaps
    the render of batch k).  Eager PyTorch compiles nothing per shape, so
    the tail batch renders as it is.  All frames share one shape."""
    import glob as globlib

    from tpuao_torch.models.pipeline import AmbientOcclusionEngine
    from tpuao_torch.utils.frameio import FramePrefetcher

    dpaths = sorted(globlib.glob(a.input))
    if not dpaths:
        print(f"error: no files match {a.input!r}", file=sys.stderr)
        return 2
    if any(not p.lower().endswith(".pfm") for p in dpaths):
        print("error: sequence mode streams PFM frames (the prefetcher's "
              "native codec); convert PNGs first or render per-frame",
              file=sys.stderr)
        return 2
    if a.debug_dump or a.sections > 1:
        print("error: --debug-dump/--sections need single-frame mode",
              file=sys.stderr)
        return 2
    matched = _match_streams(a, dpaths)
    streams = [dpaths] + [matched[k] for k in ("--normals", "--color")
                          if k in matched]
    camera, params = _build_component(a, was_png=False)
    if a.temporal:
        return _render_sequence_temporal(a, dpaths, streams, camera, params,
                                         device)
    eng = AmbientOcclusionEngine(camera, params, impl=a.impl, device=device)
    bs = max(1, a.batch)
    os.makedirs(a.output, exist_ok=True)
    done = 0
    with FramePrefetcher(_batches(streams, bs)) as pf:
        for got in pf:
            arrs = list(got) if isinstance(got, tuple) else [got]
            it = iter(arrs[1:])
            ao = eng.render(arrs[0], normals=next(it) if a.normals else None,
                            color=next(it) if a.color else None
                            ).cpu().numpy()
            for j in range(ao.shape[0]):
                _save_image(_out_path(a, dpaths[done + j]), ao[j])
            done += ao.shape[0]
    print(f"{done} frames -> {a.output} (batch {bs}, {_kinds(a)}, "
          f"on {device})")
    return 0


def _render_sequence_temporal(a, dpaths, streams, camera, params,
                              device) -> int:
    """--temporal: frames render in order through a ``TemporalAOEngine``
    (the history forbids batching the render; the prefetcher still
    decodes the next batch under the current one's renders)."""
    from tpuao_torch.models.pipeline import TemporalAOEngine
    from tpuao_torch.params import TemporalParams
    from tpuao_torch.utils.frameio import FramePrefetcher

    views = None
    if a.camera_path:
        with open(a.camera_path) as f:
            raw = json.load(f)
        views = [np.asarray(v, np.float64).reshape(4, 4) for v in raw]
        if len(views) != len(dpaths):
            print(f"error: --camera-path has {len(views)} views for "
                  f"{len(dpaths)} frames", file=sys.stderr)
            return 2
    tp = TemporalParams(
        history_weight=(0.9 if a.history_weight is None
                        else a.history_weight),
        depth_tolerance=(0.1 if a.depth_tolerance is None
                         else a.depth_tolerance),
        neighborhood_clamp=not a.no_temporal_clamp).validate()
    eng = TemporalAOEngine(camera, params, tparams=tp, impl=a.impl,
                           resolve_level=a.resolve_level, device=device)
    os.makedirs(a.output, exist_ok=True)
    done = 0
    with FramePrefetcher(_batches(streams, max(1, a.batch))) as pf:
        for got in pf:
            arrs = list(got) if isinstance(got, tuple) else [got]
            it = iter(arrs[1:])
            nrm = next(it) if a.normals else None
            col = next(it) if a.color else None
            for j in range(arrs[0].shape[0]):
                t = done + j
                ao = eng.render(
                    arrs[0][j],
                    normals=None if nrm is None else nrm[j],
                    color=None if col is None else col[j],
                    view=None if views is None else views[t]).cpu().numpy()
                _save_image(_out_path(a, dpaths[t]), ao)
            done += arrs[0].shape[0]
    print(f"{done} frames -> {a.output} (temporal, "
          f"{'camera path' if views is not None else 'static camera'}, "
          f"{_kinds(a)}, on {device})")
    return 0


def _cmd_tune(a) -> int:
    """Sweep the launches of one frame shape on the card and print the
    ``tune_frame`` dict; ``--save`` merges the winners into a cache file
    (the other launches' entries are kept), refusing one tuned on another
    device kind."""
    from tpuao_torch.utils import autotune

    try:
        h, w = (int(v) for v in a.shape.lower().split("x"))
    except ValueError:
        print(f"error: shape must be HxW, got {a.shape!r}", file=sys.stderr)
        return 2
    target = autotune.sweep_target()
    if target is None:
        print("error: tune times the kernels on the card and there is no "
              "CUDA device here (the API takes a timer: "
              "utils.autotune.tune_frame(..., timer=...))", file=sys.stderr)
        return 1
    if a.save and os.path.exists(a.save):
        with open(a.save) as f:
            prior = json.load(f)
        if (prior.get("entries") and prior.get("device_kind") not in (
                autotune.device_kind(), "unknown", None)):
            # refusing beats silently deleting another card's measured
            # values: save_tuned rewrites the file with this process's
            print(f"error: {a.save} was tuned on "
                  f"{prior.get('device_kind')!r}, this host is "
                  f"{autotune.device_kind()!r}; use a separate cache file "
                  "per device kind", file=sys.stderr)
            return 2
        # merge: the file's entries stand for the other launches; this
        # frame's launches are swept anew and take the fresh values
        autotune.load_tuned(a.save)
    candidates = (tuple(int(v) for v in a.candidates.split(","))
                  if a.candidates else None)
    device, timer = target
    res = autotune.tune_frame((h, w), use_normals=a.normals, impl=a.impl,
                              batch=a.batch, candidates=candidates,
                              timer=timer, device=device)
    if a.save:
        res["saved"] = autotune.save_tuned(a.save)
    print(json.dumps(res, indent=2))
    return 0


def _cmd_serve(a) -> int:
    """``tpuao_torch.serving.main`` with the pass-through arguments
    (``--views N``: a mesh of N devices; ``--autotune-cache PATH``)."""
    from tpuao_torch import serving

    serving.main(a.args)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["serve"]:
        # everything after it is the server's: argparse's REMAINDER drops
        # a leading option ("serve --device cpu") into the wrong slot
        a = argparse.Namespace(cmd="serve", args=argv[1:])
    else:
        a = _build_parser().parse_args(argv)
    try:
        return {"info": _cmd_info, "render": _cmd_render,
                "tune": _cmd_tune, "serve": _cmd_serve}[a.cmd](a)
    except ValueError as e:
        # validation errors (param/camera ranges, bad config values) exit
        # like every other usage error: message + status 2, no trace
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())

"""Tile-row autotuner: the per-launch table of ``utils/launch_opts`` swept
on the card.

Counterpart of ``tpuao/utils/autotune.py``.  There the lever is XLA's
scoped-VMEM budget of a frame program; here it is the texels a thread of
each launch of the tiled kernels (``launch_opts``), whose launchers pick
it by a rule written by hand.  This module times every value each launch
of a frame program can take, on that launch's own inputs, registers the
fastest per launch, and keeps the table as JSON per device kind, so a
fleet tunes once per (card, launch) and every process reuses it.

    from tpuao_torch.utils import autotune
    res = autotune.tune_frame((1440, 2560))   # sweeps on the card
    autotune.save_tuned("autotune.json")      # persist
    autotune.load_tuned("autotune.json")      # next process

CLI: ``python -m tpuao_torch tune 1440x2560 [--normals] [--batch N]
[--save PATH]``; ``render`` and ``serve`` take ``--autotune-cache PATH``.

Timing is ``utils.timing.cuda_graph_ms`` (the launches captured in a CUDA
graph and replayed: device time without the host's launch path), so a
sweep needs the card.  Without one ``tune_frame`` raises unless a
``timer`` is passed, which is how the CPU tests drive it.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from tpuao_torch.utils import launch_opts
from tpuao_torch.utils.timing import cuda_graph_ms


def sweep_tiles(fn, *args, kernel: str, batch: int, h: int, w: int,
                candidates=None, timer=None) -> dict[int, float]:
    """Time ``fn(*args)`` with each of ``candidates`` (default: every
    instance, ``launch_opts.VALID_NT[kernel]``) set in the table for the
    launch ``(kernel, batch, h, w)``; returns ``{nt: ms}``.

    ``timer(call)`` times a call without arguments (default
    ``cuda_graph_ms``).  The entry that stood for the launch before the
    sweep is restored afterwards, or removed if there was none: the sweep
    must not leave its last candidate registered (``tune_frame`` applies
    the winner explicitly).
    """
    timer = timer or cuda_graph_ms
    cands = (launch_opts.VALID_NT[kernel] if candidates is None
             else tuple(candidates))
    key = launch_opts._key(kernel, batch, h, w)
    prior = launch_opts._TUNED.get(key)
    out = {}
    try:
        for nt in cands:
            launch_opts.set_tuned_tiles(kernel, batch, h, w, nt)
            out[int(nt)] = float(timer(lambda: fn(*args)))
    finally:
        _restore({key: prior})
    return out


def _restore(prior: dict) -> None:
    """Put back table entries saved as ``{key: nt or None}``."""
    for key, nt in prior.items():
        if nt is None:
            launch_opts._TUNED.pop(key, None)
        else:
            launch_opts._TUNED[key] = nt


def launch_label(key) -> str:
    """``("fused_render_upsample_step", 1, 544, 960)`` ->
    ``"fused_render_upsample_step 1x544x960"``."""
    kernel, batch, h, w = key
    return f"{kernel} {batch}x{h}x{w}"


def tune_frame(shape, camera=None, params=None, use_normals: bool = False,
               impl: str = "auto", batch: int = 1, candidates=None,
               timer=None, apply: bool = True, device=None) -> dict:
    """Sweep each launch of the frame program at ``shape`` = (H, W) over
    ``batch`` frames; returns ``{"pixels", "use_normals", "batch",
    "best": {launch: nt}, "default": {launch: the rule's nt},
    "sweep_ms": {launch: {nt: ms}}, "frame_ms": {"default", "tuned"}}``,
    each launch named by ``launch_label``.

    The frame's inputs are ``tpuao``'s (seeded uniform depth in linear
    mode; flat normals with ``use_normals``), on ``device`` (default the
    card).  The program runs once under ``ops.kernels.record_launches``,
    which lists its launches; each distinct launch is timed alone on its
    own inputs at every value of ``candidates`` it has (default all), and
    the whole frame at the rule and with the winners.  ``apply=True``
    leaves the winners in the table, so every later launch of those keys
    takes them; ``apply=False`` restores what stood before.  ``timer``
    (default ``cuda_graph_ms``) is required off the card.
    """
    from tpuao_torch.models.pipeline import ao_pipeline, resolve_device
    from tpuao_torch.ops import kernels as K
    from tpuao_torch.params import AOParams, CameraParams

    h, w, batch = int(shape[0]), int(shape[1]), int(batch)
    camera = camera or CameraParams(depth_mode="linear")
    params = params or AOParams()
    if use_normals and not params.use_normals:
        params = params.replace(use_normals=True)
    device = resolve_device(device)
    if timer is None:
        if device.type != "cuda":
            raise ValueError("tune_frame times on the card "
                             "(utils.timing.cuda_graph_ms); off it, pass a "
                             "timer")
        timer = cuda_graph_ms
    valid = {nt for v in launch_opts.VALID_NT.values() for nt in v}
    if candidates is not None and not set(candidates) <= valid:
        raise ValueError(f"candidates {tuple(candidates)}: no kernel has "
                         f"{sorted(set(candidates) - valid)} (valid: "
                         f"{launch_opts.VALID_NT})")

    rng = np.random.default_rng(0)
    lead = (batch,) if batch > 1 else ()
    depth = torch.as_tensor(np.clip(rng.uniform(0.05, 1.0, size=lead + (h, w)),
                                    1e-3, 1.0).astype(np.float32),
                            device=device)
    normals = None
    if use_normals:
        n = np.zeros(lead + (h, w, 3), np.float32)
        n[..., 2] = 1.0
        normals = torch.as_tensor(n, device=device)

    def frame():
        return ao_pipeline(depth, camera, params, normals, impl=impl)[0]

    with K.record_launches() as record:
        frame()
    launches = {}
    for launch in record:
        launches.setdefault(launch.key, launch)

    best, default, sweep = {}, {}, {}
    for key, launch in launches.items():
        label = launch_label(key)
        default[label] = launch.rule
        cands = [nt for nt in (candidates or launch_opts.VALID_NT[key[0]])
                 if nt in launch_opts.VALID_NT[key[0]]]
        if not cands:
            continue
        sweep[label] = sweep_tiles(launch.call, kernel=key[0], batch=key[1],
                                   h=key[2], w=key[3], candidates=cands,
                                   timer=timer)
        best[key] = min(sweep[label], key=sweep[label].get)

    prior = {key: launch_opts._TUNED.get(key) for key in best}
    timed = False
    try:
        for key in best:
            launch_opts._TUNED.pop(key, None)
        frame_default = float(timer(frame))
        for key, nt in best.items():
            launch_opts.set_tuned_tiles(*key, nt)
        frame_tuned = float(timer(frame))
        timed = True
    finally:
        if not (timed and apply):
            _restore(prior)
    return {"pixels": h * w, "use_normals": bool(use_normals),
            "batch": batch,
            "best": {launch_label(k): nt for k, nt in best.items()},
            "default": default,
            "sweep_ms": {label: {str(nt): ms for nt, ms in s.items()}
                         for label, s in sweep.items()},
            "frame_ms": {"default": frame_default, "tuned": frame_tuned}}


def sweep_target():
    """``(device, timer)`` of a sweep on the card -- the current CUDA
    device and ``cuda_graph_ms`` -- or None where there is none: the CLI's
    ``tune`` never sweeps elsewhere."""
    if not torch.cuda.is_available():
        return None
    return torch.device("cuda", torch.cuda.current_device()), cuda_graph_ms


# -- persistence -------------------------------------------------------------

def device_kind() -> str:
    """``torch.cuda.get_device_name()``, or ``"cpu"`` without a card."""
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name()


def save_tuned(path: str) -> str:
    """Write the current table to JSON, tagged with the device kind: tile
    rows timed on one card are not evidence for another."""
    entries = [{"kernel": k, "batch": b, "h": h, "w": w, "nt": nt}
               for (k, b, h, w), nt in sorted(launch_opts._TUNED.items())]
    with open(path, "w") as f:
        json.dump({"device_kind": device_kind(), "entries": entries}, f,
                  indent=2)
    return path


def load_tuned(path: str, strict_device: bool = True) -> int:
    """Load a saved table; returns the number of entries applied.

    ``strict_device=True`` skips (returning 0) a file recorded on another
    device kind instead of applying values never timed on this card.  A
    file with no ``device_kind`` key (hand-written or legacy) loads like
    ``"unknown"``: dropping its entries would let a later ``tune --save``
    rewrite the file with only the fresh measurement.  An entry with a
    value its kernel has no instance for raises ``ValueError``.
    """
    with open(path) as f:
        data = json.load(f)
    if strict_device and data.get("device_kind") not in (
            device_kind(), "unknown", None):
        return 0
    n = 0
    for e in data.get("entries", []):
        launch_opts.set_tuned_tiles(e["kernel"], e["batch"], e["h"], e["w"],
                                    e["nt"])
        n += 1
    return n

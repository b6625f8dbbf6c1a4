"""The devices a run uses: program parameters from a configuration, the
mesh of cards it renders on, the memory each card holds, and the result
line's ``device`` entry."""

from __future__ import annotations

import functools
import math


def program_params(config: dict):
    """``(CameraParams, AOParams)`` of the program from a configuration
    file's ``camera`` and ``ao`` groups (the field of view in degrees)."""
    from tpuao_torch.params import AOParams, CameraParams

    cam = dict(config["camera"])
    fov = cam.pop("fov_h_deg")
    camera = CameraParams(tan_half_fov_h=math.tan(math.radians(fov) / 2),
                          **cam).validate()
    return camera, AOParams(**config["ao"]).validate()


def engine_of(config: dict, device: str):
    """The program's engine for a configuration, rendering on
    ``device``."""
    from tpuao_torch.models.pipeline import AmbientOcclusionEngine

    camera, params = program_params(config)
    return AmbientOcclusionEngine(camera, params, impl=config["impl"],
                                  out_dtype=config["out_dtype"],
                                  device=device)


def mesh_of(config: dict, device: str) -> tuple:
    """The devices a configuration's ``cards`` (1 or 4, absent 1) render
    on: on the card the port's ``make_mesh(cards)``, the distinct cards
    ``cuda:0 .. cuda:{cards - 1}`` (raises where fewer are there); off it
    ``("cpu",) * cards``, the port's own stand-in for a mesh."""
    n = config.get("cards", 1)
    if n not in (1, 4):
        raise ValueError(f"configuration {config['name']!r}: cards must be "
                         f"1 or 4, got {n!r}")
    if device.startswith("cuda"):
        from tpuao_torch.parallel.sharding import make_mesh

        return make_mesh(n)
    return ("cpu",) * n


@functools.cache
def cards(mesh: tuple) -> tuple:
    """The distinct CUDA devices of ``mesh``, in its order (none off the
    card); kept per mesh, since the loop synchronises through it after
    every call."""
    import torch

    out = []
    for d in map(torch.device, mesh):
        if d.type == "cuda" and d not in out:
            out.append(d)
    return tuple(out)


def sync(mesh) -> None:
    """Wait for every card of ``mesh``."""
    import torch

    for d in cards(mesh):
        torch.cuda.synchronize(d)


def allocated(mesh) -> list[int]:
    """Bytes allocated on each distinct card of ``mesh`` (``[0]`` off
    the card)."""
    import torch

    return [torch.cuda.memory_allocated(d) for d in cards(mesh)] or [0]


def reset_peak(mesh) -> None:
    import torch

    for d in cards(mesh):
        torch.cuda.reset_peak_memory_stats(d)


def peak(mesh) -> list[int]:
    """Peak bytes allocated on each distinct card of ``mesh`` since its
    last ``reset_peak`` (``[0]`` off the card)."""
    import torch

    return [torch.cuda.max_memory_allocated(d) for d in cards(mesh)] or [0]


def entry(mesh, memory_peak_bytes: int, profile=None) -> dict:
    """The result line's ``device``: platform, the first card's name, the
    count of distinct cards used, the peak of allocated memory on the
    fullest card, and with a trace the device's busy seconds and the
    traced window's length."""
    import torch

    used = cards(mesh)
    if used:
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(used[0]),
               "count": len(used)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1}
    out["memory_peak_bytes"] = int(memory_peak_bytes)
    if profile is not None:
        out["busy_s"] = profile["busy_s"]
        out["window_s"] = profile["window_s"]
    return out

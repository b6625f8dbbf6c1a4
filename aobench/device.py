"""The device a run uses: program parameters from a configuration, and
the result line's ``device`` entry."""

from __future__ import annotations

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


def sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def allocated(device: str) -> int:
    import torch

    return torch.cuda.memory_allocated() if device.startswith("cuda") else 0


def reset_peak(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()


def peak(device: str) -> int:
    import torch

    return (torch.cuda.max_memory_allocated() if device.startswith("cuda")
            else 0)


def entry(device: str, memory_peak_bytes: int, profile=None) -> dict:
    """The result line's ``device``: platform, the card's name, the count
    of cards used, the peak of allocated memory, and with a trace the
    device's busy seconds and the traced window's length."""
    import torch

    if device.startswith("cuda"):
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(),
               "count": 1}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1}
    out["memory_peak_bytes"] = int(memory_peak_bytes)
    if profile is not None:
        out["busy_s"] = profile["busy_s"]
        out["window_s"] = profile["window_s"]
    return out

"""tpuao_torch -- the PyTorch / CUDA port of tpuao for NVIDIA Hopper.

The frame path of ``tpuao`` (depth [+ normals] -> linearise -> pyramid ->
per-level AO -> blur/upsample chain -> crop [-> composite -> quantise]),
its engines, its temporal accumulation, multi-view over a mesh of
devices (``tpuao_torch.parallel.sharding``), autodiff
(``tpuao_torch.models.autodiff``), its HTTP serving path
(``tpuao_torch.serving``, ``tpuao_torch.client``) and its command line
(``python -m tpuao_torch``, ``tpuao_torch.cli``) in PyTorch, with every
Pallas kernel of the JAX package written by hand in CUDA C++ for
``sm_90a`` (``tpuao_torch/csrc``).  It imports neither ``jax`` nor
``tpuao``; ``tpuao`` stays the reference it is tested against::

    import torch
    from tpuao_torch import AOParams, CameraParams, render_frame
    ao = render_frame(torch.as_tensor(depth, device="cuda"),
                      camera=CameraParams(depth_mode="linear"),
                      params=AOParams())

    from tpuao_torch import TemporalAOEngine, preset
    eng = TemporalAOEngine(camera, preset("ULTRA"))
    out = eng.render(depth, normals=normals, view=view_matrix)
"""

import importlib

from tpuao_torch.params import (  # noqa: F401
    AOParams,
    CameraParams,
    PARAM_RANGES,
    TemporalParams,
    build_pair_table,
)

# The entry points load on first use, so importing a light submodule
# (``tpuao_torch.params``, the float64 golden ``tpuao_torch.golden``) does
# not import the pipeline and its ops.
_LAZY = {
    "AmbientOcclusionEngine": "tpuao_torch.models.pipeline",
    "TemporalAOEngine": "tpuao_torch.models.pipeline",
    "render_frame": "tpuao_torch.models.pipeline",
    "render_frame_temporal": "tpuao_torch.models.pipeline",
    "render_sequence_temporal": "tpuao_torch.models.pipeline",
    "PRESETS": "tpuao_torch.models.presets",
    "preset": "tpuao_torch.models.presets",
}

__all__ = ["AOParams", "CameraParams", "PARAM_RANGES", "TemporalParams",
           "build_pair_table", *_LAZY]

__version__ = "0.1.0"


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module 'tpuao_torch' has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(_LAZY[name]), name)

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

from tpuao_torch.models.pipeline import (  # noqa: F401
    AmbientOcclusionEngine,
    TemporalAOEngine,
    render_frame,
    render_frame_temporal,
    render_sequence_temporal,
)
from tpuao_torch.models.presets import PRESETS, preset  # noqa: F401
from tpuao_torch.params import (  # noqa: F401
    AOParams,
    CameraParams,
    PARAM_RANGES,
    TemporalParams,
    build_pair_table,
)

__version__ = "0.1.0"

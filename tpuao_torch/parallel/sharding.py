"""Multi-view rendering on one card.

Counterpart of the one-card part of ``tpuao/parallel/sharding.py``.  AO is
embarrassingly parallel across views, and every kernel of the port takes a
leading batch as its grid's ``blockIdx.z``, so the views of a call are
that batch: ``render_views`` is one pass of the frame pipeline over all of
them, the same launches as one view.

The multi-card modes of the JAX package (``render_views_sharded``, the
temporal fleet, ``make_server(mesh=...)``) are not defined here; they wait
for the multi-GPU work (ROADMAP item 9).
"""

from __future__ import annotations

import torch

from tpuao_torch.models.pipeline import _as_tensor, ao_pipeline
from tpuao_torch.params import AOParams, CameraParams


def pad_leading(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad a leading axis by replicating the last entry ``pad`` times (the
    uneven-view-count alignment of the JAX package's sharded modes)."""
    if pad < 0:
        raise ValueError(f"pad must be >= 0, got {pad}")
    reps = (pad,) + (1,) * (x.ndim - 1)
    return torch.cat([x, x[-1:].repeat(reps)], dim=0)


def render_views(depths, camera=None, params=None, normals=None,
                 impl: str = "auto", device=None) -> torch.Tensor:
    """The frame pipeline over a leading views axis: ``depths`` (V, H, W)
    [+ ``normals`` (V, H, W, 3) or (V, 3, H, W)] -> AO (V, H, W) float32.

    Tensors are computed on the device they are on; NumPy input goes to
    ``device`` (default the card; ``device="cpu"`` for the CPU).  For
    colour, ``out_dtype`` or debug outputs on a batch use
    ``render_frame``, which takes the same leading axis.
    """
    camera = camera or CameraParams()
    params = params or AOParams()
    depths = _as_tensor(depths, device)
    if depths.ndim != 3:
        raise ValueError(f"depths must be (V, H, W), got "
                         f"{tuple(depths.shape)}")
    return ao_pipeline(depths, camera, params, normals, impl=impl)[0]

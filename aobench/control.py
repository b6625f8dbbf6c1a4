"""The control of the check: the plain reference put in the program's
place and computed in bfloat16, the precision below the float32 that the
configurations state (there is no matrix product on the path, so TF32 does
not apply).  Its widest gap from the float64 reference on the same frames
sets the upper reading of ``max_abs_err``'s limit; the program's gaps over
a dozen seeds and more (``readings.py``) set the lower.  ``render`` is the
same control in the shape of the program's entry, for a run that puts it
in the program's place.
"""

from __future__ import annotations

import torch

from aobench.reference import golden
from aobench.reference.params import from_config


def control_gap(depth, normals, config: dict, indices,
                dtype: torch.dtype = torch.bfloat16) -> float:
    """The widest gap between the reference in ``dtype`` and in float64
    over the pool frames ``indices``."""
    params, camera = from_config(config)
    worst = 0.0
    for i in indices:
        n = None if normals is None else normals[i]
        ref = golden.render_frame(depth[i], camera, params, n)
        low = golden.render_frame(depth[i], camera, params, n, dtype=dtype)
        worst = max(worst, float((low.to(torch.float64) - ref).abs().max()))
    return worst


def render(config: dict, dtype: torch.dtype = torch.bfloat16):
    """The reference in ``dtype`` as the engine's entry: ``f(depth,
    normals)`` of one (H, W) frame or a batch (V, H, W), float32 out."""
    params, camera = from_config(config)

    def one(d, n):
        return golden.render_frame(d, camera, params, n,
                                   dtype=dtype).to(torch.float32)

    def f(depth, normals=None):
        if depth.dim() == 2:
            return one(depth, normals)
        return torch.stack([one(depth[v], None if normals is None
                                else normals[v])
                            for v in range(depth.shape[0])])
    return f

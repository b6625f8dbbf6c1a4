"""The control of the check: the plain reference put in the program's
place and computed in bfloat16, the precision below the float32 that the
configurations state (there is no matrix product on the path, so TF32 does
not apply).  Its widest gap from the float64 reference on the same inputs,
less that reference's allowance, sets the upper reading of
``max_abs_err``'s limit; the program's gaps over a dozen seeds and more
(``readings.py``) set the lower.  Both take the traffic kind's
``reference`` where it defines one, such as a temporal sequence's, else
the one-frame reference of a pool frame (``harness.one_frame``).  ``render`` is the same
control in the shape of the program's entry, for a run that puts it in
the program's place.
"""

from __future__ import annotations

import torch

from aobench import harness
from aobench.reference import golden
from aobench.reference.params import from_config

F64 = torch.float64


def control_gap(pool, config: dict, keys, device,
                workload: dict | None = None, reference=None,
                dtype: torch.dtype = torch.bfloat16) -> float:
    """The widest gap, less the float64 reference's allowance, between
    the reference (``reference``, by default ``harness.one_frame``) in
    ``dtype`` and in float64 over the samples ``keys`` of ``pool``."""
    reference = reference or harness.one_frame
    worst = 0.0
    for key in sorted(set(keys)):
        ref, slack = reference(key, pool, config, workload, device)
        low, _ = reference(key, pool, config, workload, device, dtype=dtype)
        gap = (low.to(F64) - ref).abs()
        if slack is not None:
            gap = gap - slack
        worst = max(worst, float(gap.max()))
    return worst


def render(config: dict, dtype: torch.dtype = torch.bfloat16,
           reference=None, workload: dict | None = None):
    """The reference in ``dtype`` in the program's place, float32 out.
    Without a kind's ``reference``: as the engine's entry, ``f(depth,
    normals)`` of one (H, W) frame or a batch (V, H, W).  With one:
    ``f(key, pool, device)``, the output of the sample under ``key``."""
    if reference is not None:
        def sample(key, pool, device):
            out, _ = reference(key, pool, config, workload, device,
                               dtype=dtype)
            return out.to(torch.float32)
        return sample

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

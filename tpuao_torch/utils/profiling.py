"""Per-stage device times of the frame program (the frame debugger's
view).

Counterpart of ``tpuao/utils/profiling.py``'s ``stage_times_ms``, with the
same stage keys: ``prepare``, ``render_l{l}`` and ``upsample_l{l}`` for
each level l of the hierarchy, and ``full_pipeline``.  The JAX package
times a stage by chaining it in a device loop, because its relay returns
at enqueue time and carries the frame over the network
(``device_time_ms``, ``host_chain_time_ms``).  Here a stage's time is the
card's own: ``utils.timing.cuda_graph_ms`` (the stage's launches captured
in a CUDA graph and replayed, no host in the way) by default, and
``utils.timing.cuda_time_ms`` (CUDA events around each call) where the
host's launch path should count.  Peak memory is
``torch.cuda.max_memory_allocated``; launches and device time by kernel
are ``utils.roofline.launch_census``.
"""

from __future__ import annotations

import torch

from tpuao_torch.params import padded_shape
from tpuao_torch.utils.timing import cuda_graph_ms


def stage_times_ms(depth, camera, params, normals=None, impl: str = "auto",
                   timer=None, device=None) -> dict[str, float]:
    """``{stage: ms}`` of one call of the frame program on ``depth``
    ((H, W) or a batch; NumPy goes to ``device``, default the card).

    Each stage is timed on its real inputs: ``prepare`` (pad to 64,
    linearise, the pyramid's dense levels), ``render_l{l}`` on level l
    (with the slope planes when ``normals`` are given and
    ``params.use_normals``), ``upsample_l{l}`` the chain step l -> l-1 on
    the combined AO the steps below it made (pre-min with level l's AO
    but at the coarsest step; the last cropped to (H, W)), and
    ``full_pipeline`` the program under ``impl``.  The stages run the
    render and upsample kernels (their plain versions under ``"jnp"``)
    as ``"pallas"`` orders them; under ``"auto"`` the program itself
    fuses levels 1..d-1 into the chain.  ``timer(call)`` (default
    ``cuda_graph_ms``) is required off the card.
    """
    from tpuao_torch.models.pipeline import (_as_tensor, _normals_on,
                                             _pad_to_64, ao_pipeline)
    from tpuao_torch.ops import kernels as K
    from tpuao_torch.ops import prepare as P
    from tpuao_torch.ops import render as R
    from tpuao_torch.ops import upsample as U

    depth = _as_tensor(depth, device)
    if timer is None:
        if depth.device.type != "cuda":
            raise ValueError("stage_times_ms times on the card "
                             "(utils.timing.cuda_graph_ms); off it, pass a "
                             "timer")
        timer = cuda_graph_ms
    h0, w0 = depth.shape[-2:]
    hp, wp = padded_shape(h0, w0)
    d = params.hierarchy_depth
    plain = impl == "jnp"
    render = R.render_ao_level if plain else K.render_ao_level
    upsample = U.blur_upsample_step if plain else K.blur_upsample_step
    out = {}

    def prep():
        linz = P.linearize_depth(_pad_to_64(depth.to(torch.float32), hp, wp),
                                 camera)
        return [lvl.contiguous() for lvl in P.build_pyramid(linz, d)]

    out["prepare"] = timer(prep)
    pyr = prep()
    skw = [{} for _ in range(d + 1)]
    if normals is not None and params.use_normals:
        normals = _normals_on(normals, depth.device)
        skw = [{"slopes_ds": g} for g in R.slope_pyramid(
            normals.to(torch.float32), camera.tan_half_fov_h, hp, wp, d,
            h0=h0, w0=w0)]
    for l in range(1, d + 1):
        out[f"render_l{l}"] = timer(lambda l=l: render(
            pyr[l], l, wp, camera, params, **skw[l]))
    aos = {l: render(pyr[l], l, wp, camera, params, **skw[l])
           for l in range(1, d + 1)}
    combined = aos[d]
    for l in range(d, 0, -1):
        kw = {"lo_ao2": None if l == d else aos[l],
              "crop_hw": (h0, w0) if l == 1 else None}
        out[f"upsample_l{l}"] = timer(lambda c=combined, l=l, kw=kw: upsample(
            c, pyr[l], pyr[l - 1], params, wp, **kw))
        combined = upsample(combined, pyr[l], pyr[l - 1], params, wp, **kw)
    out["full_pipeline"] = timer(
        lambda: ao_pipeline(depth, camera, params, normals, impl=impl)[0])
    return out

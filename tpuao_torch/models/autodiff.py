"""Differentiable AO: gradients through the whole frame pipeline.

Counterpart of ``tpuao/models/autodiff.py`` on torch autograd.  The five
``PARAM_RANGES`` tunables become leaf tensors for the call, and autograd
flows through prepare -> render -> blur/upsample -> crop:

  * ``ao_loss``       -- mean-squared error of the rendered AO vs a target;
  * ``ao_grads``      -- its gradients w.r.t. the tunables (and optionally
                         the depth buffer);
  * ``fit_tunables``  -- projected-Adam calibration of chosen tunables to a
                         target AO image.

No CUDA kernel has a backward, so here ``impl="auto"`` means ``"jnp"``,
the plain PyTorch ops on whatever device the depth is on, as the JAX
package's ``"auto"`` is its jnp path; ``"pallas"`` and ``"fused"`` raise
``ValueError`` (``models/pipeline.ao_pipeline``), as the JAX package's
kernels refuse gradients.  The
strength power has a clamped-subgradient backward
(``ops/render._pow_gradsafe``), so a fully occluded texel gives no inf or
nan.
"""

from __future__ import annotations

import torch

from tpuao_torch.models.pipeline import _as_tensor, ao_pipeline
from tpuao_torch.params import PARAM_RANGES, AOParams, CameraParams

# The tunables that autograd differentiates.
TRACED_TUNABLES = tuple(PARAM_RANGES)


def ao_loss(params, depth, target_ao, camera, normals=None,
            impl: str = "auto", device=None) -> torch.Tensor:
    """Mean-squared error of the pipeline's AO against ``target_ao``, a
    0-d float32 tensor.  NumPy input goes to ``device`` (default the
    card); the target goes to the depth's device.  ``impl="auto"`` runs
    the plain ops (``"jnp"``)."""
    depth = _as_tensor(depth, device)
    ao, _ = ao_pipeline(depth, camera, params, normals,
                        impl="jnp" if impl == "auto" else impl)
    d = ao - _as_tensor(target_ao, depth.device).to(torch.float32)
    return torch.mean(d * d)


def _leaves(params: AOParams, device) -> dict[str, torch.Tensor]:
    """The traced tunables as fresh float32 leaf tensors on ``device``."""
    return {n: torch.tensor(float(getattr(params, n)), dtype=torch.float32,
                            device=device, requires_grad=True)
            for n in TRACED_TUNABLES}


def ao_grads(params, depth, target_ao, camera=None, normals=None,
             wrt_depth: bool = False, impl: str = "auto", device=None):
    """Gradients of ``ao_loss``.

    Returns ``(loss, grad_params)`` -- ``grad_params`` is an ``AOParams``
    whose five traced fields hold d(loss)/d(tunable) as detached 0-d
    float32 tensors, its structure fields copied from ``params`` -- or
    ``(loss, grad_params, grad_depth)`` with ``wrt_depth=True``.  NumPy
    input goes to ``device`` (default the card).
    """
    camera = camera or CameraParams()
    depth = _as_tensor(depth, device).detach().to(torch.float32)
    leaves = _leaves(params, depth.device)
    depth.requires_grad_(wrt_depth)
    with torch.enable_grad():
        loss = ao_loss(params.replace(**leaves), depth, target_ao, camera,
                       normals, impl)
        wrt = list(leaves.values()) + ([depth] if wrt_depth else [])
        grads = torch.autograd.grad(loss, wrt)
    gp = params.replace(**dict(zip(TRACED_TUNABLES, grads)))
    if wrt_depth:
        return loss.detach(), gp, grads[-1]
    return loss.detach(), gp


def _project(leaves: dict[str, torch.Tensor]) -> None:
    """Clamp every traced tunable into its inspector range (PARAM_RANGES),
    in place."""
    with torch.no_grad():
        for n, (lo, hi) in PARAM_RANGES.items():
            leaves[n].clamp_(lo, hi)


def fit_tunables(depth, target_ao, camera=None, params0=None, normals=None,
                 fit: tuple[str, ...] = ("strength", "rejection_falloff"),
                 steps: int = 60, lr: float = 0.1, impl: str = "auto",
                 device=None):
    """Calibrate the ``fit`` tunables so the rendered AO matches
    ``target_ao``.

    Projected Adam on the MSE loss: ``torch.optim.Adam(lr=lr)`` steps the
    fitted tunables only (the others stay as they are, as under the JAX
    package's gradient mask), and after every step each traced tunable is
    clamped into PARAM_RANGES (the bounds of the reference's inspector
    sliders).  A Python loop of ``steps`` forward and backward passes.

    Returns ``(fitted AOParams with 0-d tensor tunables, losses)``;
    ``losses[i]`` is the loss before step i, a (steps,) float32 tensor on
    the depth's device.
    """
    camera = camera or CameraParams()
    params0 = params0 or AOParams()
    unknown = set(fit) - set(TRACED_TUNABLES)
    if unknown:
        raise ValueError(f"not differentiable tunables: {sorted(unknown)}")
    depth = _as_tensor(depth, device).detach().to(torch.float32)
    target_ao = _as_tensor(target_ao, depth.device).detach().to(torch.float32)
    leaves = _leaves(params0, depth.device)
    opt = torch.optim.Adam([leaves[n] for n in TRACED_TUNABLES if n in fit],
                           lr=lr)
    losses = torch.empty(steps, dtype=torch.float32, device=depth.device)
    with torch.enable_grad():
        for i in range(steps):
            for t in leaves.values():  # the frozen ones' too
                t.grad = None
            loss = ao_loss(params0.replace(**leaves), depth, target_ao,
                           camera, normals, impl)
            loss.backward()
            opt.step()
            _project(leaves)
            losses[i] = loss.detach()
    fitted = params0.replace(**{n: t.detach() for n, t in leaves.items()})
    return fitted, losses

"""tpuao_torch.models.autodiff against tpuao.models.autodiff, on the CPU.

The same NumPy inputs (a spheres-on-plane scene made from a seed, and a
target rendered at strength 1.4) go through both packages: the loss to
1e-6 relative, each tunable's gradient to 1e-3 relative (1e-7 absolute
below that), the depth gradient to 1e-3 of its largest element, and a
5-step fit's losses and fitted values to 1e-4.  tpuao's results are
computed once per module (its first calls compile).  The routing that
sends gradient calls to the plain ops, and the kernel wrappers' refusal
of tensors that require grad, are checked here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuao.models import autodiff as JA
from tpuao.ops import render as JR
from tpuao.params import AOParams as JAOParams
from tpuao.params import CameraParams as JCameraParams

from tpuao_torch.models import autodiff as A
from tpuao_torch.models import pipeline as PL
from tpuao_torch.ops import kernels as K
from tpuao_torch.ops import render as R
from tpuao_torch.params import AOParams, CameraParams
from tpuao_torch.utils import fixtures as F

H, W = 64, 96
CAM, JCAM = CameraParams(depth_mode="linear"), JCameraParams(
    depth_mode="linear")
RTOL_LOSS = 1e-6
RTOL_GRAD, ATOL_GRAD = 1e-3, 1e-7
TOL_FIT = 1e-4


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    K.reset_launch_counts()
    yield
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)


@pytest.fixture(scope="module")
def scene():
    """Depth (and normals) of one scene and targets rendered at strength
    1.4 (with and without normals)."""
    z, n = F.spheres_on_plane(H, W, CAM, n_spheres=3, seed=3,
                              with_normals=True)
    z, n = z.astype(np.float32), n.astype(np.float32)
    target = PL.render_frame(z, CAM, AOParams(strength=1.4),
                             device="cpu").numpy()
    target_n = PL.render_frame(z, CAM, AOParams(strength=1.4,
                                                use_normals=True),
                               normals=n, device="cpu").numpy()
    return z, n, target, target_n


@pytest.fixture(scope="module")
def tpuao_grads(scene):
    """tpuao's (loss, grads[, grad_depth]): depth only with the depth
    gradient, and with normals."""
    z, n, target, target_n = scene
    depth_only = JA.ao_grads(JAOParams(), jnp.asarray(z), jnp.asarray(target),
                             JCAM, wrt_depth=True)
    normals = JA.ao_grads(JAOParams(use_normals=True), jnp.asarray(z),
                          jnp.asarray(target_n), JCAM,
                          normals=jnp.asarray(n))
    return {"depth only": jax.device_get(depth_only),
            "normals": jax.device_get(normals)}


def test_pow_gradsafe_matches_tpuao():
    x = np.array([0.0, 1e-20, 0.25, 0.5, 1.0], np.float32)
    for s in (0.1, 0.5, 1.0, 2.5):
        xt = torch.tensor(x, requires_grad=True)
        st = torch.tensor(s, requires_grad=True)
        y = R._pow_gradsafe(xt, st)
        assert torch.equal(y.detach(), torch.pow(torch.tensor(x),
                                                 st.detach()))
        gx, gs = torch.autograd.grad(y.sum(), (xt, st))
        jgx, jgs = jax.grad(lambda a, b: JR._pow_gradsafe(a, b).sum(),
                            argnums=(0, 1))(jnp.asarray(x), jnp.float32(s))
        assert torch.isfinite(gx).all() and torch.isfinite(gs)
        np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-6)
        np.testing.assert_allclose(float(gs), float(jgs), rtol=1e-6)
    # a float exponent has no gradient; without autograd it is torch.pow
    xt = torch.tensor(x, requires_grad=True)
    (gx,) = torch.autograd.grad(R._pow_gradsafe(xt, 0.5).sum(), (xt,))
    assert torch.isfinite(gx).all()
    with torch.no_grad():
        assert torch.equal(R._pow_gradsafe(xt, 0.5), torch.pow(xt, 0.5))


def test_ao_loss_matches_tpuao(scene, tpuao_grads):
    """With float32 tensor tunables, as tpuao's traced loss has them (a
    loss of ~1e-6 from differences of ~1e-3 magnifies the float64 or
    float32 rounding of the chain constants past 1e-6)."""
    z, _, target, _ = scene
    want = float(tpuao_grads["depth only"][0])  # tpuao's loss at AOParams()
    par = AOParams().replace(**{n: torch.tensor(float(getattr(AOParams(), n)))
                                for n in A.TRACED_TUNABLES})
    got = A.ao_loss(par, z, target, CAM, device="cpu")
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=RTOL_LOSS)
    # with float tunables on both sides (tpuao's eager call)
    jl = JA.ao_loss(JAOParams(strength=2.0), jnp.asarray(z),
                    jnp.asarray(target), JCAM)
    np.testing.assert_allclose(
        float(A.ao_loss(AOParams(strength=2.0), z, target, CAM,
                        device="cpu")), float(jl), rtol=RTOL_LOSS)


def _close_grads(gp, jgp):
    for name in A.TRACED_TUNABLES:
        g, j = getattr(gp, name), float(getattr(jgp, name))
        assert isinstance(g, torch.Tensor) and g.shape == () and \
            not g.requires_grad, name
        np.testing.assert_allclose(float(g), j, rtol=RTOL_GRAD,
                                   atol=ATOL_GRAD, err_msg=name)


@pytest.mark.parametrize("case", ["depth only", "normals"])
def test_ao_grads_match_tpuao(scene, tpuao_grads, case):
    z, n, target, target_n = scene
    want = tpuao_grads[case]
    if case == "depth only":
        loss, gp, gd = A.ao_grads(AOParams(), z, target, CAM, wrt_depth=True,
                                  device="cpu")
        jgd = np.asarray(want[2])
        assert gd.shape == (H, W) and torch.isfinite(gd).all()
        np.testing.assert_allclose(gd.numpy(), jgd,
                                   atol=1e-3 * np.abs(jgd).max())
    else:
        loss, gp = A.ao_grads(AOParams(use_normals=True), z, target_n, CAM,
                              normals=n, device="cpu")
        assert gp.use_normals
    np.testing.assert_allclose(float(loss), float(want[0]), rtol=RTOL_LOSS)
    _close_grads(gp, want[1])
    assert float(gp.strength) != 0.0  # the target is at another strength


@pytest.mark.parametrize("fit", [("strength",),
                                 ("strength", "rejection_falloff")])
def test_fit_tunables_matches_tpuao(scene, fit):
    z, _, target, _ = scene
    p0 = AOParams(hierarchy_depth=2)
    # lr 0.02 keeps the 5 steps short of the minimum: near it a loss of
    # differences of ~1e-4 is float32 noise to ~1e-4 relative
    fitted, losses = A.fit_tunables(z, target, CAM, params0=p0, fit=fit,
                                    steps=5, lr=0.02, device="cpu")
    jfit, jlosses = JA.fit_tunables(jnp.asarray(z), jnp.asarray(target), JCAM,
                                    params0=JAOParams(hierarchy_depth=2),
                                    fit=fit, steps=5, lr=0.02)
    assert losses.shape == (5,) and losses.dtype == torch.float32
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=TOL_FIT)
    assert float(losses[-1]) < float(losses[0])
    for name in A.TRACED_TUNABLES:
        got = getattr(fitted, name)
        assert isinstance(got, torch.Tensor) and not got.requires_grad
        np.testing.assert_allclose(float(got), float(getattr(jfit, name)),
                                   atol=TOL_FIT, err_msg=name)
        if name not in fit:  # frozen: exactly where it started
            assert float(got) == np.float32(getattr(p0, name)), name
    assert fitted.hierarchy_depth == 2


def test_fit_clamps_into_the_ranges_and_refuses_unknown_names(scene):
    z, _, _, _ = scene
    # a target darker than the upper bound of strength can make: Adam
    # steps strength up by ~lr, and the projection holds it at 10
    target = np.zeros((H, W), np.float32)
    fitted, _ = A.fit_tunables(z, target, CAM,
                               params0=AOParams(strength=9.9,
                                                hierarchy_depth=1),
                               fit=("strength",), steps=2, lr=0.5,
                               device="cpu")
    assert float(fitted.strength) == 10.0
    with pytest.raises(ValueError, match="not differentiable tunables: "
                       r"\['near'\]"):
        A.fit_tunables(z, target, CAM, fit=("near",), device="cpu")


def test_gradients_route_to_the_plain_ops(scene, monkeypatch):
    """Autodiff's impl='auto' runs the plain ops (no kernel wrapper is
    called), and 'pallas'/'fused' raise, as tpuao's do.  The pipeline
    itself swaps nothing: asked for gradients, every impl but 'jnp'
    raises there; without gradients every impl is as it was."""
    z, _, target, _ = scene
    wrappers = ("render_ao_level", "blur_upsample_step",
                "fused_render_upsample_step")
    called = []
    for name in wrappers:
        real = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _n=name, _r=real, **k:
                            called.append(_n) or _r(*a, **k))
    A.ao_grads(AOParams(), z, target, CAM, device="cpu")
    assert called == []
    for impl in ("pallas", "fused"):
        with pytest.raises(ValueError, match="backward"):
            A.ao_grads(AOParams(), z, target, CAM, impl=impl, device="cpu")
        with pytest.raises(ValueError, match="backward"):
            A.ao_loss(AOParams(), torch.tensor(z, requires_grad=True),
                      target, CAM, impl=impl)
    leaf = AOParams(strength=torch.tensor(1.0, requires_grad=True))
    for impl in ("auto", "pallas", "fused"):
        with pytest.raises(ValueError, match='use impl="jnp"'):
            PL.render_frame(z, CAM, leaf, impl=impl, device="cpu")
    assert called == []
    assert PL.render_frame(z, CAM, leaf, impl="jnp",
                           device="cpu").grad_fn is not None
    with torch.no_grad():  # a leaf that requires grad, but autograd is off
        PL.render_frame(z, CAM, leaf, device="cpu")
    assert called == ["render_ao_level", "blur_upsample_step"] + \
        ["fused_render_upsample_step"] * 3


def test_kernel_wrappers_refuse_tensors_that_require_grad():
    """The wrappers' check, called directly on CPU tensors (the wrappers
    run it on CUDA tensors only; the CPU branch differentiates)."""
    x = torch.ones(4, 4)
    K._check_no_grad("w", (x, None), AOParams())  # nothing needs a grad
    with pytest.raises(ValueError, match="no backward"):
        K._check_no_grad("w", (x, x.clone().requires_grad_()), AOParams())
    for name in A.TRACED_TUNABLES:
        p = AOParams().replace(**{name: torch.tensor(
            float(getattr(AOParams(), name)), requires_grad=True)})
        with pytest.raises(ValueError, match='use impl="jnp"'):
            K._check_no_grad("w", (x,), p)
        with torch.no_grad():
            K._check_no_grad("w", (x,), p)
    # on the CPU a wrapper runs its plain version, and that differentiates
    zr = (torch.rand(16, 16) + 0.5).requires_grad_()
    out = K.render_ao_level(zr, 1, 32, CAM, AOParams())
    assert out.grad_fn is not None

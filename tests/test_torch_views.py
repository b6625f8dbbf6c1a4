"""tpuao_torch.parallel.sharding (one card) against tpuao's, on the CPU.

``render_views`` is the frame pipeline over a leading views axis, which the
port's kernels take as their grid's batch; it is held against tpuao's
vmapped ``render_views`` (impl="jnp") to 1e-5, float32 against float32.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpuao.params import AOParams as JAOParams
from tpuao.params import CameraParams as JCameraParams
from tpuao.parallel import sharding as JSH

from tpuao_torch.models.pipeline import render_frame
from tpuao_torch.params import AOParams, CameraParams
from tpuao_torch.parallel import sharding as SH
from tpuao_torch.utils import fixtures as F

TOL = 1e-5


def views(n, h=48, w=64, normals=False):
    out = [F.spheres_on_plane(h, w, CameraParams(depth_mode="linear"),
                              n_spheres=2, seed=s, with_normals=normals)
           for s in range(n)]
    if normals:
        return (np.stack([z for z, _ in out]).astype(np.float32),
                np.stack([n for _, n in out]).astype(np.float32))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("use_normals", [False, True])
def test_render_views_matches_tpuao(use_normals):
    cam, jcam = (CameraParams(depth_mode="linear"),
                 JCameraParams(depth_mode="linear"))
    if use_normals:
        z, n = views(3, normals=True)
    else:
        z, n = views(3), None
    got = SH.render_views(z, cam, AOParams(use_normals=use_normals),
                          normals=n, device="cpu")
    want = np.asarray(JSH.render_views(
        jnp.asarray(z), jcam, JAOParams(use_normals=use_normals),
        normals=None if n is None else jnp.asarray(n), impl="jnp"))
    assert got.shape == (3, 48, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    for i in range(3):  # a view's result does not depend on its batch
        np.testing.assert_array_equal(
            got[i].numpy(),
            render_frame(z[i], cam, AOParams(use_normals=use_normals),
                         normals=None if n is None else n[i],
                         device="cpu").numpy())
    with pytest.raises(ValueError, match="V, H, W"):
        SH.render_views(z[0], cam, device="cpu")


@pytest.mark.parametrize("pad", [0, 1, 5])
def test_pad_leading_matches_tpuao(pad):
    x = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    got = SH.pad_leading(torch.as_tensor(x), pad)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JSH.pad_leading(jnp.asarray(x), pad)))
    with pytest.raises(ValueError, match="pad"):
        SH.pad_leading(torch.as_tensor(x), -1)


def test_multi_card_modes_are_not_defined():
    for name in ("render_views_sharded", "make_mesh"):
        assert not hasattr(SH, name)

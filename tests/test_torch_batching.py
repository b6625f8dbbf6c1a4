"""tpuao_torch.utils.batching, mirroring tests/test_batching.py.

Batched results are held against the port's own per-frame render (the
batch is a kernel grid dimension, so a frame's result does not depend on
its batch: equal bits on the CPU too) and against tpuao's render to 1e-5.
"""

import threading

import numpy as np
import pytest
import torch

from tpuao.models.pipeline import render_frame as jax_render_frame
from tpuao.params import AOParams as JAOParams
from tpuao.params import CameraParams as JCameraParams
from tpuao.utils.batching import MicroBatcher as JMicroBatcher

from tpuao_torch.models.pipeline import render_frame
from tpuao_torch.params import AOParams, CameraParams
from tpuao_torch.utils import fixtures as F
from tpuao_torch.utils.batching import MicroBatcher

CAM = CameraParams(depth_mode="linear")
PAR = AOParams(hierarchy_depth=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _render(batch, normals=None, color=None):
    params = PAR.replace(use_normals=True) if normals is not None else PAR
    return render_frame(batch, CAM, params, normals=normals, color=color,
                        device="cpu")


def _one(z, **kw):
    return _render(z, **kw).numpy()


def _scene(seed, h=48, w=64):
    return F.spheres_on_plane(h, w, seed=seed, n_spheres=2).astype(np.float32)


def test_batched_results_match_per_frame_and_tpuao():
    frames = [_scene(s) for s in range(6)]
    with MicroBatcher(_render, batch_size=4, max_delay_ms=50.0) as mb:
        outs = [f.result(timeout=120) for f in [mb.submit(z) for z in frames]]
    for z, ao in zip(frames, outs):
        assert isinstance(ao, np.ndarray) and ao.dtype == np.float32
        np.testing.assert_array_equal(ao, _one(z))
        want = np.asarray(jax_render_frame(
            z, JCameraParams(depth_mode="linear"),
            JAOParams(hierarchy_depth=2), impl="jnp"))
        np.testing.assert_allclose(ao, want, atol=1e-5)


def test_results_own_their_memory():
    with MicroBatcher(_render, batch_size=4, max_delay_ms=10.0) as mb:
        out = mb.submit(_scene(3)).result(timeout=120)
    assert out.base is None


def test_partial_batch_flushes_on_timeout():
    z = _scene(9)
    with MicroBatcher(_render, batch_size=8, max_delay_ms=20.0) as mb:
        out = mb.submit(z).result(timeout=120)
    np.testing.assert_array_equal(out, _one(z))


def test_mixed_shapes_group_separately():
    za, zb = _scene(3), _scene(4, h=32)
    with MicroBatcher(_render, batch_size=2, max_delay_ms=20.0) as mb:
        outs = [f.result(timeout=120) for f in
                [mb.submit(za), mb.submit(zb), mb.submit(za), mb.submit(zb)]]
    assert outs[0].shape == (48, 64) and outs[1].shape == (32, 64)
    np.testing.assert_array_equal(outs[2], _one(za))
    np.testing.assert_array_equal(outs[3], _one(zb))


def test_multibuffer_submits_batch_homogeneously():
    calls = []

    def render(batch, normals=None, color=None):
        calls.append((normals is not None, color is not None))
        return _render(batch, normals=normals, color=color)

    z, nrm = F.spheres_on_plane(48, 64, n_spheres=2, seed=4,
                                with_normals=True)
    z, nrm = z.astype(np.float32), nrm.astype(np.float32)
    col = np.random.default_rng(0).uniform(0, 1, (48, 64, 3)).astype(
        np.float32)
    with MicroBatcher(render, batch_size=2, max_delay_ms=200.0) as mb:
        fn = [mb.submit(z, normals=nrm), mb.submit(z, normals=nrm)]
        fd = mb.submit(z)
        fc = mb.submit(z, normals=nrm, color=col)
        aon = [f.result(timeout=120) for f in fn]
        aod, rgb = fd.result(timeout=120), fc.result(timeout=120)
    assert sorted(calls) == [(False, False), (True, False), (True, True)]
    for ao in aon:
        np.testing.assert_array_equal(ao, _one(z, normals=nrm))
    np.testing.assert_array_equal(aod, _one(z))
    assert rgb.shape == (48, 64, 3)
    np.testing.assert_array_equal(rgb, _one(z, normals=nrm, color=col))
    with MicroBatcher(render, batch_size=2) as mb:
        with pytest.raises(ValueError, match="normals"):
            mb.submit(z, normals=nrm[:32])
        with pytest.raises(ValueError, match="color"):
            mb.submit(z, color=col[:, :32])


def test_concurrent_submitters():
    frames = [_scene(20 + s) for s in range(8)]
    results = {}
    with MicroBatcher(_render, batch_size=4, max_delay_ms=10.0) as mb:
        def client(i):
            results[i] = mb.submit(frames[i]).result(timeout=180)

        ts = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=180)
        st = mb.stats()
    for i, z in enumerate(frames):
        np.testing.assert_array_equal(results[i], _one(z))
    # the invariant that holds at any timing: every frame rendered, pad
    # frames included, rode exactly one flush of its rung
    assert st["frames"] == 8
    assert st["frames"] + st["padded"] == sum(
        r * n for r, n in st["rung_flushes"].items())


def test_render_fn_may_return_a_tensor_or_numpy():
    z = _scene(5)
    with MicroBatcher(lambda b: _render(b).numpy(), batch_size=2,
                      max_delay_ms=5.0) as mb:
        np.testing.assert_array_equal(mb.submit(z).result(timeout=60),
                                      _one(z))


def test_close_rejects_new_and_is_idempotent():
    mb = MicroBatcher(_render, batch_size=2)
    mb.close()
    mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(np.ones((48, 64), np.float32))


def test_bad_inputs():
    with pytest.raises(ValueError, match="batch_size"):
        MicroBatcher(_render, batch_size=0)
    with MicroBatcher(_render, batch_size=2) as mb:
        with pytest.raises(ValueError, match="frame"):
            mb.submit(np.ones((2, 48, 64), np.float32))


@pytest.mark.parametrize("n,delay,rung,pad", [(1, 20.0, 1, 0),
                                              (3, 200.0, 4, 1),
                                              (8, 200.0, 8, 0)])
def test_ladder_rungs(n, delay, rung, pad):
    sizes = []

    def render(batch):
        sizes.append(batch.shape[0])
        return _render(batch)

    zs = [_scene(s) for s in range(n)]
    with MicroBatcher(render, batch_size=8, max_delay_ms=delay) as mb:
        assert mb.ladder == (1, 4, 8)
        outs = [f.result(timeout=120) for f in [mb.submit(z) for z in zs]]
        st = mb.stats()
    assert sizes == [rung]
    assert st["rung_flushes"] == {r: int(r == rung) for r in (1, 4, 8)}
    assert st["padded"] == pad
    for z, ao in zip(zs, outs):
        np.testing.assert_array_equal(ao, _one(z))


def test_warm_renders_every_rung_like_tpuao():
    sizes, jsizes = [], []
    z = np.full((48, 64), 0.5, np.float32)
    with MicroBatcher(lambda b, **kw: sizes.append(b.shape[0]) or _render(b),
                      batch_size=8) as mb:
        assert mb.warm(z) == [1, 4, 8]
    with JMicroBatcher(lambda b, **kw: jsizes.append(b.shape[0]) or b,
                       batch_size=8) as jmb:
        assert jmb.warm(z) == [1, 4, 8]
    assert sizes == jsizes == [1, 4, 8]


def test_ladder_validation_like_tpuao():
    with pytest.raises(ValueError, match="ladder"):
        MicroBatcher(_render, batch_size=4, ladder=(1, 8))
    for bs, ladder in ((4, (2, 2, 1)), (2, None), (8, None), (1, None)):
        with MicroBatcher(_render, batch_size=bs, ladder=ladder) as mb, \
                JMicroBatcher(_render, batch_size=bs, ladder=ladder) as jmb:
            assert mb.ladder == jmb.ladder


def test_oldest_queue_flushes_first():
    order = []

    def render(batch):
        order.append(batch.shape[-2])
        return _render(batch)

    mb = MicroBatcher(render, batch_size=4, max_delay_ms=1e6)
    try:
        with mb._lock:  # queue both before the worker looks
            fa = mb.submit(_scene(1, h=32))
            fb = mb.submit(_scene(2))
        mb.close()  # drains: the oldest head first
        fa.result(timeout=60), fb.result(timeout=60)
    finally:
        mb.close()
    assert order == [32, 48]

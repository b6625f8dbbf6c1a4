"""tpuao_torch.utils.frameio and .native against tpuao's, on the CPU.

The PFM codec must be byte-identical with the JAX package's in both
directions (a frame written by one reads back bit for bit through the
other), its native and NumPy paths must agree, and its errors must say the
same.  The native ray-caster (``utils/fixtures.py``'s ``backend``) must give
the NumPy path's bits and tpuao's.  Inputs are made with numpy from a seed.
"""

import threading
import time

import numpy as np
import pytest

from tpuao.utils import fixtures as JF
from tpuao.utils import frameio as JFIO
from tpuao.utils import native as JN

from tpuao_torch.params import CameraParams
from tpuao_torch.utils import fixtures as TF
from tpuao_torch.utils import frameio as FIO
from tpuao_torch.utils import native as N


def _frame(h=37, w=53, seed=0):
    return np.random.default_rng(seed).uniform(0.05, 1.0, (h, w)).astype(
        np.float32)


def _frame3(h=37, w=53, seed=0):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (h, w, 3)).astype(
        np.float32)


FRAMES = [_frame(seed=1), _frame3(seed=2), _frame(1, 1, seed=3),
          _frame3(5, 2, seed=4)]


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """Run a test on the native codec and again on the NumPy one, in both
    packages."""
    if request.param == "numpy":
        monkeypatch.setattr(FIO, "_lib", lambda: None)
        monkeypatch.setattr(JFIO, "_lib", lambda: None)
    else:
        assert FIO._lib() is not None and JFIO._lib() is not None
    return request.param


def test_native_lib_builds_under_its_own_name():
    lib = N.get_lib()
    assert lib is not None and lib.tpuao_native_abi_version() == \
        N.ABI_VERSION == JN.ABI_VERSION
    built = N.library_path()
    assert built.parent.name == "_build" and built.exists()
    assert built.name.startswith("libtpuao_torch_native_")
    assert built.name != "libtpuao_native.so"  # never tpuao's library


@pytest.mark.parametrize("k", range(len(FRAMES)))
def test_bytes_codec_identical_with_tpuao(k):
    arr = FRAMES[k]
    body = FIO.dumps_pfm(arr)
    assert body == JFIO.dumps_pfm(arr)
    np.testing.assert_array_equal(FIO.loads_pfm(JFIO.dumps_pfm(arr)), arr)
    np.testing.assert_array_equal(JFIO.loads_pfm(body), arr)


@pytest.mark.parametrize("k", range(len(FRAMES)))
def test_files_identical_with_tpuao(tmp_path, path, k):
    arr = FRAMES[k]
    mine = FIO.save_pfm(str(tmp_path / "mine.pfm"), arr)
    theirs = JFIO.save_pfm(str(tmp_path / "theirs.pfm"), arr)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read() == FIO.dumps_pfm(arr)
    np.testing.assert_array_equal(FIO.load_pfm(theirs), arr)
    np.testing.assert_array_equal(JFIO.load_pfm(mine), arr)


def test_big_endian(tmp_path, path):
    for arr, magic in ((_frame(8, 8, seed=5), b"Pf"),
                       (_frame3(8, 8, seed=6), b"PF")):
        p = str(tmp_path / "be.pfm")
        with open(p, "wb") as f:  # positive scale: big-endian samples
            f.write(magic + b"\n8 8\n1.0\n")
            f.write(arr[::-1].astype(">f4").tobytes())
        np.testing.assert_array_equal(FIO.load_pfm(p), arr)
        np.testing.assert_array_equal(FIO.loads_pfm(open(p, "rb").read()),
                                      arr)


@pytest.mark.parametrize("three", [False, True])
def test_batch_load_matches_singles(tmp_path, path, three):
    make = _frame3 if three else _frame
    frames = [make(seed=i) for i in range(5)]
    paths = [FIO.save_pfm(str(tmp_path / f"f{i}.pfm"), z)
             for i, z in enumerate(frames)]
    batch = FIO.load_pfm_batch(paths, threads=3)
    assert batch.shape == (5,) + frames[0].shape
    assert batch.dtype == np.float32
    np.testing.assert_array_equal(batch, np.stack(frames))
    np.testing.assert_array_equal(batch, JFIO.load_pfm_batch(paths))


def test_loads_pfm_multi_like_tpuao():
    frames = [_frame(9, 11, seed=7), _frame3(9, 11, seed=8),
              _frame3(9, 11, seed=9)]
    body = b"".join(FIO.dumps_pfm(f) for f in frames)
    for b in (body, body + b"\n  "):
        got = FIO.loads_pfm_multi(b)
        assert len(got) == 3
        for g, j, want in zip(got, JFIO.loads_pfm_multi(b), frames):
            np.testing.assert_array_equal(g, want)
            np.testing.assert_array_equal(g, j)


def _error(fn, *args):
    """The exception ``fn(*args)`` raises, as (type, text)."""
    with pytest.raises(Exception) as e:
        fn(*args)
    return type(e.value), str(e.value)


@pytest.mark.parametrize("bad", [
    b"", b"Pf", b"Pf\n4", b"Pf\n4 4", b"Pf\n4 4\n-1.0", b"Pf\n4 4\n-1.0\n\0\0",
    b"# only a comment", b"Pf\n4 4\n", b"P6\n1 1\n255\n\0\0\0",
    b"Pf\n0 4\n-1.0\n", b"Pf\nx 4\n-1.0\n"])
def test_loads_errors_like_tpuao(bad):
    assert _error(FIO.loads_pfm, bad) == _error(JFIO.loads_pfm, bad)


def test_multi_body_errors_like_tpuao():
    body = FIO.dumps_pfm(_frame(4, 4))
    for bad in (b"", body + b"garbage", body[:-4], b"  \n"):
        assert _error(FIO.loads_pfm_multi, bad) == \
            _error(JFIO.loads_pfm_multi, bad)


def test_file_errors_like_tpuao(tmp_path, path):
    missing = str(tmp_path / "nope.pfm")
    bad = tmp_path / "bad.pfm"
    bad.write_bytes(b"P6\n1 1\n255\n\0\0\0")
    trunc = tmp_path / "trunc.pfm"
    trunc.write_bytes(b"Pf\n4 4\n-1.0\n" + b"\0" * 10)
    # the NumPy path of both lets open() and np.frombuffer raise for a
    # missing file and a ragged truncation
    native = path == "native"
    for p, msg in ((missing, "cannot open" if native else "No such file"),
                   (str(bad), "header"),
                   (str(trunc), "truncated" if native else "multiple")):
        assert msg in _error(FIO.load_pfm, p)[1]
        assert _error(FIO.load_pfm, p) == _error(JFIO.load_pfm, p)
    a = FIO.save_pfm(str(tmp_path / "a.pfm"), _frame(16, 16))
    for other in (_frame(8, 8), _frame3(16, 16)):
        b = FIO.save_pfm(str(tmp_path / "b.pfm"), other)
        err = _error(FIO.load_pfm_batch, [a, b])
        assert err[0] is ValueError and "size mismatch" in err[1]
        assert err == _error(JFIO.load_pfm_batch, [a, b])
    with pytest.raises(ValueError, match="expected"):
        FIO.save_pfm(str(tmp_path / "c.pfm"), np.zeros((2, 2, 2)))
    with pytest.raises(ValueError, match="expected"):
        FIO.dumps_pfm(np.zeros((2, 2, 4)))


def test_prefetcher_batches_tuples_and_errors(tmp_path):
    batches, items = [], []
    for b in range(3):
        d = [FIO.save_pfm(str(tmp_path / f"d{b}_{i}.pfm"),
                          _frame(seed=10 * b + i)) for i in range(2)]
        n = [FIO.save_pfm(str(tmp_path / f"n{b}_{i}.pfm"),
                          _frame3(seed=50 + 10 * b + i)) for i in range(2)]
        batches.append(d)
        items.append((d, n))
    got = list(FIO.FramePrefetcher(batches, depth=2))
    assert len(got) == 3
    for g, paths in zip(got, batches):
        np.testing.assert_array_equal(g, FIO.load_pfm_batch(paths))
    for (zs, ns), (d, n) in zip(FIO.FramePrefetcher(items), items):
        np.testing.assert_array_equal(zs, FIO.load_pfm_batch(d))
        np.testing.assert_array_equal(ns, FIO.load_pfm_batch(n))
    it = FIO.FramePrefetcher([batches[0], ["/nonexistent.pfm"]])
    next(it)
    with pytest.raises(ValueError, match="cannot open"):
        next(it)
    with pytest.raises(StopIteration):  # sticky after the error
        next(it)


def test_prefetcher_close_releases_worker_and_consumer(tmp_path):
    paths = [[FIO.save_pfm(str(tmp_path / f"c{b}.pfm"), _frame(seed=b))]
             for b in range(6)]
    with FIO.FramePrefetcher(paths, depth=1) as it:
        next(it)  # consume one, abandon the rest
    assert not it._worker.is_alive()
    with pytest.raises(StopIteration):
        next(it)

    def slow_batches():
        time.sleep(2.0)
        yield paths[0]

    it = FIO.FramePrefetcher(slow_batches(), depth=1)
    stopped = threading.Event()

    def consume():
        try:
            next(it)
        except StopIteration:
            stopped.set()

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    time.sleep(0.2)
    it.close()
    t.join(timeout=10)
    assert not t.is_alive() and stopped.is_set()


@pytest.mark.parametrize("hw,seed,eye", [((48, 80), 0, None),
                                         ((33, 47), 5, (0.1, 0.0, -0.5)),
                                         ((64, 64), 9, (0.0, 0.2, 0.3))])
def test_native_raycaster_bit_identical(hw, seed, eye):
    cam = CameraParams(depth_mode="linear", tan_half_fov_h=0.8)
    jcam = JF.GoldenCameraParams(depth_mode="linear", tan_half_fov_h=0.8)
    kw = dict(n_spheres=4, seed=seed, with_normals=True, eye=eye)
    native = TF.spheres_on_plane(*hw, cam, backend="native", **kw)
    numpy_ = TF.spheres_on_plane(*hw, cam, backend="numpy", **kw)
    auto = TF.spheres_on_plane(*hw, cam, **kw)
    theirs = JF.spheres_on_plane(*hw, jcam, backend="numpy", **kw)
    for a, b, c, d in zip(native, numpy_, auto, theirs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, d)
    np.testing.assert_array_equal(
        TF.spheres_on_plane(*hw, seed=seed, backend="native"),
        TF.spheres_on_plane(*hw, seed=seed, backend="numpy"))


def test_raycaster_backend_choice(monkeypatch):
    with pytest.raises(ValueError, match="backend"):
        TF.spheres_on_plane(8, 8, backend="gpu")
    monkeypatch.setattr(N, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native ray-caster"):
        TF.spheres_on_plane(8, 8, backend="native")
    np.testing.assert_array_equal(  # auto takes NumPy without the library
        TF.spheres_on_plane(8, 8, seed=2),
        TF.spheres_on_plane(8, 8, seed=2, backend="numpy"))

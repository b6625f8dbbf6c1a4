"""Frame IO: the PFM codec, a threaded batch loader and a prefetcher.

Counterpart of ``tpuao/utils/frameio.py``, with the same functions, bytes
and error texts, so a frame written by either package reads back the same
through the other.  Decode runs in ``native/frameio.cpp`` (built by
``utils/native.py``; C ABI via ctypes, the GIL released for the whole
batch, a work-stealing thread pool) with a NumPy path beside it, which is
also the executable spec of the native one and what the in-memory codec
(``loads_pfm``, ``loads_pfm_multi``, ``dumps_pfm``) of the serving path
uses.

PFM (portable float map) is the interchange format: float32, lossless.
Grayscale ``Pf`` files carry depth; 3-channel ``PF`` files carry normals,
colour or motion vectors.  Rows in the file are bottom-up per the Netpbm
spec; this module always presents row-major top-down ``(H, W[, 3])
float32`` arrays.

``FramePrefetcher`` overlaps disk decode with device compute: a background
thread keeps batches one step ahead while the card renders the current
one (the native loader holds no GIL, so the overlap is real).
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading
from typing import Iterable, Sequence

import numpy as np

from tpuao_torch.utils import native as N

_ERR = {-1: "cannot open", -2: "bad PFM header ('Pf'/'PF' required)",
        -3: "frame size mismatch", -4: "truncated data", -5: "write failed"}


def _bind(lib):
    if getattr(lib, "_fio_bound", False):
        return lib
    lib.fio_load_pfm2.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.fio_load_pfm2.restype = ctypes.c_int
    lib.fio_save_pfm2.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.fio_save_pfm2.restype = ctypes.c_int
    lib.fio_load_pfm_batch2.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.fio_load_pfm_batch2.restype = ctypes.c_int
    lib._fio_bound = True
    return lib


def _lib():
    lib = N.get_lib()
    return _bind(lib) if lib is not None else None


# ---------------------------------------------------------------------------
# Pure-NumPy fallback codec (the executable spec for the native one)
# ---------------------------------------------------------------------------


def _load_pfm_stream(f, name: str = "<stream>") -> np.ndarray:
    def token():
        # every loop must terminate at EOF (f.read(1) == b""): b"" tests
        # as a member of ANY bytes, so a bare `c in b" \t"` spins forever
        # on a truncated header -- with loads_pfm fed raw network bodies
        # that was a remotely triggerable hang (review r3)
        t = b""
        c = f.read(1)
        while c != b"" and c in b" \t\r\n":
            c = f.read(1)
        while c == b"#":  # comment to end of line
            while c not in (b"\n", b""):
                c = f.read(1)
            c = f.read(1)
            while c != b"" and c in b" \t\r\n":
                c = f.read(1)
        while c != b"" and c not in b" \t\r\n":
            t += c
            c = f.read(1)
        return t

    magic = token()
    if magic == b"Pf":
        ch = 1
    elif magic == b"PF":
        ch = 3
    else:
        raise ValueError(f"{name}: {_ERR[-2]}")
    try:
        w, h = int(token()), int(token())
        scale = float(token())
    except ValueError:
        raise ValueError(f"{name}: {_ERR[-2]}") from None
    if w <= 0 or h <= 0 or scale == 0.0:
        raise ValueError(f"{name}: {_ERR[-2]}")
    dt = np.dtype("<f4" if scale < 0 else ">f4")
    data = np.frombuffer(f.read(4 * h * w * ch), dtype=dt)
    if data.size != h * w * ch:
        raise ValueError(f"{name}: {_ERR[-4]}")
    shape = (h, w) if ch == 1 else (h, w, 3)
    return data.reshape(shape)[::-1].astype(np.float32)  # bottom-up


def _load_pfm_py(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return _load_pfm_stream(f, path)


def loads_pfm(data: bytes) -> np.ndarray:
    """In-memory PFM bytes -> (H, W[, 3]) float32 (the serving path)."""
    import io

    return _load_pfm_stream(io.BytesIO(data))


def loads_pfm_multi(data: bytes) -> list[np.ndarray]:
    """Bytes holding one or more concatenated PFM frames -> list of
    (H, W[, 3]) float32 arrays.

    The serving multi-buffer body format: a 'Pf' depth frame optionally
    followed by 'PF' normals / color frames, each a complete PFM stream
    back-to-back (``b"".join(dumps_pfm(f) for f in frames)``).  PFM is
    self-delimiting (header declares the raster size), so no framing
    envelope is needed.  Whitespace between frames is tolerated; any
    other trailing bytes raise ``ValueError``.
    """
    import io

    f = io.BytesIO(data)
    frames: list[np.ndarray] = []
    while True:
        c = f.read(1)
        while c != b"" and c in b" \t\r\n":
            c = f.read(1)
        if c == b"":
            break
        f.seek(-1, 1)
        frames.append(_load_pfm_stream(f, f"<frame {len(frames)}>"))
    if not frames:
        raise ValueError("empty body: expected at least one PFM frame")
    return frames


def dumps_pfm(arr) -> bytes:
    """(H, W[, 3]) float array -> little-endian PFM bytes."""
    arr = np.asarray(arr, dtype=np.float32)
    if not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[-1] == 3)):
        raise ValueError(
            f"expected (H, W) or (H, W, 3) frame, got {arr.shape}")
    magic = "Pf" if arr.ndim == 2 else "PF"
    h, w = arr.shape[:2]
    return (f"{magic}\n{w} {h}\n-1.0\n".encode()
            + arr[::-1].astype("<f4").tobytes())


def _save_pfm_py(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(dumps_pfm(arr))


# ---------------------------------------------------------------------------
# Public API (native when available)
# ---------------------------------------------------------------------------


def load_pfm(path: str) -> np.ndarray:
    """One PFM -> (H, W) float32 ('Pf') or (H, W, 3) ('PF'), top-down."""
    lib = _lib()
    if lib is None:
        return _load_pfm_py(path)
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    rc = lib.fio_load_pfm2(path.encode(), None, 0, 0, 0,
                           ctypes.byref(h), ctypes.byref(w),
                           ctypes.byref(c))
    if rc != 0:
        raise ValueError(f"{path}: {_ERR.get(rc, rc)}")
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, 3)
    out = np.empty(shape, dtype=np.float32)
    rc = lib.fio_load_pfm2(path.encode(),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           h.value, w.value, c.value, None, None, None)
    if rc != 0:
        raise ValueError(f"{path}: {_ERR.get(rc, rc)}")
    return out


def save_pfm(path: str, arr) -> str:
    """(H, W) or (H, W, 3) float array -> little-endian 'Pf'/'PF' PFM."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    if not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[-1] == 3)):
        raise ValueError(
            f"expected (H, W) or (H, W, 3) frame, got {arr.shape}")
    lib = _lib()
    if lib is None:
        _save_pfm_py(path, arr)
        return path
    ch = 1 if arr.ndim == 2 else 3
    rc = lib.fio_save_pfm2(path.encode(),
                           arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           arr.shape[0], arr.shape[1], ch)
    if rc != 0:
        raise ValueError(f"{path}: {_ERR.get(rc, rc)}")
    return path


def load_pfm_batch(paths: Sequence[str], threads: int | None = None
                   ) -> np.ndarray:
    """Same-size PFMs -> contiguous (N, H, W[, 3]) float32, decoded in
    parallel.

    All frames must match the first frame's dimensions AND channel count
    (the multi-view / video contract; a mismatch raises).  The native path
    releases the GIL for the whole batch.
    """
    paths = list(paths)
    if not paths:
        return np.empty((0, 0, 0), dtype=np.float32)
    lib = _lib()
    if lib is None:
        frames = [_load_pfm_py(p) for p in paths]
        if any(f.shape != frames[0].shape for f in frames):
            raise ValueError(_ERR[-3])
        return np.stack(frames)
    first = load_pfm(paths[0])
    h, w = first.shape[:2]
    ch = 1 if first.ndim == 2 else 3
    out = np.empty((len(paths),) + first.shape, dtype=np.float32)
    out[0] = first
    if len(paths) > 1:
        rest = [p.encode() for p in paths[1:]]
        arr = (ctypes.c_char_p * len(rest))(*rest)
        err = ctypes.c_int()
        nthreads = threads or min(len(rest), os.cpu_count() or 1)
        rc = lib.fio_load_pfm_batch2(
            arr, len(rest),
            out[1:].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            h, w, ch, nthreads, ctypes.byref(err))
        if rc != 0:
            bad = paths[1:][rc - 1]
            raise ValueError(f"{bad}: {_ERR.get(err.value, err.value)}")
    return out


def _qput(q, stop, item) -> bool:
    """Bounded put that gives up when the stop event is set."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _decode_batch(paths, threads):
    """One prefetch item: a path list -> (N, H, W[, 3]) array, or a tuple
    of path lists (depth, normals[, color]) -> tuple of arrays."""
    if isinstance(paths, tuple):
        return tuple(load_pfm_batch(p, threads) for p in paths)
    return load_pfm_batch(paths, threads)


def _prefetch_worker(batches, q, stop, threads):
    # module-level on purpose: referencing the prefetcher from the thread
    # would keep it alive forever and defeat the GC finalizer
    try:
        for paths in batches:
            if stop.is_set():
                return
            if not _qput(q, stop, ("ok", _decode_batch(paths, threads))):
                return
    except Exception as e:  # surfaced on the consumer side
        _qput(q, stop, ("err", e))
        return
    _qput(q, stop, ("end", None))


def _prefetch_shutdown(stop, q):
    stop.set()
    while True:
        try:
            q.get_nowait()
        except queue.Empty:
            return


class FramePrefetcher:
    """Iterate (N, H, W) depth batches with background decode.

    ``FramePrefetcher(batches_of_paths)`` yields each batch as float32
    NumPy while the *next* batch decodes on a worker thread — the
    data-loader side of a frames-in-flight pipeline (the device side is
    the kernels' leading batch).  ``depth=2`` keeps up to two decoded
    batches buffered.

    A batch item may also be a TUPLE of path lists — e.g.
    ``(depth_paths, normal_paths, color_paths)`` with the normals/color
    stored as 3-channel 'PF' files — in which case the corresponding
    tuple of arrays is yielded (the streaming normals + composite
    pipeline).

    Also a context manager: ``close()`` (or leaving the ``with`` block)
    stops the worker and drops buffered batches, so abandoning iteration
    early does not pin decoded frames in memory for the process lifetime.
    The worker thread holds no reference to the prefetcher object, so a
    dropped prefetcher is garbage-collectable and a ``weakref.finalize``
    shuts the worker down automatically.
    """

    def __init__(self, batches: Iterable[Sequence[str]], depth: int = 2,
                 threads: int | None = None):
        import weakref

        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._done = False
        self._worker = threading.Thread(
            target=_prefetch_worker,
            args=(iter(batches), self._q, self._stop, threads), daemon=True)
        self._worker.start()
        self._finalizer = weakref.finalize(
            self, _prefetch_shutdown, self._stop, self._q)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._done:
            raise StopIteration
        kind, val = self._q.get()
        if kind == "ok":
            return val
        self._done = True
        if kind == "err":
            raise val
        raise StopIteration

    def close(self):
        """Stop the worker and release buffered batches (idempotent)."""
        self._done = True
        self._finalizer.detach()  # close IS the shutdown; don't re-run at GC
        _prefetch_shutdown(self._stop, self._q)
        self._worker.join(timeout=5.0)
        # the worker's in-flight put may have landed into the slot the
        # drain freed -- drain again so no decoded batch stays pinned
        _prefetch_shutdown(self._stop, self._q)
        try:  # wake any consumer blocked in __next__'s untimed get()
            self._q.put_nowait(("end", None))
        except queue.Full:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

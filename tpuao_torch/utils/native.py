"""Build and bind the native C++ host helpers of ``native/``.

Counterpart of ``tpuao/utils/native.py``: the PFM codec
(``native/frameio.cpp``) and the scene ray-caster (``native/raycast.cpp``)
are compiled with ``g++ -O3`` at first use -- never at import -- and loaded
with ``ctypes``.  The library goes to ``tpuao_torch/_build/`` under a name
of its own that carries a hash of the sources, so the two packages never
share a ``.so`` and an edited source is never served a stale build.  The
ABI version is checked after loading.

Every entry point has a NumPy path (``utils/frameio.py``,
``utils/fixtures.py``): without a toolchain ``get_lib()`` is None and the
callers take it.  This is host-side code of the JAX package's own design,
not a device fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent.parent
SOURCES = tuple(REPO / "native" / f for f in ("raycast.cpp", "frameio.cpp"))
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
ABI_VERSION = 3  # v3: 3-channel 'PF' codec (fio_*2 entry points)

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> pathlib.Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpuao_torch_native_{h.hexdigest()[:16]}.so"


def _build() -> pathlib.Path | None:
    """Compile unless the current build exists; None without the sources
    or a working ``g++``."""
    if not all(s.exists() for s in SOURCES):
        return None
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a temporary name and rename into place: processes that build
    # at once never see a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-pthread", "-o",
                        tmp, *map(str, SOURCES)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return lib
    except (OSError, subprocess.SubprocessError):
        pathlib.Path(tmp).unlink(missing_ok=True)
        return None


def get_lib():
    """The loaded native library, or None (the NumPy paths)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
            if lib.tpuao_native_abi_version() != ABI_VERSION:
                return None
            dp = ctypes.POINTER(ctypes.c_double)
            lib.raycast_spheres.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_double, ctypes.c_int, dp, dp, dp,
                dp]
            lib.raycast_spheres.restype = None
            _lib = lib
        except (OSError, AttributeError):  # a foreign or stale library
            _lib = None
        return _lib


def raycast_spheres_native(h, w, tan_h, tan_v, far, plane_y, centers, radii,
                           with_normals):
    """Native ray-cast of ``utils/fixtures.spheres_on_plane``'s scene;
    returns (depth[, normals]) in float64, or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    centers = np.ascontiguousarray(centers, dtype=np.float64)
    radii = np.ascontiguousarray(radii, dtype=np.float64)
    depth = np.empty((h, w), dtype=np.float64)
    normals = np.empty((h, w, 3), dtype=np.float64) if with_normals else None
    nptr = (normals.ctypes.data_as(dp) if with_normals
            else ctypes.cast(None, dp))
    lib.raycast_spheres(h, w, tan_h, tan_v, far, plane_y, len(radii),
                        centers.ctypes.data_as(dp), radii.ctypes.data_as(dp),
                        depth.ctypes.data_as(dp), nptr)
    return (depth, normals) if with_normals else depth

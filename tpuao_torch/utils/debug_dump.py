"""Debug dump of the pipeline's intermediate buffers (counterpart of
``tpuao/utils/debug_dump.py``, same files).

A ``debug_outputs`` dict (linear depth, pyramid, per-level AO, chain
steps) goes to one array per buffer: a zarr directory tree through
tensorstore where it imports, else one ``numpy.savez_compressed`` file.
Leaves are tensors on any device; each comes to the host once.
"""

from __future__ import annotations

import os

import numpy as np


def _flatten(debug: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """'/'-joined keys (integer levels as ``pyramid/0``...) -> host arrays."""
    flat: dict[str, np.ndarray] = {}
    for k, v in debug.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, prefix=f"{key}/"))
        elif v is not None:
            flat[key] = (v.detach().cpu().numpy() if hasattr(v, "detach")
                         else np.asarray(v))
    return flat


def dump_debug_buffers(debug: dict, path: str):
    """Persist a pipeline ``debug_outputs`` dict.

    ``path`` ending in ``.npz`` (or tensorstore unavailable) -> one npz
    file; otherwise a zarr directory tree with one array per buffer.
    Returns the sorted list of buffer names written.
    """
    flat = _flatten(debug)
    ts = None
    if not path.endswith(".npz"):
        try:
            import tensorstore as ts
        except ImportError:
            pass
    if ts is None:
        if not path.endswith(".npz"):
            path = path + ".npz"
        np.savez_compressed(path, **{k.replace("/", "."): v
                                     for k, v in flat.items()})
        return sorted(flat)

    os.makedirs(path, exist_ok=True)
    for name, arr in flat.items():
        spec = {
            "driver": "zarr",
            "kvstore": {"driver": "file",
                        "path": os.path.join(path, name)},
            "metadata": {"dtype": arr.dtype.str, "shape": list(arr.shape)},
            "create": True,
            "delete_existing": True,
        }
        store = ts.open(spec).result()
        store[...] = arr
    return sorted(flat)


def load_debug_buffers(path: str) -> dict[str, np.ndarray]:
    """Inverse of ``dump_debug_buffers`` (npz file or zarr tree)."""
    if path.endswith(".npz") or os.path.isfile(path):
        # the npz form rewrote '/' as '.'; restore the nested keys so both
        # forms read back to the same key set
        with np.load(path) as z:
            return {k.replace(".", "/"): z[k] for k in z.files}
    import tensorstore as ts

    out = {}
    for root, dirs, files in os.walk(path):
        if ".zarray" in files:
            rel = os.path.relpath(root, path)
            spec = {"driver": "zarr",
                    "kvstore": {"driver": "file", "path": root}}
            out[rel] = np.asarray(ts.open(spec).result())
            dirs.clear()
    return out

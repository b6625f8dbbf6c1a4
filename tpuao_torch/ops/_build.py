"""Build and load the CUDA kernels of ``tpuao_torch/csrc``.

The sources are compiled by ``nvcc`` for ``sm_90a`` -- one ``nvcc`` per
source, all started together -- and linked into one shared library with a
plain C interface, loaded with ``ctypes``: no PyTorch headers, so a build
takes seconds.  The build runs at first use (never at
import), from the package's own sources, into ``tpuao_torch/_build/``; the
library's name carries a hash of the sources and flags, so an edit is
never served a stale build.  ``--use_fast_math`` is deliberately absent:
IEEE division and ``powf`` keep the kernels within 1e-5 of their plain
versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("render.cu", "upsample.cu", "fused.cu", "windowed.cu",
           "render_dma.cu", "fused_zc.cu", "selftest.cu")
HEADERS = ("common.cuh", "chain_step.cuh", "tile.cuh")
# Each library binds its own symbols: two builds loaded in one process (an
# older tree's kernels timed beside these) share the names of their
# templates, and a static inside a template function (a launcher's record
# of its shared-memory opt-in) is otherwise one GNU-unique object for the
# whole process, so one library would skip the other's opt-in.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC,-fno-gnu-unique", "-Xptxas", "-v")
LINK_FLAGS = ("-shared", "-Xlinker", "-Bsymbolic")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# Every launching entry point returns a cudaError_t; pointers, the host pair
# table (of one level) and the stream are c_void_p, sizes c_int, tunables
# c_float (without argtypes ctypes would pass a Python float as a double).
# The two rules return texels a thread.
SIGNATURES = {
    "tpuao_render_ao_level": (
        _P, _P, _I, _I, _I, _P, _I, _F, _F, _I, _I, _P),
    "tpuao_render_ao_level_normals": (
        _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _F, _F, _F, _I, _I, _I, _P),
    "tpuao_blur_upsample_step": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _I, _I, _P),
    "tpuao_fused_render_upsample_step": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I,
        _F, _F, _F, _F, _F, _I, _I, _P),
    "tpuao_windowed_resolve": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "tpuao_render_ao_level_dma": (
        _P, _P, _I, _I, _I, _I, _P, _I, _F, _F, _I, _P),
    "tpuao_fused_render_upsample_step_zc": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I,
        _F, _F, _F, _F, _F, _I, _P),
    "tpuao_check_division": (_P, _I, _P),
    "tpuao_render_tile_rule": (_I, _I, _I, _I),
    "tpuao_chain_tile_rule": (_I, _I, _I, _I, _I),
}
# The entry points whose launches take texels a thread (``nt``, the argument
# before ``device``; utils/launch_opts.py).  An older tree's library, which
# has no ``tpuao_chain_tile_rule``, has them without it (``takes_nt``).
NT_ENTRIES = ("tpuao_render_ao_level", "tpuao_render_ao_level_normals",
              "tpuao_blur_upsample_step", "tpuao_fused_render_upsample_step")


def find_nvcc() -> str:
    """Path of ``nvcc``: PATH, then ``$CUDA_HOME/bin``, then the default
    toolkit location.  Raises if there is none."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _files(csrc: pathlib.Path) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(sources, headers) of a kernel directory: the package's own lists
    for ``CSRC``; every ``*.cu`` and ``*.cuh`` of another one (an older
    tree's kernels, built to time them beside these)."""
    if csrc == CSRC:
        return SOURCES, HEADERS
    return (tuple(sorted(p.name for p in csrc.glob("*.cu"))),
            tuple(sorted(p.name for p in csrc.glob("*.cuh"))))


def _source_hash(nvcc: str, csrc: pathlib.Path) -> str:
    h = hashlib.sha256()
    for names in _files(csrc):
        for name in names:
            h.update(name.encode())
            h.update((csrc / name).read_bytes())
    h.update(" ".join((nvcc,) + NVCC_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(csrc: pathlib.Path = CSRC) -> pathlib.Path:
    """Where the library for the sources in ``csrc`` lives (built or
    not)."""
    digest = _source_hash(find_nvcc(), pathlib.Path(csrc).resolve())
    return BUILD_DIR / f"libtpuao_kernels_{digest}.so"


def build(csrc: pathlib.Path = CSRC) -> pathlib.Path:
    """Compile the sources in ``csrc`` (the package's own by default)
    unless that build exists; returns the library path.  Each source
    compiles to an object in its own ``nvcc`` process, all at once, then
    one ``nvcc -shared`` links them.  The compilers' output (with
    ``-Xptxas -v``: registers, shared memory and spills per kernel) is
    kept beside the library as ``.log``."""
    csrc = pathlib.Path(csrc).resolve()
    nvcc = find_nvcc()
    lib = library_path(csrc)
    if lib.exists():
        return lib
    sources = _files(csrc)[0]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(csrc / s)]
                for s, o in zip(sources, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        link = [nvcc, *NVCC_FLAGS[:2], *LINK_FLAGS, "-o",
                os.path.join(tmp, "lib.so"), *objs]
        log = "".join(" ".join(c) + "\n" + out
                      for c, out in zip(cmds, outs))
        failed = [c for c, p in zip(cmds, procs) if p.returncode != 0]
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            log += " ".join(link) + "\n" + proc.stdout + proc.stderr
            if proc.returncode != 0:
                failed = [link]
        lib.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed ({' '.join(failed[0])}):\n{log}")
        os.replace(os.path.join(tmp, "lib.so"), lib)
    return lib


@functools.lru_cache(maxsize=None)
def load(csrc: pathlib.Path = CSRC) -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's types (an
    older tree's library may lack the newer entry points, and its launches
    may take no ``nt``: ``lib.takes_nt``)."""
    lib = ctypes.CDLL(str(build(csrc)))
    own = pathlib.Path(csrc).resolve() == CSRC
    lib.takes_nt = own or hasattr(lib, "tpuao_chain_tile_rule")
    for name, argtypes in SIGNATURES.items():
        if not own and not hasattr(lib, name):
            continue
        if name in NT_ENTRIES and not lib.takes_nt:
            argtypes = argtypes[:-3] + argtypes[-2:]
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.tpuao_error_string.argtypes = [ctypes.c_int]
    lib.tpuao_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.tpuao_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

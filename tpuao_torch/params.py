"""Parameters, camera and host-side constants of the PyTorch port.

Counterpart of ``tpuao/params.py``.  That module imports ``flax`` (and so
``jax``) at import time, so this package carries its own NumPy-level copies
of the pair table, the parameter ranges and the per-level constants; the
tests hold every copy equal to ``tpuao.params``.

``AOParams`` and ``CameraParams`` are frozen dataclasses with the fields,
defaults, ``validate()`` and ``replace()`` of the JAX package's flax
structs.  Tunables are plain Python floats: they reach the CUDA kernels as
runtime arguments, so changing one never rebuilds anything.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np

# ---------------------------------------------------------------------------
# Sample disc pattern
# ---------------------------------------------------------------------------
# 12 disc entries on the integer grid inside a radius-5 (slice texel)
# sphere: 4 axial, 3 diagonal, 5 L-shaped.  Thickness T[i] is the
# half-chord height of the unit sphere at that lateral offset; multiplicity
# is 4 for axial/diagonal entries and 8 for L-shaped ones.
SAMPLE_OFFSETS: tuple[tuple[int, int], ...] = (
    (1, 0), (2, 0), (3, 0), (4, 0),          # axial
    (1, 1), (2, 2), (3, 3),                  # diagonal
    (1, 2), (1, 3), (1, 4), (2, 3), (2, 4),  # L-shaped
)

N_ENTRIES = len(SAMPLE_OFFSETS)

SAMPLE_THICKNESS: np.ndarray = np.array(
    [math.sqrt(1.0 - (x * x + y * y) / 25.0) for (x, y) in SAMPLE_OFFSETS],
    dtype=np.float64,
)

TAP_MULTIPLICITY: np.ndarray = np.array(
    [4 if (y == 0 or x == y) else 8 for (x, y) in SAMPLE_OFFSETS],
    dtype=np.float64,
)

# Entries kept when ``AOParams.exhaustive`` is False: the even-coordinate
# entries (2,0), (4,0), (2,2), (2,4).
SPARSE_ENTRY_INDICES: tuple[int, ...] = (1, 3, 5, 11)


def entry_pairs(entry_index: int) -> list[tuple[int, int]]:
    """Mirror-pair representatives for one disc entry, in slice texels.

    Each returned offset ``o`` stands for the tap pair ``{+o, -o}``.
    """
    x, y = SAMPLE_OFFSETS[entry_index]
    if y == 0:
        return [(x, 0), (0, x)]
    if x == y:
        return [(x, x), (x, -x)]
    return [(x, y), (y, -x), (y, x), (x, -y)]


def build_pair_table(exhaustive: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """``(offsets[N,2] int32, weights[N] float32)`` of the AO estimator.

    Offsets are in slice texels (x4 gives level texels); weights sum to 1.
    An entry's weight ``multiplicity * thickness`` is normalised over the
    active entries and split evenly among its pairs.
    """
    active = range(N_ENTRIES) if exhaustive else SPARSE_ENTRY_INDICES
    entry_w = {i: TAP_MULTIPLICITY[i] * SAMPLE_THICKNESS[i] for i in active}
    total = sum(entry_w.values())
    offsets: list[tuple[int, int]] = []
    weights: list[float] = []
    for i in active:
        pairs = entry_pairs(i)
        w_pair = entry_w[i] / total / len(pairs)
        for o in pairs:
            offsets.append(o)
            weights.append(w_pair)
    return (
        np.array(offsets, dtype=np.int32),
        np.array(weights, dtype=np.float32),
    )


# ---------------------------------------------------------------------------
# Tunables
# ---------------------------------------------------------------------------

PARAM_RANGES: dict[str, tuple[float, float]] = {
    "noise_filter_tolerance": (-8.0, 0.0),
    "blur_tolerance": (-8.0, -1.0),
    "upsample_tolerance": (-12.0, -1.0),
    "rejection_falloff": (1.0, 10.0),
    "strength": (0.1, 10.0),
}

# Temporal accumulation: history_weight < 1 keeps the accumulator a strict
# contraction; depth_tolerance > 0 keeps the confidence well defined.
TEMPORAL_PARAM_RANGES: dict[str, tuple[float, float]] = {
    "history_weight": (0.0, 0.98),
    "depth_tolerance": (0.005, 1.0),
}


def _is_number(v) -> bool:
    return isinstance(v, (int, float, np.floating, np.integer))


@dataclasses.dataclass(frozen=True)
class AOParams:
    """AO tunables (float fields) and frame structure (the rest)."""

    noise_filter_tolerance: float = -3.0
    blur_tolerance: float = -5.0
    upsample_tolerance: float = -7.0
    rejection_falloff: float = 2.5
    strength: float = 1.0
    hierarchy_depth: int = 4
    exhaustive: bool = True
    enable_blur: bool = True
    use_normals: bool = False
    # Screen-space sphere diameter in slice texels.
    screenspace_diameter: float = 10.0

    def validate(self) -> "AOParams":
        for name, (lo, hi) in PARAM_RANGES.items():
            v = getattr(self, name)
            if _is_number(v) and not (lo <= float(v) <= hi):
                raise ValueError(
                    f"AOParams.{name}={v} outside range [{lo}, {hi}]")
        if not 1 <= self.hierarchy_depth <= 4:
            raise ValueError(
                f"hierarchy_depth must be in [1,4], got {self.hierarchy_depth}")
        return self

    def replace(self, **changes) -> "AOParams":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class TemporalParams:
    """Temporal-accumulation tunables (``ops/temporal.py``).

    * ``history_weight``: largest share of history kept per frame;
    * ``depth_tolerance``: relative reprojected-depth mismatch at which
      history confidence reaches 0;
    * ``neighborhood_clamp``: clamp history to the 3x3 min/max of the
      current AO (anti-ghosting);
    * ``max_displacement``: drop history that reprojects more than this
      many pixels away (the windowed resolve's radius); ``None`` samples
      unbounded motion with a plain gather.
    """

    history_weight: float = 0.9
    depth_tolerance: float = 0.1
    neighborhood_clamp: bool = True
    max_displacement: int | None = 4

    def validate(self) -> "TemporalParams":
        for name, (lo, hi) in TEMPORAL_PARAM_RANGES.items():
            v = getattr(self, name)
            if _is_number(v) and not (lo <= float(v) <= hi):
                raise ValueError(f"TemporalParams.{name}={v} outside range "
                                 f"[{lo}, {hi}]")
        r = self.max_displacement
        if r is not None and not (isinstance(r, int) and 1 <= r <= 64):
            raise ValueError(
                f"TemporalParams.max_displacement={r!r} must be None or an "
                "int in [1, 64] (window taps grow as (2R+2)^2)")
        return self

    def replace(self, **changes) -> "TemporalParams":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Camera projection description.

    ``depth_mode``: ``"hardware"`` takes a hardware depth buffer in [0, 1],
    linearised as ``1/(zmagic*d + 1)`` with ``zmagic = (far-near)/near``;
    ``"linear"`` takes normalised linear eye depth ``z_eye/far`` in (0, 1].
    """

    near: float = 0.1
    far: float = 100.0
    tan_half_fov_h: float = math.tan(math.radians(60.0) / 2)
    reversed_z: bool = True
    depth_mode: str = "hardware"

    def validate(self) -> "CameraParams":
        if _is_number(self.near) and not self.near > 0:
            raise ValueError(f"CameraParams.near={self.near} must be > 0")
        if (_is_number(self.near) and _is_number(self.far)
                and not self.far > self.near):
            raise ValueError(
                f"CameraParams.far={self.far} must exceed near={self.near}")
        if _is_number(self.tan_half_fov_h) and not (
                0 < self.tan_half_fov_h < np.inf):
            raise ValueError(
                f"CameraParams.tan_half_fov_h={self.tan_half_fov_h} must be "
                "finite and > 0 (fov in (0, 180) degrees)")
        if self.depth_mode not in ("hardware", "linear"):
            raise ValueError(
                f"CameraParams.depth_mode={self.depth_mode!r} must be "
                "'hardware' or 'linear'")
        return self

    def replace(self, **changes) -> "CameraParams":
        return dataclasses.replace(self, **changes)

    @classmethod
    def from_projection(cls, proj, convention: str = "unity"
                        ) -> "CameraParams":
        """Camera from a 4x4 projection matrix (column vectors,
        ``clip = P @ view``), as ``tpuao``'s ``CameraParams.from_projection``.

        ``convention="unity"``: D3D-style clip space, buffer depth =
        clip.z/clip.w in [0, 1], reversed-Z or forward-Z (detected from the
        matrix); ``"gl"``: OpenGL clip space, NDC z in [-1, 1] mapped to
        0.5*ndc + 0.5, forward-Z.  Both view-space handednesses (the sign
        of ``P[3,2]``) and a transposed matrix are accepted; the
        orientation with a unit perspective-divide entry ``|P[3,2]| == 1``
        is taken first.  The result is cross-validated against the
        linearizer ``1/(zmagic*d + 1)`` on sampled eye depths, so a depth
        map the pipeline cannot represent (infinite far, oblique near
        clip) raises instead of rendering wrong AO.
        """
        p = np.asarray(proj, dtype=np.float64)
        if p.size != 16:
            raise ValueError(
                f"projection must be 4x4 (16 values), got {p.shape}")
        p = p.reshape(4, 4)
        if convention not in ("unity", "gl"):
            raise ValueError(
                f"convention={convention!r} must be 'unity' or 'gl'")
        cand = [p, p.T]
        unit = [abs(abs(m[3, 2]) - 1.0) < 1e-9 for m in cand]
        if unit[0] != unit[1]:
            cand = [cand[0] if unit[0] else cand[1]]
        try:
            return cls._from_projection_oriented(cand[0], convention)
        except ValueError as first:
            if len(cand) == 1:
                raise
            try:
                return cls._from_projection_oriented(cand[1], convention)
            except ValueError:
                raise first from None

    @classmethod
    def _from_projection_oriented(cls, p, convention: str) -> "CameraParams":
        if abs(p[3, 2]) < 1e-12:
            raise ValueError(
                "not a perspective projection: P[3,2] == 0 (no 1/z divide); "
                "orthographic cameras have no AO depth scale")
        if p[0, 0] <= 0:
            raise ValueError(f"P[0,0]={p[0, 0]} must be > 0 (cot of half "
                             "the horizontal fov)")
        tanh = 1.0 / p[0, 0]
        a, b = p[2, 2], p[2, 3]
        c, e = p[3, 2], p[3, 3]
        # view-space z of a point at eye distance ze: -ze right-handed
        # (w row negative), +ze left-handed (w row positive)
        zsign = -1.0 if c < 0 else 1.0

        def ndc(d):  # buffer depth -> clip-space z/w
            return 2.0 * d - 1.0 if convention == "gl" else d

        def ze_of(d):  # exact preimage of buffer depth d
            nd = ndc(d)
            den = zsign * (a - nd * c)
            if abs(den) < 1e-300:
                return math.inf
            return (nd * e - b) / den

        z_at_0, z_at_1 = ze_of(0.0), ze_of(1.0)
        if not (math.isfinite(z_at_0) and math.isfinite(z_at_1)):
            raise ValueError(
                "projection has an infinite clip plane (e.g. infinite-far "
                "reversed-Z); the AO linearizer needs finite near/far -- "
                "rebuild the matrix with a finite far")
        reversed_z = bool(z_at_1 < z_at_0)
        near, far = sorted((float(z_at_0), float(z_at_1)))
        cam = cls(near=near, far=far, tan_half_fov_h=float(tanh),
                  reversed_z=reversed_z, depth_mode="hardware").validate()
        # the matrix's own depth map through the linearizer must give back
        # z_eye/far, monotonically
        zmagic = (far - near) / near
        zs = np.linspace(near, far, 33)
        d = (a * (zsign * zs) + b) / (c * (zsign * zs) + e)
        d_buf = 0.5 * d + 0.5 if convention == "gl" else d
        d_lin = d_buf if reversed_z else 1.0 - d_buf
        recon = 1.0 / (zmagic * d_lin + 1.0)
        err = np.abs(recon - zs / far).max()
        if err > 1e-9 * (1.0 + far / near):
            raise ValueError(
                "projection depth map is not the standard perspective form "
                f"the AO linearizer assumes (max dev {err:.3e}); "
                "oblique/sheared depth rows are not supported")
        mono = np.diff(d_buf)
        if not (np.all(mono < 0) if reversed_z else np.all(mono > 0)):
            raise ValueError("projection depth map is not monotonic over "
                             "[near, far]")
        return cam


# ---------------------------------------------------------------------------
# Config persistence
# ---------------------------------------------------------------------------


def params_to_dict(params) -> dict:
    """AOParams/CameraParams/TemporalParams -> plain-value dict
    (JSON-ready)."""
    out = {}
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        out[f.name] = (v if v is None or isinstance(v, (bool, int, str))
                       else float(v))
    return out


def params_from_dict(cls, d: dict):
    """Inverse of ``params_to_dict``; validates on load."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    return cls(**d).validate()


def save_config(path: str, params, camera) -> str:
    """Write the ``{"ao": ..., "camera": ...}`` JSON config that
    ``load_config`` (and ``tpuao.params.load_config``) reads; returns
    ``path``."""
    with open(path, "w") as f:
        json.dump({"ao": params_to_dict(params),
                   "camera": params_to_dict(camera)}, f, indent=2)
    return path


def load_config(path: str) -> tuple[AOParams, CameraParams]:
    """Read an ``{"ao": ..., "camera": ...}`` JSON config, validated."""
    with open(path) as f:
        d = json.load(f)
    return (params_from_dict(AOParams, d["ao"]),
            params_from_dict(CameraParams, d["camera"]))


def from_tpuao(ao_dict: dict, camera_dict: dict, temporal_dict=None):
    """Build the port's parameters from the JAX package's state.

    Takes the fields of a JAX ``AOParams`` and ``CameraParams`` as plain
    floats, bools and strings (what ``tpuao.params.params_to_dict``
    returns) and returns ``(AOParams, CameraParams)``; with
    ``temporal_dict``, the fields of a ``TemporalParams``, it returns
    ``(AOParams, CameraParams, TemporalParams)``.  The tunables, the camera
    and the temporal tunables are all the state this system carries.
    """
    out = (params_from_dict(AOParams, dict(ao_dict)),
           params_from_dict(CameraParams, dict(camera_dict)))
    if temporal_dict is None:
        return out
    return out + (params_from_dict(TemporalParams, dict(temporal_dict)),)


# ---------------------------------------------------------------------------
# Derived per-level constants
# ---------------------------------------------------------------------------


def sphere_radius_coef(level: int, full_width: int, tan_half_fov_h,
                       screenspace_diameter: float = 10.0):
    """World-space occlusion-sphere radius per unit linear depth at `level`:
    ``4 * diameter * tanH * 2^level / full_width``."""
    w_l = full_width // (1 << level)
    return 4.0 * screenspace_diameter * tan_half_fov_h / w_l


def upsample_constants(params, full_width: int, lo_width: int):
    """``(step_size, k_blur, k_up, nfs)`` of one blur+upsample step.

    step_size = full_width / lo_width; k_blur = (1 - 10^blur_tol *
    step_size)^2 + 1e-30; k_up = 10^upsample_tol; nfs = 1 /
    (10^noise_filter_tol + k_up).  The 1e-30 keeps k_blur off exact 0
    (reachable in range), where corner-aligned taps with dd == 0 would
    give 0/0 and a NaN frame.
    """
    step_size = full_width / lo_width
    k_blur = 1.0 - 10.0 ** params.blur_tolerance * step_size
    k_blur = k_blur * k_blur + 1e-30
    k_up = 10.0 ** params.upsample_tolerance
    nfs = 1.0 / (10.0 ** params.noise_filter_tolerance + k_up)
    return step_size, k_blur, k_up, nfs


# ---------------------------------------------------------------------------
# Padding rule
# ---------------------------------------------------------------------------

PAD_MULTIPLE = 64  # frames are edge-padded to a multiple of 64 and cropped


def padded_shape(h: int, w: int, multiple: int = PAD_MULTIPLE) -> tuple[int, int]:
    def r(v):
        return (v + multiple - 1) // multiple * multiple

    return r(h), r(w)

"""Parameters of the plain reference, worked out from a configuration file.

A frozen copy of the spec's constants (the 12-entry sample disc, its pair
table, the per-level radius and upsample constants, the pad-to-64 rule) so
that the reference reads nothing of the program it judges.  ``AO`` and
``Camera`` carry the fields of a configuration's ``ao`` and ``camera``
groups under the program's names.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

SAMPLE_OFFSETS = (
    (1, 0), (2, 0), (3, 0), (4, 0),          # axial
    (1, 1), (2, 2), (3, 3),                  # diagonal
    (1, 2), (1, 3), (1, 4), (2, 3), (2, 4),  # L-shaped
)
N_ENTRIES = len(SAMPLE_OFFSETS)
SAMPLE_THICKNESS = np.array(
    [math.sqrt(1.0 - (x * x + y * y) / 25.0) for (x, y) in SAMPLE_OFFSETS],
    dtype=np.float64)
TAP_MULTIPLICITY = np.array(
    [4 if (y == 0 or x == y) else 8 for (x, y) in SAMPLE_OFFSETS],
    dtype=np.float64)
# the even-coordinate entries (2,0), (4,0), (2,2), (2,4) of the sparse disc
SPARSE_ENTRY_INDICES = (1, 3, 5, 11)
PAD_MULTIPLE = 64


@dataclasses.dataclass(frozen=True)
class AO:
    noise_filter_tolerance: float = -3.0
    blur_tolerance: float = -5.0
    upsample_tolerance: float = -7.0
    rejection_falloff: float = 2.5
    strength: float = 1.0
    hierarchy_depth: int = 4
    exhaustive: bool = True
    enable_blur: bool = True
    use_normals: bool = False
    screenspace_diameter: float = 10.0


@dataclasses.dataclass(frozen=True)
class Camera:
    near: float = 0.1
    far: float = 100.0
    tan_half_fov_h: float = math.tan(math.radians(60.0) / 2)
    reversed_z: bool = True
    depth_mode: str = "hardware"


def from_config(cfg: dict) -> tuple[AO, Camera]:
    """``(AO, Camera)`` of a configuration file's ``ao`` and ``camera``
    groups; the camera's field of view is given in degrees."""
    cam = dict(cfg["camera"])
    fov = cam.pop("fov_h_deg")
    cam["tan_half_fov_h"] = math.tan(math.radians(fov) / 2)
    return AO(**cfg["ao"]), Camera(**cam)


def entry_pairs(entry_index: int) -> list[tuple[int, int]]:
    """Mirror-pair representatives of one disc entry, in slice texels."""
    x, y = SAMPLE_OFFSETS[entry_index]
    if y == 0:
        return [(x, 0), (0, x)]
    if x == y:
        return [(x, x), (x, -x)]
    return [(x, y), (y, -x), (y, x), (x, -y)]


def build_pair_table(exhaustive: bool = True):
    """``(offsets[N,2] int32, weights[N] float32)``: each entry's weight
    ``multiplicity * thickness``, normalised over the active entries and
    split evenly among its pairs."""
    active = range(N_ENTRIES) if exhaustive else SPARSE_ENTRY_INDICES
    entry_w = {i: TAP_MULTIPLICITY[i] * SAMPLE_THICKNESS[i] for i in active}
    total = sum(entry_w.values())
    offsets, weights = [], []
    for i in active:
        pairs = entry_pairs(i)
        w_pair = entry_w[i] / total / len(pairs)
        for o in pairs:
            offsets.append(o)
            weights.append(w_pair)
    return np.array(offsets, dtype=np.int32), np.array(weights,
                                                       dtype=np.float32)


def sphere_radius_coef(level: int, full_width: int, tan_half_fov_h,
                       screenspace_diameter: float = 10.0):
    """``4 * diameter * tanH / (full_width >> level)``."""
    w_l = full_width // (1 << level)
    return 4.0 * screenspace_diameter * tan_half_fov_h / w_l


def upsample_constants(params: AO, full_width: int, lo_width: int):
    """``(step_size, k_blur, k_up, nfs)`` of one blur+upsample step."""
    step_size = full_width / lo_width
    k_blur = 1.0 - 10.0 ** params.blur_tolerance * step_size
    k_blur = k_blur * k_blur + 1e-30
    k_up = 10.0 ** params.upsample_tolerance
    nfs = 1.0 / (10.0 ** params.noise_filter_tolerance + k_up)
    return step_size, k_blur, k_up, nfs


def padded_shape(h: int, w: int, multiple: int = PAD_MULTIPLE):
    def r(v):
        return (v + multiple - 1) // multiple * multiple

    return r(h), r(w)


@dataclasses.dataclass(frozen=True)
class Temporal:
    """The tunables of the temporal resolve, under the program's names,
    and the level it resolves at (0 full resolution, 1 the level-1
    field before the last upsample)."""

    history_weight: float = 0.9
    depth_tolerance: float = 0.1
    neighborhood_clamp: bool = True
    max_displacement: int | None = 4
    resolve_level: int = 0


def temporal_from_config(cfg: dict) -> Temporal:
    """``Temporal`` of a configuration file's ``temporal`` group; raises
    where the file has none."""
    if "temporal" not in cfg:
        raise ValueError(f"configuration {cfg.get('name')!r} has no "
                         "temporal group")
    return Temporal(**cfg["temporal"])

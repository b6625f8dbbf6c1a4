"""Synthetic depth scenes (counterpart of ``tpuao/utils/fixtures.py``).

Spheres on a ground plane, ray-cast analytically, plus degenerate scenes
(flat plane, step edge, corner) with hand-derivable AO.  Depth is
normalised linear eye depth ``z_eye/far``; ``to_hardware_depth`` converts
it to a hardware depth buffer for the linearise stage.  Randomness is
``np.random.default_rng(seed)``, so a seed gives the same scene as the JAX
package's fixtures.
"""

from __future__ import annotations

import numpy as np

from tpuao_torch.params import CameraParams


def to_hardware_depth(linear01: np.ndarray, camera: CameraParams) -> np.ndarray:
    """Invert LinearZ: z/far -> hardware depth d with
    ``1/(zmagic*d+1) == linear01`` (reversed-Z unless ``camera`` says not)."""
    zmagic = (camera.far - camera.near) / camera.near
    d = (1.0 / np.clip(linear01, 1e-9, None) - 1.0) / zmagic
    d = np.clip(d, 0.0, 1.0)
    return d if camera.reversed_z else 1.0 - d


def flat_plane(h: int, w: int, z01: float = 0.3) -> np.ndarray:
    """Constant-depth wall facing the camera: AO must be exactly 1."""
    return np.full((h, w), z01, dtype=np.float64)


def step_edge(h: int, w: int, z_near: float = 0.2, z_far: float = 0.6,
              axis: int = 1) -> np.ndarray:
    """Foreground half-plane over background: a depth discontinuity."""
    z = np.full((h, w), z_far, dtype=np.float64)
    if axis == 1:
        z[:, : w // 2] = z_near
    else:
        z[: h // 2, :] = z_near
    return z


def corner(h: int, w: int, z_base: float = 0.5, slope: float = 0.001) -> np.ndarray:
    """Concave V-groove, deepest at the centre column."""
    c = np.abs(np.arange(w) - w / 2.0)
    z = np.clip(z_base - slope * c, 0.05, 1.0)
    return np.broadcast_to(z, (h, w)).astype(np.float64).copy()


def sphere_scene_params(n_spheres: int, seed: int, plane_y: float = 1.5):
    """Random sphere (centers, radii) resting on the ground plane."""
    rng = np.random.default_rng(seed)
    centers, radii = [], []
    for _ in range(n_spheres):
        r = rng.uniform(0.3, 0.9)
        cx = rng.uniform(-3.0, 3.0)
        cz = rng.uniform(4.0, 14.0)
        centers.append((cx, plane_y - r, cz))
        radii.append(r)
    return np.array(centers, np.float64).reshape(-1, 3), np.array(radii)


def spheres_on_plane(h: int, w: int, camera: CameraParams | None = None,
                     n_spheres: int = 5, seed: int = 0,
                     with_normals: bool = False, eye=None,
                     backend: str = "auto"):
    """Analytic ray-cast of random spheres resting on a ground plane.

    Camera at the origin looking down +z; the ground plane is y = +1.5
    (buffer y points down).  Returns depth (H, W) [and normals (H, W, 3)
    in buffer view space: x = +column, y = +row, z = toward the camera].
    ``eye`` moves the camera by a translation.

    ``backend``: ``"auto"`` (as in the JAX package) takes the C++
    ray-caster of ``native/raycast.cpp`` (``utils/native.py``) when it
    builds, else NumPy; ``"native"`` and ``"numpy"`` force a path.  The two
    give the same bits; the native one is faster and needs no full-frame
    temporaries.
    """
    if backend not in ("numpy", "native", "auto"):
        raise ValueError(f"backend={backend!r}: numpy, native or auto")
    camera = camera or CameraParams()
    tanh = float(camera.tan_half_fov_h)
    tanv = tanh * h / w
    far = float(camera.far)
    plane_y = 1.5
    centers_arr, radii_arr = sphere_scene_params(n_spheres, seed, plane_y)
    if eye is not None:
        ex, ey, ez = (float(v) for v in np.asarray(eye, np.float64))
        centers_arr = centers_arr - np.asarray([ex, ey, ez])
        plane_y = plane_y - ey

    if backend != "numpy":
        from tpuao_torch.utils.native import raycast_spheres_native

        res = raycast_spheres_native(h, w, tanh, tanv, far, plane_y,
                                     centers_arr, radii_arr, with_normals)
        if res is not None:
            return res
        if backend == "native":
            raise RuntimeError("native ray-caster unavailable (no g++?)")

    # Ray directions per pixel, unit z component: dir = (u, v, 1).
    u = (np.arange(w) + 0.5) / w * 2.0 - 1.0
    v = (np.arange(h) + 0.5) / h * 2.0 - 1.0
    U, V = np.meshgrid(u * tanh, v * tanv)

    denom = np.where(np.abs(V) < 1e-6, 1e-6, V)
    t_plane = plane_y / denom
    t_plane = np.where(t_plane > 0, t_plane, np.inf)

    t_best = t_plane
    hit_id = np.where(np.isfinite(t_plane), -1, -2)  # -1 plane, -2 sky

    centers = [tuple(c) for c in centers_arr]
    radii = list(radii_arr)
    for i, ((cx, cy, cz), r) in enumerate(zip(centers, radii)):
        a = U * U + V * V + 1.0
        b = -2.0 * (U * cx + V * cy + cz)
        c0 = cx * cx + cy * cy + cz * cz - r * r
        disc = b * b - 4 * a * c0
        t = np.where(
            disc >= 0, (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a), np.inf
        )
        t = np.where(t > 0, t, np.inf)
        closer = t < t_best
        t_best = np.where(closer, t, t_best)
        hit_id = np.where(closer, i, hit_id)

    z_eye = np.where(np.isfinite(t_best), t_best, far)
    z01 = np.clip(z_eye / far, 1e-4, 1.0)

    if not with_normals:
        return z01

    nx = np.zeros((h, w))
    ny = np.zeros((h, w))
    nz = np.ones((h, w))
    pm = hit_id == -1
    nx[pm], ny[pm], nz[pm] = 0.0, -1.0, 0.0
    for i, ((cx, cy, cz), r) in enumerate(zip(centers, radii)):
        m = hit_id == i
        if not m.any():
            continue
        px = U[m] * t_best[m]
        py = V[m] * t_best[m]
        pz = t_best[m]
        gx, gy, gz = (px - cx) / r, (py - cy) / r, (pz - cz) / r
        nx[m], ny[m], nz[m] = gx, gy, -gz
    nz = np.maximum(nz, 1e-3)
    norm = np.sqrt(nx * nx + ny * ny + nz * nz)
    normals = np.stack([nx / norm, ny / norm, nz / norm], axis=-1)
    return z01, normals

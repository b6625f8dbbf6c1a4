"""Input frames, made on the device from the seed.

A dolly through a scene of spheres resting on a ground plane, ray-cast
analytically (the scene of ``tpuao_torch/utils/fixtures.py``, written here
in torch so that a 4K pool is made on the card in a few calls): the camera
sits at the origin looking down +z, the plane is y = +1.5 (buffer y points
down), and frame f moves the camera ``f * dolly_step`` forward.  The
seed draws the spheres; every seed gives frames of the same size, so the
seed changes what is drawn and never how much work a frame is.
"""

from __future__ import annotations

import math

import torch

PLANE_Y = 1.5


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def sphere_scene(n_spheres: int, seed: int, device):
    """``(centers (n, 3), radii (n,))`` float32 on ``device``: radius in
    [0.3, 0.9], x in [-3, 3], z in [4, 14], each resting on the plane."""
    u = torch.rand((n_spheres, 3), generator=_generator(seed, device),
                   device=device, dtype=torch.float32)
    r = 0.3 + 0.6 * u[:, 0]
    centers = torch.stack([-3.0 + 6.0 * u[:, 1], PLANE_Y - r,
                           4.0 + 10.0 * u[:, 2]], dim=1)
    return centers, r


def raycast(h: int, w: int, camera: dict, centers, radii, eye_z: float,
            with_normals: bool):
    """z_eye/far (H, W) of the scene seen from (0, 0, eye_z) [and unit
    normals (H, W, 3) in buffer view space], float32."""
    dev = centers.device
    tanh = math.tan(math.radians(camera["fov_h_deg"]) / 2)
    tanv = tanh * h / w
    far = float(camera["far"])
    u = ((torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w
         * 2.0 - 1.0) * tanh
    v = ((torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h
         * 2.0 - 1.0) * tanv
    V, U = torch.meshgrid(v, u, indexing="ij")
    c = centers - torch.tensor([0.0, 0.0, eye_z], device=dev)
    denom = torch.where(V.abs() < 1e-6, torch.full_like(V, 1e-6), V)
    t_best = PLANE_Y / denom
    t_best = torch.where(t_best > 0, t_best, torch.full_like(V, math.inf))
    hit = torch.where(torch.isfinite(t_best), -1, -2)  # -1 plane, -2 sky
    a = U * U + V * V + 1.0
    for i in range(c.shape[0]):
        cx, cy, cz, r = c[i, 0], c[i, 1], c[i, 2], radii[i]
        b = -2.0 * (U * cx + V * cy + cz)
        c0 = cx * cx + cy * cy + cz * cz - r * r
        disc = b * b - 4.0 * a * c0
        t = torch.where(disc >= 0,
                        (-b - torch.sqrt(disc.clamp(min=0.0))) / (2.0 * a),
                        torch.full_like(a, math.inf))
        t = torch.where(t > 0, t, torch.full_like(t, math.inf))
        closer = t < t_best
        t_best = torch.where(closer, t, t_best)
        hit = torch.where(closer, i, hit)
    z_eye = torch.where(torch.isfinite(t_best), t_best,
                        torch.full_like(t_best, far))
    z01 = (z_eye / far).clamp(1e-4, 1.0)
    if not with_normals:
        return z01, None
    nx, ny, nz = (torch.zeros_like(z01), torch.zeros_like(z01),
                  torch.ones_like(z01))
    plane = hit == -1
    nx = torch.where(plane, 0.0, nx)
    ny = torch.where(plane, -1.0, ny)
    nz = torch.where(plane, 0.0, nz)
    for i in range(c.shape[0]):
        m = hit == i
        px, py, pz = U * t_best, V * t_best, t_best
        nx = torch.where(m, (px - c[i, 0]) / radii[i], nx)
        ny = torch.where(m, (py - c[i, 1]) / radii[i], ny)
        nz = torch.where(m, -(pz - c[i, 2]) / radii[i], nz)
    nz = nz.clamp(min=1e-3)
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    return z01, torch.stack([nx / norm, ny / norm, nz / norm], dim=-1)


def to_hardware_depth(z01: torch.Tensor, camera: dict) -> torch.Tensor:
    """Invert the linearisation: z/far -> hardware depth d with
    ``1 / (zmagic d + 1) == z01`` (reversed-Z unless the camera says
    not)."""
    zmagic = (camera["far"] - camera["near"]) / camera["near"]
    d = ((1.0 / z01.clamp(min=1e-9) - 1.0) / zmagic).clamp(0.0, 1.0)
    return d if camera["reversed_z"] else 1.0 - d


def dolly_view(frame: int, dolly_step: float) -> list[list[float]]:
    """The (4, 4) world->eye matrix of dolly frame ``frame``, row-major:
    the camera sits at (0, 0, ``frame * dolly_step``) and does not turn."""
    return [[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0],
            [0.0, 0.0, 1.0, -frame * dolly_step], [0.0, 0.0, 0.0, 1.0]]


def dolly_motion(dolly_step: float) -> list[list[float]]:
    """The (4, 4) current->previous eye transform of one dolly step
    (``view_prev @ inv(view_curr)``): the previous camera stood
    ``dolly_step`` behind, so a point lies that much farther from it.  A
    move along z alone, so it reads the same whether eye y points up (the
    temporal spec) or down (``raycast``)."""
    return [[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0],
            [0.0, 0.0, 1.0, float(dolly_step)], [0.0, 0.0, 0.0, 1.0]]


def dolly_pool(h: int, w: int, n_frames: int, seed: int, camera: dict,
               device, n_spheres: int = 8, dolly_step: float = 0.05,
               with_normals: bool = False):
    """``(depth (F, H, W), normals (F, H, W, 3) or None)``, float32 on
    ``device``: F frames of a dolly, in the camera's depth mode."""
    centers, radii = sphere_scene(n_spheres, seed, device)
    depth = torch.empty((n_frames, h, w), dtype=torch.float32, device=device)
    normals = (torch.empty((n_frames, h, w, 3), dtype=torch.float32,
                           device=device) if with_normals else None)
    for f in range(n_frames):
        z01, nrm = raycast(h, w, camera, centers, radii, f * dolly_step,
                           with_normals)
        depth[f] = (to_hardware_depth(z01, camera)
                    if camera["depth_mode"] == "hardware" else z01)
        if with_normals:
            normals[f] = nrm
    return depth, normals

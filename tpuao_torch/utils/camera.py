"""Projection matrix <-> ``CameraParams``, and view-matrix motion.

Counterpart of ``tpuao/utils/camera.py`` (NumPy only).  Convention:
row-major 4x4 ``P``, clip = P @ [x, y, z_eye, 1] with the camera looking
down +z (left-handed eye space) and D3D clip depth in [0, 1] after the
w-divide (w = z_eye)::

    P = [[1/tanHalfFovH, 0,             0, 0],
         [0,             1/tanHalfFovV, 0, 0],
         [0,             0,             A, B],
         [0,             0,             1, 0]]

    hardware_depth(z) = A + B / z

* reversed-Z (depth 1 at near, 0 at far): ``A = -n/(f-n), B = n*f/(f-n)``;
  linearising gives exactly ``LinearZ(d) = 1/(zmagic*d + 1)`` with
  ``zmagic = (f-n)/n`` (``ops/prepare.py::linearize_depth``);
* standard-Z (0 at near, 1 at far): ``A = f/(f-n), B = -n*f/(f-n)``.
"""

from __future__ import annotations

import numpy as np

from tpuao_torch.params import CameraParams


def perspective_projection(near: float, far: float, tan_half_fov_h: float,
                           aspect: float = 16.0 / 9.0,
                           reversed_z: bool = True) -> np.ndarray:
    """The 4x4 perspective matrix of the convention above."""
    if not (0 < near < far):
        raise ValueError(f"need 0 < near < far, got {near}, {far}")
    tan_half_fov_v = tan_half_fov_h / aspect
    if reversed_z:
        a = -near / (far - near)
        b = near * far / (far - near)
    else:
        a = far / (far - near)
        b = -near * far / (far - near)
    p = np.zeros((4, 4), dtype=np.float64)
    p[0, 0] = 1.0 / tan_half_fov_h
    p[1, 1] = 1.0 / tan_half_fov_v
    p[2, 2] = a
    p[2, 3] = b
    p[3, 2] = 1.0
    return p


def _extract_b(p) -> float:
    """B from a canonical (w row [0,0,1,0], B at ``p[2,3]``) or transposed
    (B at ``p[3,2]``) matrix; when both entries are 1.0 the two readings
    agree (B == 1.0)."""
    if p[3, 2] == 1.0 and p[2, 3] == 1.0:
        return 1.0
    if p[3, 2] == 1.0:
        return p[2, 3]
    if p[2, 3] == 1.0:
        return p[3, 2]
    raise ValueError(
        "unrecognized perspective convention: expected a unit w row "
        "(P[3,2] == 1, left-handed D3D clip) or its transpose")


def camera_from_projection(p, depth_mode: str = "hardware") -> CameraParams:
    """``CameraParams`` (near, far, tan_half_fov_h, reversed_z) of a matrix
    of the convention above or its transpose; the Z direction comes from
    the sign of B (positive: reversed-Z)."""
    p = np.asarray(p, dtype=np.float64)
    if p.shape != (4, 4):
        raise ValueError(f"expected a 4x4 projection matrix, got {p.shape}")
    if p[0, 0] == 0.0:
        raise ValueError("P[0,0] == 0: not a perspective matrix")
    a = p[2, 2]
    b = _extract_b(p)
    if b == 0.0:
        raise ValueError("B == 0: not a finite-far perspective matrix")
    if b > 0:  # reversed-Z
        far = -b / a
        near = b / (1.0 - a)
        reversed_z = True
    else:
        near = -b / a
        far = -b / (a - 1.0)
        reversed_z = False
    if not (0 < near < far) or not np.isfinite(far):
        raise ValueError(f"extracted invalid near/far ({near}, {far})")
    return CameraParams(near=float(near), far=float(far),
                        tan_half_fov_h=float(1.0 / p[0, 0]),
                        reversed_z=reversed_z, depth_mode=depth_mode)


def relative_motion(view_prev, view_curr) -> np.ndarray:
    """Current-eye -> previous-eye transform for temporal reprojection:
    ``view_prev @ inv(view_curr)`` for world->eye view matrices (4x4,
    row-major, ``eye = V @ world``) -- the ``motion`` of
    ``ops/temporal.py::temporal_resolve``."""
    vp = np.asarray(view_prev, dtype=np.float64).reshape(4, 4)
    vc = np.asarray(view_curr, dtype=np.float64).reshape(4, 4)
    return vp @ np.linalg.inv(vc)


def hardware_depth(z_eye, p) -> np.ndarray:
    """Eye-space depth -> hardware depth buffer values under matrix ``p``
    (``A + B/z``)."""
    p = np.asarray(p, dtype=np.float64)
    z = np.asarray(z_eye, dtype=np.float64)
    return p[2, 2] + _extract_b(p) / z

"""P3P absolute-pose solver, RANSAC localization and a nonlinear polish.

The role of OpenGV in the reference's dense initialization (reference:
applications/camera_calibration/src/camera_calibration/
calibration_initialization/dense_initialization.cc:379-399: P3P RANSAC with
threshold 1−cos(atan(3/720)), 10 iterations, then a nonlinear polish over
all inliers).

The minimal solver is Grunert's distance-quartic P3P in NumPy; RANSAC draws
its minimal sets from ``np.random.default_rng(seed)``.  The polish is an
SE(3) Levenberg-Marquardt (``ba/gn.lm_solve``) over the inliers on
``config.host_device()``: a 6-DoF solve with a host decision per
iteration.

Pose convention: returns (R, t) with ``x_world = R · x_cam + t`` (camera
center = t).
"""

from __future__ import annotations

import numpy as np
import torch

from camera_calibration_torch.ba.gn import lm_solve
from camera_calibration_torch.config import host_device
from camera_calibration_torch.ops import se3


def p3p_grunert(bearings, points):
    """Solve P3P: bearings (3,3) unit vectors in camera frame, points (3,3).

    Returns a list of (R, t) candidate poses (x_world = R x_cam + t).
    """
    f1, f2, f3 = bearings
    p1, p2, p3 = points

    a = np.linalg.norm(p2 - p3)
    b = np.linalg.norm(p1 - p3)
    c = np.linalg.norm(p1 - p2)
    if min(a, b, c) < 1e-12:
        return []

    cos_al = float(np.dot(f2, f3))
    cos_be = float(np.dot(f1, f3))
    cos_ga = float(np.dot(f1, f2))

    a2, b2, c2 = a * a, b * b, c * c
    # Grunert's quartic in v (s2 = u·s1, s3 = v·s1).
    q1 = (a2 - c2) / b2
    q2 = (a2 + c2) / b2
    q3 = (b2 - c2) / b2
    q4 = (b2 - a2) / b2

    coeffs = np.array(
        [
            (q1 - 1.0) ** 2 - 4.0 * c2 / b2 * cos_al**2,
            4.0
            * (
                q1 * (1.0 - q1) * cos_be
                - (1.0 - q2) * cos_al * cos_ga
                + 2.0 * c2 / b2 * cos_al**2 * cos_be
            ),
            2.0
            * (
                q1**2
                - 1.0
                + 2.0 * q1**2 * cos_be**2
                + 2.0 * q3 * cos_al**2
                - 4.0 * q2 * cos_al * cos_be * cos_ga
                + 2.0 * q4 * cos_ga**2
            ),
            4.0
            * (
                -q1 * (1.0 + q1) * cos_be
                + 2.0 * a2 / b2 * cos_ga**2 * cos_be
                - (1.0 - q2) * cos_al * cos_ga
            ),
            (1.0 + q1) ** 2 - 4.0 * a2 / b2 * cos_ga**2,
        ]
    )
    if not np.all(np.isfinite(coeffs)) or abs(coeffs).max() < 1e-15:
        return []

    roots = np.roots(coeffs)
    poses = []
    for v in roots:
        if abs(v.imag) > 1e-9:
            continue
        v = float(v.real)
        # u from the linear pairing relation:
        #   u = ((-1 + q1) v² - 2 q1 cos_be v + 1 + q1) /
        #       (2 (cos_ga - v cos_al))
        du = 2.0 * (cos_ga - v * cos_al)
        if abs(du) < 1e-12:
            continue
        u = ((-1.0 + q1) * v * v - 2.0 * q1 * cos_be * v + 1.0 + q1) / du

        # s1 from  s1² (u² + v² − 2 u v cos_al) = a²
        s1_sq = a2 / max(u * u + v * v - 2.0 * u * v * cos_al, 1e-18)
        if s1_sq <= 0:
            continue
        s1 = float(np.sqrt(s1_sq))
        s2 = u * s1
        s3 = v * s1
        if s2 <= 0 or s3 <= 0:
            continue

        cam_pts = np.stack([s1 * f1, s2 * f2, s3 * f3])
        r, t = _absolute_orientation(cam_pts, points)
        if r is not None:
            poses.append((r, t))
    return poses


def _absolute_orientation(src, dst):
    """Rigid transform with dst = R src + t (Horn/Kabsch, 3 points)."""
    cs = src.mean(0)
    cd = dst.mean(0)
    h = (src - cs).T @ (dst - cd)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    t = cd - r @ cs
    if not np.all(np.isfinite(r)):
        return None, None
    return r, t


def ransac_p3p(
    bearings,
    points,
    *,
    threshold: float = 1.0 - np.cos(np.arctan(3.0 / 720.0)),
    max_iterations: int = 10,
    seed: int = 0,
    polish: bool = True,
    device=None,
):
    """RANSAC over P3P hypotheses + optional LM polish on the inliers.

    bearings (N,3) unit camera-frame rays, points (N,3) world points.
    threshold: 1 − cos(angle) inlier criterion.  The polish runs on
    ``device`` (default: ``config.host_device()``).  Returns
    (R, t, inlier_mask) as NumPy arrays, or None.
    """
    bearings = np.asarray(bearings, np.float64)
    points = np.asarray(points, np.float64)
    n = bearings.shape[0]
    if n < 3:
        return None
    rng = np.random.default_rng(seed)

    best = None
    best_inliers = None
    best_count = 2
    for _ in range(max_iterations):
        idx = rng.choice(n, 3, replace=False)
        for r, t in p3p_grunert(bearings[idx], points[idx]):
            # residual: angle between bearing and direction to point
            dirs = (points - t) @ r  # = Rᵀ (P − t), rows
            norms = np.linalg.norm(dirs, axis=-1)
            ok = norms > 1e-12
            cosang = np.sum(dirs * bearings, -1) / np.maximum(norms, 1e-12)
            inliers = ok & (1.0 - cosang < threshold)
            count = int(inliers.sum())
            if count > best_count:
                best = (r, t)
                best_inliers = inliers
                best_count = count
    if best is None:
        return None

    r, t = best
    if polish:
        r, t = polish_pose(r, t, bearings[best_inliers],
                           points[best_inliers], device=device)
    return r, t, best_inliers


def polish_pose(r, t, bearings, points, device=None):
    """LM refinement of a pose (x_world = R x_cam + t) so that the
    directions to ``points`` match ``bearings`` (10 LM iterations of 12 CG
    steps each).  Returns NumPy (R, t)."""
    device = host_device() if device is None else torch.device(device)

    def f64(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    pts, bear = f64(points), f64(bearings)

    def residual_fn(pose):
        q, tt = pose
        d = se3.quat_rotate(se3.quat_conj(q), pts - tt)
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        return (d - bear).reshape(-1)

    def retract_fn(pose, delta):
        q, tt = pose
        return se3.retract_pose(q, tt, delta)

    q0 = se3.matrix_to_quat(f64(r))
    result = lm_solve(residual_fn, retract_fn, (q0, f64(t)),
                      torch.zeros(6, dtype=torch.float64, device=device),
                      max_iterations=10, cg_iterations=12)
    q, tt = result.state
    return se3.quat_to_matrix(q).cpu().numpy(), tt.cpu().numpy()

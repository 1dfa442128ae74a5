"""Closed-form relative poses from collinearity constraints (Ramalingam-Sturm).

Central camera + planar calibration target (Sec. 5.3 of S. Ramalingam's
PhD thesis; reference: applications/camera_calibration/src/
camera_calibration/relative_pose_initialization/
central_camera_planar_target.cc:34-498): given three planar point clouds
(z = 0) that are the *same pattern* seen at three unknown poses, where cloud
triples with equal index are observed along the same camera ray, recover
the two poses mapping clouds 0 and 1 into cloud 2's frame plus the
camera's optical center.  The central + 3D-target variant takes two clouds.
Both run on tensors, on the device of their input (the pipeline passes
them on ``config.host_device()``); rows can be zero-weighted, which does
not change a null space.

The reference has an apparent index typo ``R1(1,1)=u(11)``
(central_camera_planar_target.cc:441); by symmetry with R0 it should be
``u(14)``, and it is implemented so here.  The λ sign ambiguity is resolved
by testing the first three triples, as the reference does with sample
points.

The two noncentral variants below work in NumPy.
"""

from __future__ import annotations

import numpy as np
import torch


def _null_vector(a):
    """Right-singular vector for the smallest singular value of a."""
    _, _, vt = torch.linalg.svd(a, full_matrices=True)
    return vt[-1]


def _min_norm_plus_null(a, b, rank):
    """Solve a·u = b (rank-deficient): minimum-norm solution + null vectors.

    Returns (u0, null_cols) with null_cols the trailing right-singular
    vectors (columns beyond ``rank``).  Algorithm A5.2 of Hartley-Zisserman.
    """
    u_svd, s, vt = torch.linalg.svd(a, full_matrices=True)
    b_prime = u_svd.T @ b
    n = vt.shape[0]
    k = s.shape[0]
    safe_s = torch.where(s > 1e-14, s, torch.ones_like(s))
    y = a.new_zeros(n)
    y[:k] = torch.where(torch.arange(k, device=a.device) < rank,
                        b_prime[:k] / safe_s, torch.zeros_like(s))
    return vt.T @ y, vt[rank:].T


def _safe(d, tiny=1e-300):
    return torch.where(torch.abs(d) > tiny, d, torch.ones_like(d))


def _matrix(rows, like):
    """A tensor from nested lists of scalars and 0-d tensors."""
    return torch.stack([
        torch.stack([torch.as_tensor(v, dtype=like.dtype, device=like.device)
                     for v in row]) for row in rows])


def central_planar_relative_pose(clouds, weights=None):
    """Recover poses from three aligned planar clouds.

    clouds: (3, N, 2) pattern-plane coordinates (z=0 implicit); row i of
    each cloud lies on one camera ray.  weights: (N,) 0/1 row mask.
    Returns dict with:
      r0, t0: cloud2_tr_cloud0 rotation (3,3) + translation (3,)
      r1, t1: cloud2_tr_cloud1
      optical_center: (3,) in cloud 2's (pattern) frame
      ok: bool validity flag (a 0-d tensor)
    """
    clouds = torch.as_tensor(clouds)
    dtype, dev = clouds.dtype, clouds.device
    n = clouds.shape[1]
    w = (torch.ones(n, dtype=dtype, device=dev) if weights is None
         else torch.as_tensor(weights, dtype=dtype, device=dev))

    # Hartley normalization over all three clouds jointly
    # (central_camera_planar_target.cc:45-76).
    wsum = torch.clamp_min(torch.sum(w), 1e-12)
    mean = torch.sum(clouds * w[None, :, None], dim=(0, 1)) / (3 * wsum)
    centered = clouds - mean
    mean_dist = torch.sum(
        torch.linalg.vector_norm(centered, dim=-1) * w[None, :]) / (3 * wsum)
    norm_factor = np.sqrt(2.0) / torch.clamp_min(mean_dist, 1e-12)
    nc = centered * norm_factor

    q = nc[2]  # (N,2) fixed cloud
    qp = nc[0]
    qpp = nc[1]
    one = torch.ones(n, dtype=dtype, device=dev)
    zero = torch.zeros(n, dtype=dtype, device=dev)

    def c_matrix(qo):
        """2N×9 coefficient matrix rows (cc:80-158)."""
        r1 = torch.stack([q[:, 1] * qo[:, 0], q[:, 1] * qo[:, 1], q[:, 1],
                          qo[:, 0], qo[:, 1], one, zero, zero, zero], dim=-1)
        r2 = torch.stack([q[:, 0] * qo[:, 0], q[:, 0] * qo[:, 1], q[:, 0],
                          zero, zero, zero, qo[:, 0], qo[:, 1], one], dim=-1)
        rows = torch.stack([r1, r2], dim=1).reshape(2 * n, 9)
        return rows * torch.repeat_interleave(w, 2)[:, None]

    u_vec = _null_vector(c_matrix(qp))  # "U" (cc:160-163)
    l_vec = _null_vector(c_matrix(qpp))  # "L" (cc:168-170)

    # 12×14 motion-extraction system (cc:183-227).
    a_mat = torch.zeros((12, 14), dtype=dtype, device=dev)
    for i in range(3):
        a_mat[i, 1] = -u_vec[i]
        a_mat[3 + i, 0] = -u_vec[i]
        a_mat[6 + i, 1] = -l_vec[i]
        a_mat[9 + i, 0] = -l_vec[i]
    for row, col in ((0, 6), (1, 7), (2, 3), (3, 4), (4, 5), (5, 2),
                     (6, 12), (7, 13), (8, 9), (9, 10), (10, 11), (11, 8)):
        a_mat[row, col] = 1.0
    a_b = torch.cat([u_vec[3:9], l_vec[3:9]])

    sol_a, nulls = _min_norm_plus_null(a_mat, a_b, rank=12)
    sol_b = nulls[:, 0]
    sol_c = nulls[:, 1]

    def a_(i):
        return sol_a[i - 1]

    def b_(i):
        return sol_b[i - 1]

    def c_(i):
        return sol_c[i - 1]

    # 6×8 quadratic-constraint system (cc:252-320).
    a8 = _matrix([
        [
            a_(5) * b_(6) + b_(5) * a_(6) + a_(7) * b_(8) + b_(7) * a_(8),
            a_(5) * c_(6) + c_(5) * a_(6) + a_(7) * c_(8) + c_(7) * a_(8),
            b_(5) * c_(6) + c_(5) * b_(6) + b_(7) * c_(8) + c_(7) * b_(8),
            b_(5) * b_(6) + b_(7) * b_(8),
            c_(5) * c_(6) + c_(7) * c_(8),
            u_vec[0] * u_vec[1],
            0.0,
            0.0,
        ],
        [
            a_(11) * b_(12) + b_(11) * a_(12) + a_(13) * b_(14) + b_(13) * a_(14),
            a_(11) * c_(12) + c_(11) * a_(12) + a_(13) * c_(14) + c_(13) * a_(14),
            b_(11) * c_(12) + c_(11) * b_(12) + b_(13) * c_(14) + c_(13) * b_(14),
            b_(11) * b_(12) + b_(13) * b_(14),
            c_(11) * c_(12) + c_(13) * c_(14),
            l_vec[0] * l_vec[1],
            0.0,
            0.0,
        ],
        [
            2 * a_(5) * b_(5) + 2 * a_(7) * b_(7),
            2 * a_(5) * c_(5) + 2 * a_(7) * c_(7),
            2 * b_(5) * c_(5) + 2 * b_(7) * c_(7),
            b_(5) * b_(5) + b_(7) * b_(7),
            c_(5) * c_(5) + c_(7) * c_(7),
            u_vec[0] * u_vec[0],
            -1.0,
            0.0,
        ],
        [
            2 * a_(6) * b_(6) + 2 * a_(8) * b_(8),
            2 * a_(6) * c_(6) + 2 * a_(8) * c_(8),
            2 * b_(6) * c_(6) + 2 * b_(8) * c_(8),
            b_(6) * b_(6) + b_(8) * b_(8),
            c_(6) * c_(6) + c_(8) * c_(8),
            u_vec[1] * u_vec[1],
            -1.0,
            0.0,
        ],
        [
            2 * a_(11) * b_(11) + 2 * a_(13) * b_(13),
            2 * a_(11) * c_(11) + 2 * a_(13) * c_(13),
            2 * b_(11) * c_(11) + 2 * b_(13) * c_(13),
            b_(11) * b_(11) + b_(13) * b_(13),
            c_(11) * c_(11) + c_(13) * c_(13),
            l_vec[0] * l_vec[0],
            0.0,
            -1.0,
        ],
        [
            2 * a_(12) * b_(12) + 2 * a_(14) * b_(14),
            2 * a_(12) * c_(12) + 2 * a_(14) * c_(14),
            2 * b_(12) * c_(12) + 2 * b_(14) * c_(14),
            b_(12) * b_(12) + b_(14) * b_(14),
            c_(12) * c_(12) + c_(14) * c_(14),
            l_vec[1] * l_vec[1],
            0.0,
            -1.0,
        ],
    ], clouds)
    b8 = torch.stack([
        -a_(5) * a_(6) - a_(7) * a_(8),
        -a_(11) * a_(12) - a_(13) * a_(14),
        -a_(5) * a_(5) - a_(7) * a_(7),
        -a_(6) * a_(6) - a_(8) * a_(8),
        -a_(11) * a_(11) - a_(13) * a_(13),
        -a_(12) * a_(12) - a_(14) * a_(14),
    ])
    sol_d, _ = _min_norm_plus_null(a8, b8, rank=5)

    solution_u = sol_a + sol_d[0] * sol_b + sol_d[1] * sol_c

    def u(i):
        return solution_u[i - 1]

    # Optical center (cc:352-381), normalized frame.
    ox = u(1)
    oy = u(2)
    denom_v = -u_vec[0] * u_vec[1]
    denom_m = -l_vec[0] * l_vec[1]
    temp_v = (u(5) * u(6) + u(7) * u(8)) / _safe(denom_v)
    temp_m = (u(11) * u(12) + u(13) * u(14)) / _safe(denom_m)
    use_v = torch.abs(denom_v) > torch.abs(denom_m)
    temp = torch.where(use_v, temp_v, temp_m)
    ok = temp > -1e-3
    oz = -torch.sqrt(torch.clamp_min(temp, 0.0))  # camera at negative z
    o = torch.stack([ox, oy, oz])

    def extract_pose(u5, u6, u7, u8, row3a, row3b, u3, u4, u6_full,
                     test_cloud):
        """Pose from one λ branch with sign disambiguation (cc:390-447)."""

        def pose_for(lam_sign):
            lam = lam_sign * torch.sqrt(
                u5 * u5 + u7 * u7 + row3a * row3a * oz * oz) / oz
            col0 = torch.stack([u5 / (oz * lam), u7 / (oz * lam), row3a / lam])
            col1 = torch.stack([u6 / (oz * lam), u8 / (oz * lam), row3b / lam])
            col2 = torch.linalg.cross(col0, col1)
            r = torch.stack([col0, col1, col2], dim=-1)
            tx = (u3 + ox * oz * lam) / (oz * lam)
            ty = (u4 + oy * oz * lam) / (oz * lam)
            tz = (oz * ty - u6_full / lam) / _safe(oy)
            return r, torch.stack([tx, ty, tz])

        r_neg, t_neg = pose_for(-1.0)
        r_pos, t_pos = pose_for(1.0)
        # Same-side test with the first 3 points (cc:414-431).
        z3 = torch.zeros((3, 1), dtype=dtype, device=dev)
        p3 = torch.cat([test_cloud[:3], z3], dim=-1)
        ref3 = torch.cat([q[:3], z3], dim=-1)
        tp = p3 @ r_neg.T + t_neg
        same = torch.sum((tp - o) * (ref3 - o), dim=-1) > 0
        use_neg = torch.sum(same.to(torch.int64)) * 2 > 3
        return (torch.where(use_neg, r_neg, r_pos),
                torch.where(use_neg, t_neg, t_pos))

    r0, t0 = extract_pose(
        u(5), u(6), u(7), u(8), u_vec[0], u_vec[1], u(3), u(4), u_vec[5], qp)
    r1, t1 = extract_pose(
        u(11), u(12), u(13), u(14), l_vec[0], l_vec[1], u(9), u(10),
        l_vec[5], qpp)

    # De-normalize: the solve ran on x' = norm_factor·(x − mean). A pose
    # (R, t') in normalized coords maps to t = t'/norm_factor + mean −
    # R·mean (rotation unchanged); the optical center scales the same way.
    mean3 = torch.cat([mean, torch.zeros(1, dtype=dtype, device=dev)])

    def denorm(r, t):
        return r, t / norm_factor + mean3 - r @ mean3

    r0, t0 = denorm(r0, t0)
    r1, t1 = denorm(r1, t1)
    o_out = o / norm_factor + mean3

    ok = (ok & torch.all(torch.isfinite(o_out)) & torch.all(torch.isfinite(t0))
          & torch.all(torch.isfinite(t1)))
    return {"r0": r0, "t0": t0, "r1": r1, "t1": t1,
            "optical_center": o_out, "ok": ok}


def central_3d_relative_pose(clouds, weights=None):
    """Central camera + 3D calibration target relative pose.

    (reference: relative_pose_initialization/central_camera_3d_target.cc:
    33-209.)  clouds: (2, N, 3) 3D target points observed at two poses,
    row i collinear with the optical center; weights: (N,) 0/1 row mask;
    ≥10 effective rows required.  Returns dict with r (cloud1_tr_cloud0),
    t, optical_center (in cloud 1's frame) and ok.
    """
    clouds = torch.as_tensor(clouds)
    dtype, dev = clouds.dtype, clouds.device
    n = clouds.shape[1]
    w = (torch.ones(n, dtype=dtype, device=dev) if weights is None
         else torch.as_tensor(weights, dtype=dtype, device=dev))

    q = clouds[1]  # fixed cloud
    qp = clouds[0]
    zero4 = torch.zeros((n, 4), dtype=dtype, device=dev)
    qp_h = torch.cat([qp, torch.ones((n, 1), dtype=dtype, device=dev)], -1)

    row_v = torch.cat(
        [q[:, 1:2] * qp_h, q[:, 2:3] * qp_h, qp_h, zero4, zero4], dim=-1)
    row_w = torch.cat(
        [q[:, 0:1] * qp_h, zero4, zero4, q[:, 2:3] * qp_h, qp_h], dim=-1)
    c = torch.stack([row_v, row_w], dim=1).reshape(2 * n, 20)
    c = c * torch.repeat_interleave(w, 2)[:, None]

    u_vec = _null_vector(c)

    lam = torch.sqrt(u_vec[0] ** 2 + u_vec[1] ** 2 + u_vec[2] ** 2)
    u = u_vec / torch.clamp_min(lam, 1e-300)

    r = torch.stack([-u[12:15], -u[4:7], u[0:3]])
    det = torch.linalg.det(r)
    sign = torch.where(det < 0, -1.0, 1.0).to(dtype)
    u = sign * u
    r = sign * r

    def pick(d1, d2, d3, n1, n2, n3):
        """Choose the best-conditioned of three division variants."""
        a1, a2, a3 = torch.abs(d1), torch.abs(d2), torch.abs(d3)
        v1 = n1 / _safe(d1)
        v2 = n2 / _safe(d2)
        v3 = n3 / _safe(d3)
        use1 = (a1 > a3) & (a1 > a2)
        use2 = (~use1) & (a2 >= a3)
        return torch.where(use1, v1, torch.where(use2, v2, v3))

    # optical center (cc:138-195; variant selection avoids near-zero denoms)
    ox = pick(
        r[2, 0] * r[0, 1] - r[2, 1] * r[0, 0],
        r[2, 1] * r[0, 2] - r[2, 2] * r[0, 1],
        r[2, 0] * r[0, 2] - r[2, 2] * r[0, 0],
        -(u[16] * r[0, 1] - u[17] * r[0, 0]),
        -(u[17] * r[0, 2] - u[18] * r[0, 1]),
        -(u[16] * r[0, 2] - u[18] * r[0, 0]),
    )
    oy = pick(
        r[2, 0] * r[1, 1] - r[2, 1] * r[1, 0],
        r[2, 1] * r[1, 2] - r[2, 2] * r[1, 1],
        r[2, 0] * r[1, 2] - r[2, 2] * r[1, 0],
        -(u[8] * r[1, 1] - u[9] * r[1, 0]),
        -(u[9] * r[1, 2] - u[10] * r[1, 1]),
        -(u[8] * r[1, 2] - u[10] * r[1, 0]),
    )
    oz = pick(
        r[1, 0] * r[2, 1] - r[1, 1] * r[2, 0],
        r[1, 1] * r[2, 2] - r[1, 2] * r[2, 1],
        r[1, 0] * r[2, 2] - r[1, 2] * r[2, 0],
        u[8] * r[2, 1] - u[9] * r[2, 0],
        u[9] * r[2, 2] - u[10] * r[2, 1],
        u[8] * r[2, 2] - u[10] * r[2, 0],
    )
    o = torch.stack([ox, oy, oz])
    t = torch.stack([ox - u[15], oy - u[7], u[3] + oz])

    ok = (torch.all(torch.isfinite(o)) & torch.all(torch.isfinite(t))
          & (lam > 1e-12))
    return {"r": r, "t": t, "optical_center": o, "ok": ok}


# --------------------- noncentral (Ramalingam-Sturm) ---------------------
#
# Both noncentral variants below recover the poses of point clouds whose
# equal-index triples lie on a common 3D line (one line per "pixel", no
# common optical center) — the initializers for NoncentralGeneric
# calibration.  Capability parity with the reference's
# relative_pose_initialization/noncentral_camera_{3d,planar}_target.cc
# (API algorithms.h:50-77), but with a different derivation:
#
# With homogeneous pose matrices P = [R | t], the collinearity constraint
# cross(B − A, C − A) = 0 for A = Q (fixed cloud), B = P0·Qp_h,
# C = P1·Qpp_h expands into a linear system over the lifted unknowns
#   G^c[k, l] = (p0_k × p1_l)_c          (cross products of pose columns),
#   rotation entries,  and  d = t0 − t1,
# assembled from ALL THREE cross components.  For a 3D target the null
# space is one-dimensional and extraction is direct.  For a planar target
# the null space is four-dimensional; a consistent solution is found by a
# small Gauss-Newton over the 4 null coordinates enforcing the
# cross-product/orthonormality consistency of the lifted vector, and the
# second (mirror) solution follows analytically: reflecting the scene
# through the z=0 pattern plane (F = diag(1,1,−1)) maps any solution
# (R, t) to the equally valid (F·R, F·t) because the fixed cloud lies in
# that plane.  The reference resolves this ambiguity with the ground-truth
# pose (noncentral_camera_planar_target.cc:261,280 — test-only); here BOTH
# candidates are returned and the caller disambiguates physically (e.g.
# image-orientation handedness, or downstream consistency).

_CYC = ((1, 2), (2, 0), (0, 1))


def _hat(v):
    return np.array([
        [0.0, -v[2], v[1]],
        [v[2], 0.0, -v[0]],
        [-v[1], v[0], 0.0],
    ])


def _procrustes_rotation(cols):
    """Nearest orthonormal completion of 3×2 column pairs -> full 3×3."""
    u, _, vt = np.linalg.svd(cols, full_matrices=False)
    c = u @ vt
    r = np.column_stack([c[:, 0], c[:, 1], np.cross(c[:, 0], c[:, 1])])
    return r


def noncentral_3d_relative_pose(clouds, weights=None):
    """Noncentral camera + 3D target relative pose (3 clouds).

    clouds: (3, N, 3) — equal-index triples collinear; clouds[2]'s pose is
    fixed to identity.  Returns dict with r0/t0 (cloud2_tr_cloud0), r1/t1
    (cloud2_tr_cloud1), ok.  Needs N ≥ 24 non-degenerate, genuinely
    noncentral data (near-central line sets are ill-conditioned here —
    use the central variants instead).
    """
    clouds = np.asarray(clouds, np.float64)
    n = clouds.shape[1]
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    if n < 24:
        return {"ok": False}

    mean = (clouds * w[None, :, None]).sum((0, 1)) / max(3 * w.sum(), 1e-12)
    centered = clouds - mean
    md = (np.linalg.norm(centered, axis=-1) * w[None]).sum() / max(
        3 * w.sum(), 1e-12
    )
    nf = np.sqrt(3.0) / max(md, 1e-12)
    nc = centered * nf

    a_cl, qp, qpp = nc[2], nc[0], nc[1]
    qph = np.concatenate([qp, np.ones((n, 1))], 1)
    qpph = np.concatenate([qpp, np.ones((n, 1))], 1)
    rows = []
    for c, (c1, c2) in enumerate(_CYC):
        r = np.zeros((n, 69))
        r[:, 16 * c:16 * (c + 1)] = (
            qph[:, :, None] * qpph[:, None, :]
        ).reshape(n, 16)
        r[:, 48 + 3 * c1:48 + 3 * c1 + 3] += -a_cl[:, c2:c2 + 1] * qp
        r[:, 48 + 3 * c2:48 + 3 * c2 + 3] += a_cl[:, c1:c1 + 1] * qp
        r[:, 57 + 3 * c2:57 + 3 * c2 + 3] += -a_cl[:, c1:c1 + 1] * qpp
        r[:, 57 + 3 * c1:57 + 3 * c1 + 3] += a_cl[:, c2:c2 + 1] * qpp
        r[:, 66 + c1] += -a_cl[:, c2]
        r[:, 66 + c2] += a_cl[:, c1]
        rows.append(r * w[:, None])
    c_mat = np.concatenate(rows, 0)

    _, sv, vt = np.linalg.svd(c_mat, full_matrices=False)
    v = vt[-1]

    g = v[:48].reshape(3, 4, 4)  # [component, k, l]
    r0_raw = v[48:57].reshape(3, 3)  # rows-major: R0 rows
    r1_raw = v[57:66].reshape(3, 3)
    d = v[66:69]
    lam = np.sqrt(max((r0_raw ** 2).sum() + (r1_raw ** 2).sum(), 1e-30) / 6.0)
    v = v / lam
    g, r0_raw, r1_raw, d = (
        g / lam, r0_raw / lam, r1_raw / lam, d / lam,
    )
    if np.linalg.det(r0_raw) < 0:
        g, r0_raw, r1_raw, d = -g, -r0_raw, -r1_raw, -d
    u_, _, vt_ = np.linalg.svd(r0_raw)
    r0 = u_ @ vt_
    u_, _, vt_ = np.linalg.svd(r1_raw)
    r1 = u_ @ vt_
    if np.linalg.det(r0) < 0 or np.linalg.det(r1) < 0:
        return {"ok": False}

    # translations: G[:,k,3] = R0col_k × t1, G[:,3,l] = t0 × R1col_l,
    # t0 − t1 = d  (21 linear equations, 6 unknowns)
    a_rows, b_rows = [], []
    for k in range(3):
        a_rows.append(np.concatenate(
            [np.zeros((3, 3)), _hat(r0[:, k])], axis=1))
        b_rows.append(np.array([g[c, k, 3] for c in range(3)]))
    for l in range(3):
        a_rows.append(np.concatenate(
            [-_hat(r1[:, l]), np.zeros((3, 3))], axis=1))
        b_rows.append(np.array([g[c, 3, l] for c in range(3)]))
    a_rows.append(np.concatenate([np.eye(3), -np.eye(3)], axis=1))
    b_rows.append(d)
    t_sol, *_ = np.linalg.lstsq(
        np.concatenate(a_rows), np.concatenate(b_rows), rcond=None
    )
    t0n, t1n = t_sol[:3], t_sol[3:]

    def denorm(r, t):
        return r, t / nf + mean - r @ mean

    r0, t0 = denorm(r0, t0n)
    r1, t1 = denorm(r1, t1n)
    # unique-null-vector check: a clear gap between the two smallest
    # singular values (near-central or degenerate data collapses it)
    ok = (
        np.isfinite(t0).all() and np.isfinite(t1).all()
        and sv[-2] > 10.0 * sv[-1] + 1e-12 * sv[0]
    )
    return {"r0": r0, "t0": t0, "r1": r1, "t1": t1, "ok": bool(ok)}


def _planar_consistency_residuals(v):
    g = v[:27].reshape(3, 3, 3)
    r0 = v[27:33].reshape(3, 2)
    r1 = v[33:39].reshape(3, 2)
    d = v[39:42]
    res = []
    for k in range(2):
        for l in range(2):
            res.extend(np.cross(r0[:, k], r1[:, l]) - g[:, k, l])
    res.append(r0[:, 0] @ r0[:, 0] - r0[:, 1] @ r0[:, 1])
    res.append(r0[:, 0] @ r0[:, 1])
    res.append(r1[:, 0] @ r1[:, 0] - r1[:, 1] @ r1[:, 1])
    res.append(r1[:, 0] @ r1[:, 1])
    res.append(np.sum(r0 ** 2) - np.sum(r1 ** 2))
    for k in range(2):
        res.append(g[:, k, 2] @ r0[:, k])
    for l in range(2):
        res.append(g[:, 2, l] @ r1[:, l])
    res.append(g[:, 2, 2] @ d)
    res.append(np.sum(r0 ** 2) - 2.0)  # unit columns (scale fix)
    return np.asarray(res)


def noncentral_planar_relative_pose(clouds, weights=None):
    """Noncentral camera + planar target relative pose (3 clouds, z = 0).

    clouds: (3, N, 2) pattern-plane coordinates.  Returns dict with
    ``candidates``: a list of TWO {r0,t0,r1,t1} dicts — the solution and
    its mirror through the pattern plane (see module comment) — plus
    ``ok``.  Needs N ≥ 16 and genuinely noncentral data.
    """
    clouds = np.asarray(clouds, np.float64)
    n = clouds.shape[1]
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    if n < 16:
        return {"ok": False, "candidates": []}

    mean = (clouds * w[None, :, None]).sum((0, 1)) / max(3 * w.sum(), 1e-12)
    centered = clouds - mean
    md = (np.linalg.norm(centered, axis=-1) * w[None]).sum() / max(
        3 * w.sum(), 1e-12
    )
    nf = np.sqrt(2.0) / max(md, 1e-12)
    nc = centered * nf

    a2, qp2, qpp2 = nc[2], nc[0], nc[1]
    a3 = np.concatenate([a2, np.zeros((n, 1))], 1)
    qph = np.concatenate([qp2, np.ones((n, 1))], 1)
    qpph = np.concatenate([qpp2, np.ones((n, 1))], 1)
    rows = []
    for c, (c1, c2) in enumerate(_CYC):
        r = np.zeros((n, 42))
        r[:, 9 * c:9 * (c + 1)] = (
            qph[:, :, None] * qpph[:, None, :]
        ).reshape(n, 9)
        r[:, 27 + 2 * c1:27 + 2 * c1 + 2] += -a3[:, c2:c2 + 1] * qp2
        r[:, 27 + 2 * c2:27 + 2 * c2 + 2] += a3[:, c1:c1 + 1] * qp2
        r[:, 33 + 2 * c2:33 + 2 * c2 + 2] += -a3[:, c1:c1 + 1] * qpp2
        r[:, 33 + 2 * c1:33 + 2 * c1 + 2] += a3[:, c2:c2 + 1] * qpp2
        r[:, 39 + c1] += -a3[:, c2]
        r[:, 39 + c2] += a3[:, c1]
        rows.append(r * w[:, None])
    c_mat = np.concatenate(rows, 0)

    _, sv, vt = np.linalg.svd(c_mat, full_matrices=False)
    # The structural null space is 4-dim (2 gauge + the mirror-pair line),
    # but weakly-noncentral data blurs additional directions into it; keep
    # every direction within a relative gap of the smallest so the true
    # solution stays inside the searched subspace.
    k = int(np.sum(sv < max(1e-10 * sv[0], 1e3 * sv[-1])))
    k = int(np.clip(k, 4, 12))
    null = vt[-k:]

    def gn(alpha0):
        a = alpha0.astype(np.float64).copy()
        lam = 0.0
        for _ in range(80):
            v = null.T @ a
            r = _planar_consistency_residuals(v)
            jac = np.zeros((r.size, k))
            eps = 1e-7 * max(1.0, np.linalg.norm(a))
            for i in range(k):
                ap = a.copy()
                ap[i] += eps
                jac[:, i] = (
                    _planar_consistency_residuals(null.T @ ap) - r
                ) / eps
            try:
                step = np.linalg.lstsq(jac, -r, rcond=None)[0]
            except np.linalg.LinAlgError:
                break
            a = a + step
            if np.linalg.norm(step) < 1e-13 * max(1.0, np.linalg.norm(a)):
                break
        return a, float(np.linalg.norm(
            _planar_consistency_residuals(null.T @ a)
        ))

    best = None
    starts = [np.eye(k)[i] for i in range(k)] + [
        np.ones(k) / np.sqrt(k),
        np.array([(-1.0) ** i for i in range(k)]) / np.sqrt(k),
    ]
    for s0 in starts:
        a, rn = gn(np.asarray(s0))
        if best is None or rn < best[1]:
            best = (a, rn)
        if rn < 1e-9:
            break
    alpha, resid = best
    v = null.T @ alpha

    g = v[:27].reshape(3, 3, 3)
    r0_cols = v[27:33].reshape(3, 2)
    r1_cols = v[33:39].reshape(3, 2)
    d = v[39:42]
    r0 = _procrustes_rotation(r0_cols)
    r1 = _procrustes_rotation(r1_cols)

    # translations: G[:,k,2] = R0col_k × t1, G[:,2,l] = t0 × R1col_l,
    # t0 − t1 = d  (15 linear equations, 6 unknowns)
    a_rows, b_rows = [], []
    for k in range(2):
        a_rows.append(np.concatenate(
            [np.zeros((3, 3)), _hat(r0[:, k])], axis=1))
        b_rows.append(g[:, k, 2])
    for l in range(2):
        a_rows.append(np.concatenate(
            [-_hat(r1[:, l]), np.zeros((3, 3))], axis=1))
        b_rows.append(g[:, 2, l])
    a_rows.append(np.concatenate([np.eye(3), -np.eye(3)], axis=1))
    b_rows.append(d)
    t_sol, *_ = np.linalg.lstsq(
        np.concatenate(a_rows), np.concatenate(b_rows), rcond=None
    )
    t0n, t1n = t_sol[:3], t_sol[3:]

    mean3 = np.array([mean[0], mean[1], 0.0])

    def denorm(r, t):
        return r, t / nf + mean3 - r @ mean3

    # Mirror candidate: reflect through the pattern plane.  Only the first
    # two rotation columns are observable (planar target); the mirror's
    # third column comes from re-completing the FLIPPED columns by cross
    # product (F·R itself would be a reflection, det −1).
    flip = np.diag([1.0, 1.0, -1.0])
    candidates = []
    for fr in (np.eye(3), flip):
        rr0, tt0 = denorm(_procrustes_rotation(fr @ r0_cols), fr @ t0n)
        rr1, tt1 = denorm(_procrustes_rotation(fr @ r1_cols), fr @ t1n)
        candidates.append({"r0": rr0, "t0": tt0, "r1": rr1, "t1": tt1})
    ok = (
        resid < 5e-2
        and all(np.isfinite(c["t0"]).all() and np.isfinite(c["t1"]).all()
                for c in candidates)
    )
    return {"ok": bool(ok), "candidates": candidates, "residual": resid}

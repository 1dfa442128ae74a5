"""Quaternion / SE(3) utilities on tensors.

Quaternions are stored as (w, x, y, z).  An SE(3) transform is the pair
(q, t) acting as ``x -> R(q) x + t``.  All functions broadcast over leading
batch dimensions and follow the device and dtype of their inputs.
"""

from __future__ import annotations

import functools

import torch


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


# quat_mul's terms: component c is t[c][0] + t[c][1] + t[c][2] + t[c][3]
# (summed in that order) with t[c][k] = SIGN[c][k] · a_i·b_j at the flat
# outer-product index 4·i + j in IDX[c][k]:
#   w = aw·bw − ax·bx − ay·by − az·bz,
#   x = aw·bx + ax·bw + ay·bz − az·by,
#   y = aw·by − ax·bz + ay·bw + az·bx,
#   z = aw·bz + ax·by − ay·bx + az·bw.
_QMUL_IDX = ((0, 5, 10, 15), (1, 4, 11, 14), (2, 7, 8, 13), (3, 6, 9, 12))
_QMUL_SIGN = ((1, -1, -1, -1), (1, 1, 1, -1), (1, -1, 1, 1), (1, 1, -1, 1))


@functools.lru_cache(maxsize=None)
def _qmul_consts(device, dtype):
    """quat_mul's gather indices and signs and quat_conj's signs, built
    once per (device, dtype): on the card a fresh tensor per call would
    be a host-to-device copy on every LM step."""
    return (torch.tensor(_QMUL_IDX, device=device),
            torch.tensor(_QMUL_SIGN, dtype=dtype, device=device),
            torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=dtype, device=device))


def quat_mul(a, b):
    """Hamilton product a*b for (..., 4) (w, x, y, z) quaternions.

    Computed on whole vectors (one outer product, one gather) rather than
    per component, which keeps forward-mode AD cheap; the sums run in the
    written order, so the result is that of the component formulas bit
    for bit."""
    a, b = torch.broadcast_tensors(a, b)
    p = (a[..., :, None] * b[..., None, :]).reshape(a.shape[:-1] + (16,))
    idx, sign, _ = _qmul_consts(a.device, a.dtype)
    t = p[..., idx] * sign
    return ((t[..., 0] + t[..., 1]) + t[..., 2]) + t[..., 3]


def quat_conj(q):
    return q * _qmul_consts(q.device, q.dtype)[2]


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    # v + 2 w (u x v) + 2 (u x (u x v))
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def se3_compose(qa, ta, qb, tb):
    """(qa, ta) ∘ (qb, tb): first apply b, then a."""
    return quat_mul(qa, qb), quat_rotate(qa, tb) + ta


def se3_inverse(q, t):
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def quat_to_matrix(q):
    """(..., 4) -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_exp(u):
    """Exp map: tangent (..., 3) -> unit quaternion rotating by angle |u|.

    R(quat_exp(u)) = exp([u]_x); the small-angle branch uses the Taylor
    series so u = 0 is exact.
    """
    sq = torch.sum(u * u, dim=-1, keepdim=True)
    small = sq < 1e-16
    sq_safe = torch.where(small, torch.ones_like(sq), sq)
    angle = torch.sqrt(sq_safe)
    half = 0.5 * angle
    k = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    return torch.cat([w, k * u], dim=-1)


def retract_pose(q, t, delta):
    """Left-multiplicative local update of an SE(3) pose.

    delta: (..., 6) = (rotation tangent, translation delta).
    """
    dq = quat_exp(delta[..., 0:3])
    return quat_mul(dq, q), t + delta[..., 3:6]


def _matrix_to_quat_candidates(m, stack):
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw = stack([1 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01])
    qx = stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20])
    qy = stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21])
    qz = stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22])
    scores = stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                    1 - m00 + m11 - m22, 1 - m00 - m11 + m22])
    return (qw, qx, qy, qz), scores


def matrix_to_quat(m):
    """(..., 3, 3) -> (..., 4) (w, x, y, z): of the four constructions,
    the one with the largest diagonal score (Shepperd's method)."""
    cands, scores = _matrix_to_quat_candidates(
        m, lambda xs: torch.stack(xs, dim=-1))
    cands = torch.stack(cands, dim=-2)  # (..., 4, 4)
    best = torch.argmax(scores, dim=-1)
    q = torch.take_along_dim(cands, best[..., None, None].expand(
        best.shape + (1, 4)), dim=-2)[..., 0, :]
    return quat_normalize(q)


def matrix_to_quat_np(m):
    """NumPy version of :func:`matrix_to_quat` for the host loops that
    convert poses one at a time."""
    import numpy as np

    m = np.asarray(m, np.float64)
    cands, scores = _matrix_to_quat_candidates(
        m, lambda xs: np.stack(xs, -1))
    cands = np.stack(cands, axis=-2)
    best = np.argmax(scores, axis=-1)
    q = np.take_along_axis(
        cands, best[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def average_se3(qs, ts, weights=None):
    """Average of SE(3) poses (N, 4), (N, 3): the chordal mean rotation
    (the mean matrix projected onto SO(3) by SVD) and the mean
    translation."""
    if weights is None:
        weights = torch.ones(qs.shape[0], dtype=ts.dtype, device=ts.device)
    w = weights / torch.sum(weights)
    mean_m = torch.einsum("n,nij->ij", w, quat_to_matrix(qs))
    u, _, vt = torch.linalg.svd(mean_m)
    det = torch.linalg.det(u @ vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det])
    r = u @ torch.diag(d) @ vt
    mean_t = torch.einsum("n,ni->i", w, ts)
    return matrix_to_quat(r), mean_t

"""Quaternion / SE(3) utilities on tensors.

Quaternions are stored as (w, x, y, z).  An SE(3) transform is the pair
(q, t) acting as ``x -> R(q) x + t``.  All functions broadcast over leading
batch dimensions and follow the device and dtype of their inputs.
"""

from __future__ import annotations

import torch


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_mul(a, b):
    """Hamilton product a*b for (..., 4) (w, x, y, z) quaternions."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


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

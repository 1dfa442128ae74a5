"""Closed-form small dense linear algebra for the solvers.

Batched 2×2 / 3×3 / 6×6 solves and inverses written out element by element
(no LAPACK call per block); singular blocks give 0, as in the reference
package.
"""

from __future__ import annotations

import torch


def _safe_inv_det(det):
    safe = torch.abs(det) > 1e-30
    return torch.where(safe, 1.0 / torch.where(safe, det, torch.ones_like(det)),
                       torch.zeros_like(det))


def solve2x2(a, b):
    """Solve a @ x = b for (..., 2, 2), (..., 2); 0 on singular."""
    det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    inv_det = _safe_inv_det(det)
    x0 = (a[..., 1, 1] * b[..., 0] - a[..., 0, 1] * b[..., 1]) * inv_det
    x1 = (a[..., 0, 0] * b[..., 1] - a[..., 1, 0] * b[..., 0]) * inv_det
    return torch.stack([x0, x1], dim=-1)


def inv_2x2(a):
    """Closed-form batched (..., 2, 2) inverse (0 on singular)."""
    det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    inv_det = _safe_inv_det(det)
    row0 = torch.stack([a[..., 1, 1], -a[..., 0, 1]], dim=-1)
    row1 = torch.stack([-a[..., 1, 0], a[..., 0, 0]], dim=-1)
    return torch.stack([row0, row1], dim=-2) * inv_det[..., None, None]


def inv_3x3(a):
    """Closed-form batched (..., 3, 3) inverse via the adjugate."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    inv_det = _safe_inv_det(det)
    adj = torch.stack(
        [
            torch.stack(
                [
                    c00,
                    a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2],
                    a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1],
                ],
                dim=-1,
            ),
            torch.stack(
                [
                    c01,
                    a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0],
                    a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2],
                ],
                dim=-1,
            ),
            torch.stack(
                [
                    c02,
                    a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1],
                    a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0],
                ],
                dim=-1,
            ),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def inv_spd_6x6(a):
    """Batched (..., 6, 6) SPD inverse by 3×3 block elimination.

    inv([[A, B], [Bᵀ, C]]) with S = C − Bᵀ A⁻¹ B.
    """
    a11 = a[..., :3, :3]
    b = a[..., :3, 3:]
    c = a[..., 3:, 3:]
    a11_inv = inv_3x3(a11)
    a_inv_b = torch.einsum("...ij,...jk->...ik", a11_inv, b)
    s = c - torch.einsum("...ji,...jk->...ik", b, a_inv_b)
    s_inv = inv_3x3(s)
    tr = -torch.einsum("...ij,...jk->...ik", a_inv_b, s_inv)
    tl = a11_inv - torch.einsum("...ij,...kj->...ik", tr, a_inv_b)
    bl = tr.transpose(-1, -2)
    top = torch.cat([tl, tr], dim=-1)
    bot = torch.cat([bl, s_inv], dim=-1)
    return torch.cat([top, bot], dim=-2)


def inv_spd_blocks(a):
    """Batched SPD inverse for the block sizes the BA solvers use."""
    k = a.shape[-1]
    if k == 2:
        return inv_2x2(a)
    if k == 3:
        return inv_3x3(a)
    if k == 6:
        return inv_spd_6x6(a)
    return torch.linalg.inv(a)

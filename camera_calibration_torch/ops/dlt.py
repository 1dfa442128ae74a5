"""Homography estimation by the normalized DLT algorithm.

The counterpart of the reference package's ``ops/dlt.py``: isotropic
Hartley normalization of both point sets, the null vector of the stacked
2N×9 system (the eigenvector of AᵀA with the smallest eigenvalue), and
de-normalization.  Batch-first: any leading dimensions, with per-row
weights (0/1 masks) for padded or subset correspondences.
"""

from __future__ import annotations

import math

import torch


def _normalization(pts, w):
    """Centroid (..., 2) and isotropic scale (...) of weighted points
    (..., N, 2), (..., N)."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    centroid = torch.sum(pts * w[..., None], dim=-2) / wsum[..., None]
    d = torch.linalg.vector_norm(pts - centroid[..., None, :], dim=-1)
    mean_dist = torch.sum(d * w, dim=-1) / wsum
    return centroid, math.sqrt(2.0) / torch.clamp(mean_dist, min=1e-12)


def homography_dlt(src, dst, weights=None):
    """H (..., 3, 3) with dst ~ H·src from (..., N, 2) correspondences.

    ``weights``: optional (..., N) nonnegative row weights (≥ 4 effective
    correspondences needed).  H is scaled to ‖H‖_F = 1 with a positive last
    element.
    """
    w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device) \
        if weights is None else weights.to(src.dtype)
    c_s, s_s = _normalization(src, w)
    c_d, s_d = _normalization(dst, w)
    sn = (src - c_s[..., None, :]) * s_s[..., None, None]
    dn = (dst - c_d[..., None, :]) * s_d[..., None, None]
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1)
    a = torch.cat([r1, r2], dim=-2)
    a = a * torch.sqrt(torch.cat([w, w], dim=-1))[..., None]
    ata = a.transpose(-1, -2) @ a
    _, vecs = torch.linalg.eigh(ata)
    hn = vecs[..., :, 0].reshape(*vecs.shape[:-2], 3, 3)
    zeros = torch.zeros_like(s_s)
    ones = torch.ones_like(s_s)
    t_s = torch.stack([
        torch.stack([s_s, zeros, -s_s * c_s[..., 0]], -1),
        torch.stack([zeros, s_s, -s_s * c_s[..., 1]], -1),
        torch.stack([zeros, zeros, ones], -1)], -2)
    t_d_inv = torch.stack([
        torch.stack([1.0 / s_d, zeros, c_d[..., 0]], -1),
        torch.stack([zeros, 1.0 / s_d, c_d[..., 1]], -1),
        torch.stack([zeros, zeros, ones], -1)], -2)
    hh = t_d_inv @ hn @ t_s
    hh = hh / torch.linalg.matrix_norm(hh)[..., None, None]
    return hh * torch.sign(hh[..., 2:3, 2:3] + 1e-30)


def apply_homography(h, pts):
    """Apply H (3, 3) to points (..., 2)."""
    p = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    q = p @ h.transpose(-1, -2)
    return q[..., :2] / q[..., 2:3]

"""Unit-direction retractions (local parametrizations) on tensors.

Tangent frame: ``t1 = normalize(d × e)`` with ``e = (0,1,0)`` if
``|d.x| > 0.9`` else ``(1,0,0)``; ``t2 = d × t1``.  Retraction:
``d' = normalize(d + δ1·t1 + δ2·t2)``.
"""

from __future__ import annotations

import torch

from camera_calibration_torch.ops.se3 import _cross


def direction_tangents(d):
    """Tangent frame (t1, t2) of unit direction(s) d (..., 3)."""
    use_y = torch.abs(d[..., 0]) > 0.9
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=d.dtype, device=d.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=d.dtype, device=d.device)
    e = torch.where(use_y[..., None], ey, ex)
    t1 = _cross(d, e)
    t1 = t1 / torch.linalg.vector_norm(t1, dim=-1, keepdim=True)
    t2 = _cross(d, t1)  # already unit length for unit d
    return t1, t2


def retract_direction(d, delta):
    """Retract unit direction(s) by a 2-DoF tangent delta (..., 2)."""
    t1, t2 = direction_tangents(d)
    nd = d + delta[..., 0:1] * t1 + delta[..., 1:2] * t2
    return nd / torch.linalg.vector_norm(nd, dim=-1, keepdim=True)

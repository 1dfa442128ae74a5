"""Functional dispatch over camera-model families.

The grid models are ported: CentralGeneric (2 DoF per knot, its direction's
tangent plane) and NoncentralGeneric (5 DoF per knot: 2 for the direction,
3 for the line origin).  The parametric models raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import torch

from camera_calibration_torch.models import central_generic as cg
from camera_calibration_torch.models import noncentral_generic as ncg
from camera_calibration_torch.models.base import replace
from camera_calibration_torch.ops import manifolds

GRID_MODELS = (cg.CentralGenericModel, ncg.NoncentralGenericModel)


def require_supported(model) -> None:
    if not isinstance(model, GRID_MODELS):
        raise NotImplementedError(
            f"camera model {type(model).__name__} is not ported yet: only "
            "the grid models CentralGeneric and NoncentralGeneric are "
            "(ROADMAP.md queue 1, item 12: the parametric models)"
        )


def is_grid_model(model) -> bool:
    return isinstance(model, GRID_MODELS)


def intrinsics_tangent_zero(model):
    require_supported(model)
    if isinstance(model, ncg.NoncentralGenericModel):
        g = model.direction_grid
        return torch.zeros(g.shape[:2] + (5,), dtype=g.dtype, device=g.device)
    return torch.zeros(model.grid.shape[:2] + (2,), dtype=model.grid.dtype,
                       device=model.grid.device)


def intrinsics_retract(model, tangent, scale=1.0):
    require_supported(model)
    if isinstance(model, ncg.NoncentralGenericModel):
        return replace(
            model,
            direction_grid=manifolds.retract_direction(
                model.direction_grid, scale * tangent[..., 0:2]),
            point_grid=model.point_grid + scale * tangent[..., 2:5],
        )
    return replace(
        model, grid=manifolds.retract_direction(model.grid, scale * tangent)
    )


def project_points(model, x_cam, init_xy=None, max_iterations=10):
    """(pixels, grid coords, valid)."""
    require_supported(model)
    project = (ncg.project_points
               if isinstance(model, ncg.NoncentralGenericModel)
               else cg.project_points)
    return project(model, x_cam, init_xy=init_xy,
                   max_iterations=max_iterations)


def unproject(model, pixels):
    """(unit directions, valid): the line directions of a noncentral
    model."""
    require_supported(model)
    if isinstance(model, ncg.NoncentralGenericModel):
        d, _, valid = ncg.unproject(model, pixels)
        return d, valid
    return cg.unproject(model, pixels)

"""Functional dispatch over camera-model families.

This slice ports the CentralGeneric grid model only; every other family
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import torch

from camera_calibration_torch.models import central_generic as cg
from camera_calibration_torch.models.base import replace
from camera_calibration_torch.ops import manifolds

GRID_MODELS = (cg.CentralGenericModel,)


def require_supported(model) -> None:
    if not isinstance(model, cg.CentralGenericModel):
        raise NotImplementedError(
            f"camera model {type(model).__name__} is not ported yet: only "
            "CentralGeneric is (ROADMAP.md queue 1, items 11 and 12: "
            "NoncentralGeneric and the parametric models)"
        )


def is_grid_model(model) -> bool:
    return isinstance(model, GRID_MODELS)


def intrinsics_tangent_zero(model):
    require_supported(model)
    return torch.zeros(model.grid.shape[:2] + (2,), dtype=model.grid.dtype,
                       device=model.grid.device)


def intrinsics_retract(model, tangent, scale=1.0):
    require_supported(model)
    return replace(
        model, grid=manifolds.retract_direction(model.grid, scale * tangent)
    )


def project_points(model, x_cam, init_xy=None, max_iterations=10):
    """(pixels, grid coords, valid)."""
    require_supported(model)
    return cg.project_points(
        model, x_cam, init_xy=init_xy, max_iterations=max_iterations
    )

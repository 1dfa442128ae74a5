"""Functional dispatch over camera-model families.

Two intrinsics families exist for optimization purposes:

- *grid* models (CentralGeneric, NoncentralGeneric): the intrinsics tangent
  is a per-knot field of 2 DoF (the direction's tangent plane) or 5 DoF
  (and the line origin); Jacobians are sparse 4×4-window blocks;
- *parametric* models (ThinPrismFisheye, OpenCV, Radial): the intrinsics
  tangent is the parameter vector; Jacobians are dense (2, P) blocks.
"""

from __future__ import annotations

import torch

from camera_calibration_torch.models import central_generic as cg
from camera_calibration_torch.models import noncentral_generic as ncg
from camera_calibration_torch.models import noncentral_generic_cuda as ncgc
from camera_calibration_torch.models import parametric as pm
from camera_calibration_torch.models.base import replace
from camera_calibration_torch.ops import manifolds

GRID_MODELS = (cg.CentralGenericModel, ncg.NoncentralGenericModel)
PARAMETRIC_MODELS = pm.MODELS


def require_supported(model) -> None:
    if not isinstance(model, GRID_MODELS + PARAMETRIC_MODELS):
        raise TypeError(f"{type(model).__name__} is not a camera model")


def is_grid_model(model) -> bool:
    return isinstance(model, GRID_MODELS)


def model_tensor(model):
    """A tensor of the model: its device and float type are the model's."""
    for name in ("grid", "direction_grid", "params"):
        if hasattr(model, name):
            return getattr(model, name)
    raise TypeError(f"not a camera model: {type(model).__name__}")


def intrinsics_tangent_zero(model):
    require_supported(model)
    if isinstance(model, ncg.NoncentralGenericModel):
        g = model.direction_grid
        return torch.zeros(g.shape[:2] + (5,), dtype=g.dtype, device=g.device)
    if is_grid_model(model):
        return torch.zeros(model.grid.shape[:2] + (2,),
                           dtype=model.grid.dtype, device=model.grid.device)
    return torch.zeros_like(model.params)


def intrinsics_retract(model, tangent, scale=1.0):
    require_supported(model)
    if isinstance(model, ncg.NoncentralGenericModel):
        return replace(
            model,
            direction_grid=manifolds.retract_direction(
                model.direction_grid, scale * tangent[..., 0:2]),
            point_grid=model.point_grid + scale * tangent[..., 2:5],
        )
    if is_grid_model(model):
        return replace(
            model, grid=manifolds.retract_direction(model.grid,
                                                    scale * tangent))
    return replace(model, params=model.params + scale * tangent)


def project_points(model, x_cam, init_xy=None, max_iterations=10):
    """(pixels, aux, valid): aux is the grid coords of a grid model, the
    pixels of a parametric one.  A noncentral model's loop runs in one
    kernel on the card (``noncentral_generic_cuda``)."""
    require_supported(model)
    if isinstance(model, ncg.NoncentralGenericModel):
        return ncgc.project_points(
            model, x_cam.contiguous(),
            init_xy=None if init_xy is None else init_xy.contiguous(),
            max_iterations=max_iterations)
    if is_grid_model(model):
        return cg.project_points(model, x_cam, init_xy=init_xy,
                                 max_iterations=max_iterations)
    return pm.project_points(model, x_cam)


def unproject(model, pixels, max_iterations=20):
    """(unit directions, valid): the line directions of a noncentral
    model.  ``max_iterations`` is the parametric models' Gauss-Newton
    count."""
    require_supported(model)
    if isinstance(model, ncg.NoncentralGenericModel):
        d, _, valid = ncg.unproject(model, pixels)
        return d, valid
    if is_grid_model(model):
        return cg.unproject(model, pixels)
    return pm.unproject(model, pixels, max_iterations=max_iterations)


def projection_point_jacobian(model, x_cam, aux):
    """d pixel / d camera-space point at a converged projection, (N, 2, 3).

    ``aux``: the second output of :func:`project_points` (grid coords of a
    grid model; unused for a parametric one).  The noncentral model
    raises: its stereo path is not defined.
    """
    require_supported(model)
    if isinstance(model, ncg.NoncentralGenericModel):
        raise NotImplementedError(
            "projection_point_jacobian: fit a central model (stereo is "
            "defined for central models only)")
    if is_grid_model(model):
        p = cg.projection_sensitivities(model, aux)["pix_wrt_dir"]
        norm = torch.linalg.vector_norm(x_cam, dim=-1, keepdim=True)
        d = x_cam / torch.clamp_min(norm, 1e-18)
        pd = torch.einsum("nij,nj->ni", p, d)
        return (p - pd[..., None] * d[:, None, :]) / torch.clamp_min(
            norm[..., None], 1e-18)

    def f(x):
        return pm.project_points(model, x[None])[0][0]

    return torch.func.vmap(torch.func.jacfwd(f))(x_cam)

"""CentralGeneric camera model: a B-spline grid of unit observation directions.

- ``unproject(pixel)`` is the normalized bicubic B-spline interpolation of a
  (Hg, Wg) grid of unit directions.
- ``project(direction)`` inverts unprojection with a per-point damped 2-DoF
  Levenberg-Marquardt loop from a warm start; test states are clamped to the
  calibrated area and λ is halved on accept and doubled on reject.  The loop
  runs in one kernel on the card (``central_generic_cuda``).
- Grid ↔ pixel mapping keeps a 1-cell border: grid coordinate
  ``1 + (W-3)·(px-min_x)/(max_x+1-min_x)``.
- Projection Jacobians come from the implicit-function theorem at the
  converged projection, in closed form.
"""

from __future__ import annotations

import dataclasses

import torch

from camera_calibration_torch.models import central_generic_cuda as cgc
from camera_calibration_torch.ops import bspline


@dataclasses.dataclass(frozen=True)
class CentralGenericModel:
    # (Hg, Wg, 3) unit directions; y-major (row = grid y).
    grid: torch.Tensor
    width: int = 0
    height: int = 0
    calibration_min_x: int = 0
    calibration_min_y: int = 0
    calibration_max_x: int = 0  # inclusive
    calibration_max_y: int = 0

    @property
    def grid_height(self):
        return self.grid.shape[0]

    @property
    def grid_width(self):
        return self.grid.shape[1]


def _extent(model):
    ex = model.calibration_max_x + 1 - model.calibration_min_x
    ey = model.calibration_max_y + 1 - model.calibration_min_y
    return ex, ey


def pixel_to_grid(model: CentralGenericModel, xy):
    """Pixel-corner coords (..., 2) -> continuous grid coords (..., 2)."""
    ex, ey = _extent(model)
    gx = 1.0 + (model.grid_width - 3.0) * (xy[..., 0] - model.calibration_min_x) / ex
    gy = 1.0 + (model.grid_height - 3.0) * (xy[..., 1] - model.calibration_min_y) / ey
    return torch.stack([gx, gy], dim=-1)


def grid_to_pixel(model: CentralGenericModel, gxy):
    """Inverse of pixel_to_grid."""
    ex, ey = _extent(model)
    px = model.calibration_min_x + (gxy[..., 0] - 1.0) / (model.grid_width - 3.0) * ex
    py = model.calibration_min_y + (gxy[..., 1] - 1.0) / (model.grid_height - 3.0) * ey
    return torch.stack([px, py], dim=-1)


def pixel_scale_to_grid_scale(model: CentralGenericModel):
    """(sx, sy) with grid_delta = s · pixel_delta."""
    ex, ey = _extent(model)
    return ((model.grid_width - 3.0) / ex, (model.grid_height - 3.0) / ey)


def is_in_calibrated_area(model: CentralGenericModel, xy):
    return (
        (xy[..., 0] >= model.calibration_min_x)
        & (xy[..., 0] < model.calibration_max_x + 1)
        & (xy[..., 1] >= model.calibration_min_y)
        & (xy[..., 1] < model.calibration_max_y + 1)
    )


def unproject_grid_coords(model: CentralGenericModel, gxy):
    """Unit direction at continuous grid coords (..., 2)."""
    u = bspline.eval_surface(model.grid, gxy.reshape(-1, 2))
    un = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    return un.reshape(gxy.shape[:-1] + (3,))


def unproject(model: CentralGenericModel, xy):
    """Unproject pixel-corner coords (..., 2) -> (unit dirs (..., 3), valid)."""
    dirs = unproject_grid_coords(model, pixel_to_grid(model, xy))
    return dirs, is_in_calibrated_area(model, xy)


def _static_clamp_bounds(model: CentralGenericModel):
    """Clamp range (lo, hi) of the projection test state in grid coords, as
    Python floats (pixels clamped to [min, max + 0.999])."""
    ex, ey = _extent(model)
    gw, gh = model.grid_width, model.grid_height

    def gx(px):
        return 1.0 + (gw - 3.0) * (px - model.calibration_min_x) / ex

    def gy(py):
        return 1.0 + (gh - 3.0) * (py - model.calibration_min_y) / ey

    lo = (gx(model.calibration_min_x), gy(model.calibration_min_y))
    hi = (gx(model.calibration_max_x + 0.999),
          gy(model.calibration_max_y + 0.999))
    return lo, hi


def _grid_clamp_bounds(model: CentralGenericModel):
    """The same clamp range as tensors of the grid's dtype and device."""
    dev, dtype = model.grid.device, model.grid.dtype
    lo = pixel_to_grid(model, torch.tensor(
        [model.calibration_min_x, model.calibration_min_y], dtype=dtype,
        device=dev))
    hi = pixel_to_grid(model, torch.tensor(
        [model.calibration_max_x + 0.999, model.calibration_max_y + 0.999],
        dtype=dtype, device=dev))
    return lo, hi


def default_eps(dtype) -> float:
    """Projection convergence threshold on the squared direction error."""
    return 1e-12 if dtype == torch.float64 else 1e-10


def project_directions(
    model: CentralGenericModel,
    dirs,
    init_xy=None,
    max_iterations: int = 50,
    eps: float | None = None,
):
    """Batched projection of unit directions (N, 3) -> pixel-corner (N, 2).

    Returns (pixel_xy, grid_xy, valid); ``init_xy`` are warm-start pixels
    (default: the calibrated-area center).  A projection is valid when the
    squared direction error is below 1e4·eps.
    """
    dtype = model.grid.dtype
    dirs = dirs.to(dtype)
    n = dirs.shape[0]
    if eps is None:
        eps = default_eps(dtype)
    if init_xy is None:
        center = torch.tensor(
            [0.5 * (model.calibration_min_x + model.calibration_max_x + 1),
             0.5 * (model.calibration_min_y + model.calibration_max_y + 1)],
            dtype=dtype, device=dirs.device)
        init_xy = center.expand(n, 2)
    g0 = pixel_to_grid(model, init_xy.to(dtype))
    lo, hi = _static_clamp_bounds(model)
    g, final_cost = cgc.project_grid_coords(
        model.grid, dirs.contiguous(), g0.contiguous(), lo, hi,
        int(max_iterations), float(eps))
    valid = final_cost < 1e4 * eps
    return grid_to_pixel(model, g), g, valid


def project_points(model: CentralGenericModel, points, init_xy=None, **kw):
    """Project camera-space 3D points (N, 3); normalizes then projects."""
    norms = torch.linalg.vector_norm(points, dim=-1, keepdim=True)
    dirs = points / torch.clamp_min(norms, 1e-18)
    px, g, valid = project_directions(model, dirs, init_xy=init_xy, **kw)
    return px, g, valid & (norms[..., 0] > 1e-12)


def projection_sensitivities(model: CentralGenericModel, g_star):
    """Exact derivatives of the projection at converged grid coords g*.

    Implicit-function theorem at the projection optimum:
    dg = (UᵀU)⁻¹ Uᵀ (dd − dun_θ) with U = ∂un/∂g.  Returns a dict with
    ``pix_wrt_dir`` (N, 2, 3), ``pn`` (N, 2, 3) (d pixel / d ambient knot k
    is ``-w_k · pn``), ``weights`` (N, 4, 4) [y, x] and ``base_xy`` (N, 2).
    """
    sx, sy = pixel_scale_to_grid_scale(model)
    p_px, pn, weights, base = cgc.sensitivities_plain(
        model.grid, g_star, (1.0 / sx, 1.0 / sy))
    return {"pix_wrt_dir": p_px, "pn": pn, "weights": weights,
            "base_xy": base}

"""NoncentralGeneric camera model: an observation line per pixel.

Two B-spline grids over the image, a grid of unit directions and a grid of
line origins (camera-frame meters), define a 3D line at every pixel:
``unproject`` gives its (normalized direction, origin).  Projection finds
the pixel whose line passes through a point by a batched 2-DoF
Levenberg-Marquardt loop on the point-to-line offset.  Each grid knot has
5 DoF in bundle adjustment: 2 for its direction's tangent plane, 3 for its
origin.  The model is initialized from a central one (same directions,
zero origins).

The projection's sensitivities come from the implicit-function theorem at
the converged pixel, on the window pinned at the converged grid
coordinates, in closed form.  The reference package computes the same
derivatives by forward-mode AD (``models/noncentral_generic.py`` there);
it has no kernel for this model's projection.  Everything here is plain
PyTorch, batched over points; on the card the projection loop runs in one
kernel instead (``noncentral_generic_cuda``), and :func:`project_points`
is its reference and the CPU's path.
"""

from __future__ import annotations

import dataclasses

import torch

from camera_calibration_torch import tracing
from camera_calibration_torch.ops import bspline, manifolds
from camera_calibration_torch.ops.linalg import solve2x2


@dataclasses.dataclass(frozen=True)
class NoncentralGenericModel:
    direction_grid: torch.Tensor  # (Hg, Wg, 3) unit directions
    point_grid: torch.Tensor  # (Hg, Wg, 3) line origins
    width: int = 0
    height: int = 0
    calibration_min_x: int = 0
    calibration_min_y: int = 0
    calibration_max_x: int = 0  # inclusive
    calibration_max_y: int = 0

    @property
    def grid_height(self):
        return self.direction_grid.shape[0]

    @property
    def grid_width(self):
        return self.direction_grid.shape[1]

    @property
    def is_central(self):
        return False


def from_central(central_model) -> NoncentralGenericModel:
    """The noncentral model of a central one: its directions, zero origins."""
    return NoncentralGenericModel(
        direction_grid=central_model.grid,
        point_grid=torch.zeros_like(central_model.grid),
        width=central_model.width,
        height=central_model.height,
        calibration_min_x=central_model.calibration_min_x,
        calibration_min_y=central_model.calibration_min_y,
        calibration_max_x=central_model.calibration_max_x,
        calibration_max_y=central_model.calibration_max_y,
    )


def _extent(model):
    return (model.calibration_max_x + 1 - model.calibration_min_x,
            model.calibration_max_y + 1 - model.calibration_min_y)


def pixel_to_grid(model, xy):
    """Pixel-corner coords (..., 2) -> continuous grid coords (..., 2)."""
    ex, ey = _extent(model)
    gx = 1.0 + (model.grid_width - 3.0) * (xy[..., 0] - model.calibration_min_x) / ex
    gy = 1.0 + (model.grid_height - 3.0) * (xy[..., 1] - model.calibration_min_y) / ey
    return torch.stack([gx, gy], dim=-1)


def grid_to_pixel(model, gxy):
    """Inverse of pixel_to_grid."""
    ex, ey = _extent(model)
    px = model.calibration_min_x + (gxy[..., 0] - 1.0) / (model.grid_width - 3.0) * ex
    py = model.calibration_min_y + (gxy[..., 1] - 1.0) / (model.grid_height - 3.0) * ey
    return torch.stack([px, py], dim=-1)


def is_in_calibrated_area(model, xy):
    return ((xy[..., 0] >= model.calibration_min_x)
            & (xy[..., 0] < model.calibration_max_x + 1)
            & (xy[..., 1] >= model.calibration_min_y)
            & (xy[..., 1] < model.calibration_max_y + 1))


def _grids(model):
    """Both grids side by side, (Hg, Wg, 6): one window gather serves both."""
    return torch.cat([model.direction_grid, model.point_grid], dim=-1)


def _lines(model, g, derivatives=False):
    """Raw direction u, origin o (N, 3) at grid coords g (N, 2); with
    ``derivatives`` also du/dg and do/dg (N, 3, 2)."""
    win, bx, by = bspline.gather_window_2d(_grids(model), g)
    if not derivatives:
        val = bspline.eval_window_fixed_base(win, bx, by, g)
        return val[:, :3], val[:, 3:]
    wx, wy, dwx, dwy = bspline.fixed_base_weights(bx, by, g, derivative=True)
    rows = torch.einsum("ny,nyxc->nxc", wy, win)
    drows = torch.einsum("ny,nyxc->nxc", dwy, win)
    val = torch.einsum("nx,nxc->nc", wx, rows)
    dval = torch.stack([torch.einsum("nx,nxc->nc", dwx, rows),
                        torch.einsum("nx,nxc->nc", wx, drows)], dim=-1)
    return val[:, :3], val[:, 3:], dval[:, :3], dval[:, 3:]


def unproject(model, xy):
    """Pixel-corner coords (..., 2) -> (unit directions, origins, valid)."""
    g = pixel_to_grid(model, xy).reshape(-1, 2)
    u, o = _lines(model, g)
    d = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    shape = xy.shape[:-1] + (3,)
    return d.reshape(shape), o.reshape(shape), is_in_calibrated_area(model, xy)


def _offset(u, o, x):
    """Perpendicular offset of x from the line (o, u/|u|), the unit
    direction d and v = x − o."""
    d = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    v = x - o
    vd = torch.sum(v * d, dim=-1, keepdim=True)
    return v - vd * d, d, v, vd


def _offset_jacobians(u, d, v, vd):
    """d offset / d u and d offset / d o, (N, 3, 3) each: with P = I − d dᵀ,
    d offset/d u = −(d vᵀ + (v·d) I) P / |u| and d offset/d o = −P."""
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    proj = eye - d[:, :, None] * d[:, None, :]
    norm = torch.linalg.vector_norm(u, dim=-1)[:, None, None]
    d_u = -(d[:, :, None] * v[:, None, :] + vd[:, :, None] * eye) @ proj / norm
    return d_u, -proj


def _residual_and_jac(model, g, x):
    """Offsets (N, 3) at grid coords g and their Jacobian wrt g (N, 3, 2)."""
    u, o, du, do = _lines(model, g, derivatives=True)
    r, d, v, vd = _offset(u, o, x)
    d_u, d_o = _offset_jacobians(u, d, v, vd)
    return r, d_u @ du + d_o @ do


def _cost_at(model, g, x):
    u, o = _lines(model, g)
    r = _offset(u, o, x)[0]
    return torch.sum(r * r, dim=-1)


def project_points(model: NoncentralGenericModel, points, init_xy=None,
                   max_iterations: int = 50, eps: float | None = None):
    """Batched projection: the pixel whose line passes through each point
    (N, 3), by damped 2-DoF LM on the point-to-line offset (reference
    package ``noncentral_generic.py:123-200``).  Returns (pixel_xy,
    grid_xy, valid); valid where the offset is below 1e-4 of the point's
    distance."""
    dtype = model.direction_grid.dtype
    dev = model.direction_grid.device
    points = points.to(dtype)
    n = points.shape[0]
    if eps is None:
        eps = 1e-16 if dtype == torch.float64 else 1e-10
    if init_xy is None:
        center = torch.tensor(
            [0.5 * (model.calibration_min_x + model.calibration_max_x + 1),
             0.5 * (model.calibration_min_y + model.calibration_max_y + 1)],
            dtype=dtype, device=dev)
        init_xy = center.expand(n, 2)
    g = pixel_to_grid(model, init_xy.to(dtype))
    lo = pixel_to_grid(model, torch.tensor(
        [model.calibration_min_x, model.calibration_min_y], dtype=dtype,
        device=dev))
    hi = pixel_to_grid(model, torch.tensor(
        [model.calibration_max_x + 0.999, model.calibration_max_y + 0.999],
        dtype=dtype, device=dev))
    eye = torch.eye(2, dtype=dtype, device=dev)
    lam = torch.full((n,), -1.0, dtype=dtype, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    it = 0
    # the loop test reads ``done`` on the host once per iteration
    while (it < max_iterations
           and not tracing.read("ncg.project", done.all())):
        r, jac = _residual_and_jac(model, g, points)
        cost = torch.sum(r * r, dim=-1)
        h = jac.transpose(1, 2) @ jac
        b = torch.einsum("nik,ni->nk", jac, r)
        lam = torch.where(lam < 0, 0.01 * 0.5 * (h[:, 0, 0] + h[:, 1, 1]), lam)
        step = solve2x2(h + lam[:, None, None] * eye, b)
        g_test = torch.clamp(g - step, lo, hi)
        accept = (_cost_at(model, g_test, points) < cost) & ~done
        g = torch.where(accept[:, None], g_test, g)
        lam = torch.where(accept, 0.5 * lam, 2.0 * lam)
        done = done | (cost < eps)
        it += 1
    final_cost = _cost_at(model, g, points)
    scale = torch.clamp_min(torch.linalg.vector_norm(points, dim=-1), 1e-6)
    valid = torch.sqrt(final_cost) < 1e-4 * scale
    return grid_to_pixel(model, g), g, valid


def projection_blocks(model: NoncentralGenericModel, g_star, x_cam):
    """Implicit-function-theorem sensitivities at converged projections
    (reference package ``noncentral_generic.py:203-256``).

    With the window pinned at g*, J_g = d offset / d g and
    P_px = −(J_gᵀJ_g)⁻¹J_gᵀ scaled to pixels; then d pixel / d x_cam =
    P_px (I − d dᵀ), and a window knot (y, x) of weight w_yx moves the pixel
    by w_yx·P_px·(d offset / d u) along its direction and by
    −w_yx·P_px·(I − d dᵀ) along its origin.  Returns a dict:

    - ``pix_wrt_x`` (N, 2, 3): d pixel / d x_cam;
    - ``j_win`` (N, 2, 4, 4, 5): d pixel / d knot tangent, tangent layout
      (direction t1, direction t2, origin xyz) per window knot;
    - ``win_flat`` (N, 4, 4) int64: flat knot index by*Wg + bx of each
      window knot.
    """
    dtype = model.direction_grid.dtype
    gh, gw = model.grid_height, model.grid_width
    ex, ey = _extent(model)
    inv_scale = torch.tensor([ex / (gw - 3.0), ey / (gh - 3.0)], dtype=dtype,
                             device=g_star.device)
    x_cam = x_cam.to(dtype)
    win, bx, by = bspline.gather_window_2d(_grids(model), g_star)
    wx, wy, dwx, dwy = bspline.fixed_base_weights(bx, by, g_star,
                                                  derivative=True)
    w2 = wy[:, :, None] * wx[:, None, :]  # (N, 4, 4) knot weights
    u = torch.einsum("nyx,nyxc->nc", w2, win[..., :3])
    o = torch.einsum("nyx,nyxc->nc", w2, win[..., 3:])
    dval = torch.stack([torch.einsum("ny,nx,nyxc->nc", wy, dwx, win),
                        torch.einsum("ny,nx,nyxc->nc", dwy, wx, win)], dim=-1)
    _, d, v, vd = _offset(u, o, x_cam)
    d_u, d_o = _offset_jacobians(u, d, v, vd)
    j_g = d_u @ dval[:, :3] + d_o @ dval[:, 3:]  # (N, 3, 2)
    h = j_g.transpose(1, 2) @ j_g
    p_grid = -solve2x2(h[:, None].expand(-1, 3, 2, 2), j_g).transpose(1, 2)
    p_px = p_grid * inv_scale[:, None]  # (N, 2, 3)

    off = torch.arange(4, device=g_star.device)
    win_flat = (by[:, None, None] + off[None, :, None]) * gw \
        + (bx[:, None, None] + off[None, None, :])
    t1, t2 = manifolds.direction_tangents(model.direction_grid)
    frames = torch.stack([t1, t2], dim=-1).reshape(-1, 3, 2)
    # out-of-range flat indices read the nearest end, as the reference's
    # gather does
    win_frames = frames[win_flat.clamp(0, gh * gw - 1)]  # (N, 4, 4, 3, 2)
    a_dir = p_px @ d_u  # (N, 2, 3)
    a_org = p_px @ d_o
    jw_dir = torch.einsum("nyx,nic,nyxcj->niyxj", w2, a_dir, win_frames)
    jw_org = w2[:, None, :, :, None] * a_org[:, :, None, None, :]
    j_win = torch.cat([jw_dir, jw_org], dim=-1)
    return {"pix_wrt_x": -p_px @ d_o, "j_win": j_win, "win_flat": win_flat}

"""Uniform cubic B-spline evaluation on regular grids.

A value at continuous grid coordinate ``g`` is interpolated from the four
control points ``floor(g)-1 .. floor(g)+2`` with the uniform cubic B-spline
basis of the fractional part ``t = g - floor(g)``.

Surface evaluation gathers the 4×4 window of each point.  A knot of the
window that falls outside the grid gets weight 0: its index is clamped only
to keep the gather in bounds, and the mask removes it, so the result is the
same as contracting dense per-axis weight rows with the whole grid.
"""

from __future__ import annotations

import torch


def cubic_bspline_weights(t):
    """Basis weights (..., 4) for fractional position t in [0, 1)."""
    t2 = t * t
    t3 = t2 * t
    one_m = 1.0 - t
    w0 = (one_m * one_m * one_m) / 6.0
    w1 = (3.0 * t3 - 6.0 * t2 + 4.0) / 6.0
    w2 = (-3.0 * t3 + 3.0 * t2 + 3.0 * t + 1.0) / 6.0
    w3 = t3 / 6.0
    return torch.stack([w0, w1, w2, w3], dim=-1)


def cubic_bspline_weight_derivs(t):
    """d/dt of cubic_bspline_weights (per unit grid coordinate)."""
    t2 = t * t
    one_m = 1.0 - t
    d0 = -(one_m * one_m) / 2.0
    d1 = (9.0 * t2 - 12.0 * t) / 6.0
    d2 = (-9.0 * t2 + 6.0 * t + 3.0) / 6.0
    d3 = t2 / 2.0
    return torch.stack([d0, d1, d2, d3], dim=-1)


def window_base(g):
    """Index of the first of the 4 control points at grid coordinate g
    (floor(g) - 1), as int64.  Far-out or non-finite coordinates are held to
    a range just outside the grid, where every knot of the window is masked."""
    f = torch.nan_to_num(torch.floor(g), nan=-1e6)
    return torch.clamp(f, -1e6, 1e6).long() - 1


def axis_window(g, size, derivative=False):
    """Per-axis (index (N, 4) clamped into the grid, weights (N, 4)
    with out-of-grid knots zeroed[, derivative weights (N, 4)])."""
    base = window_base(g)
    t = g - (base + 1).to(g.dtype)
    idx = base[:, None] + torch.arange(4, device=g.device)[None, :]
    inside = (idx >= 0) & (idx < size)
    w = torch.where(inside, cubic_bspline_weights(t), 0.0)
    idx = idx.clamp(0, size - 1)
    if not derivative:
        return idx, w
    dw = torch.where(inside, cubic_bspline_weight_derivs(t), 0.0)
    return idx, w, dw


def gather_windows(grid, gxy):
    """4×4 windows (N, 4, 4, C) [y, x, C] of a (H, W, C) grid, with the
    per-axis indices and masked weights ((iy, wy, dwy), (ix, wx, dwx))."""
    h, w = grid.shape[:2]
    ix, wx, dwx = axis_window(gxy[:, 0], w, derivative=True)
    iy, wy, dwy = axis_window(gxy[:, 1], h, derivative=True)
    win = grid[iy[:, :, None], ix[:, None, :]]
    return win, (iy, wy, dwy), (ix, wx, dwx)


def eval_surface(grid, gxy):
    """Surface value (N, C) at continuous grid coords gxy (N, 2)."""
    h, w = grid.shape[:2]
    ix, wx = axis_window(gxy[:, 0], w)
    iy, wy = axis_window(gxy[:, 1], h)
    win = grid[iy[:, :, None], ix[:, None, :]]
    return torch.einsum("ny,nx,nyxc->nc", wy, wx, win)


def eval_surface_with_jac(grid, gxy):
    """(value (N, C), d value / d grid coords (N, C, 2))."""
    win, (_, wy, dwy), (_, wx, dwx) = gather_windows(grid, gxy)
    rows = torch.einsum("ny,nyxc->nxc", wy, win)
    drows = torch.einsum("ny,nyxc->nxc", dwy, win)
    val = torch.einsum("nx,nxc->nc", wx, rows)
    du_dx = torch.einsum("nx,nxc->nc", dwx, rows)
    du_dy = torch.einsum("nx,nxc->nc", wx, drows)
    return val, torch.stack([du_dx, du_dy], dim=-1)

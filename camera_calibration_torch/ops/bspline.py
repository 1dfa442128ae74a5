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


# ------------------------- fixed-base window form -------------------------
#
# The noncentral model evaluates its grids as the reference package does
# (ops/bspline.py:60-104 there, a dynamic slice): the 4×4 window starts at
# base = floor(g) - 1, a negative start counts from the grid's far end, the
# start is then held inside the grid, and the weights use the base itself.
# Its projection keeps g inside the calibrated area, where windows lie
# inside the grid and this form agrees with the masked one above.


def gather_window_2d(grid, gxy):
    """4×4 windows (N, 4, 4, C) [y, x, C] of a (H, W, C) grid at grid coords
    gxy (N, 2), and the window bases (bx, by) (N,) as int64."""
    h, w = grid.shape[:2]
    base = window_base(gxy)
    bx, by = base[:, 0], base[:, 1]
    off = torch.arange(4, device=gxy.device)

    def start(b, size):
        return torch.where(b < 0, b + size, b).clamp(0, size - 4)[:, None]

    iy = start(by, h) + off
    ix = start(bx, w) + off
    return grid[iy[:, :, None], ix[:, None, :]], bx, by


def fixed_base_weights(bx, by, gxy, derivative=False):
    """Per-axis weights (wx, wy) (N, 4) of windows with bases (bx, by) at
    grid coords gxy (and their derivatives (dwx, dwy) with
    ``derivative``)."""
    tx = gxy[:, 0] - (bx + 1).to(gxy.dtype)
    ty = gxy[:, 1] - (by + 1).to(gxy.dtype)
    w = (cubic_bspline_weights(tx), cubic_bspline_weights(ty))
    if not derivative:
        return w
    return w + (cubic_bspline_weight_derivs(tx), cubic_bspline_weight_derivs(ty))


def eval_window_fixed_base(window, bx, by, gxy):
    """Surface value (N, C) of pre-gathered windows with bases (bx, by) at
    grid coords gxy: the window stays pinned while gxy moves."""
    wx, wy = fixed_base_weights(bx, by, gxy)
    return torch.einsum("ny,nx,nyxc->nc", wy, wx, window)


def dense_axis_weights(g, size, derivative=False):
    """Dense per-axis weight rows (N, size) for grid coords g (N,): row n
    holds the 4 cubic B-spline weights of point n at columns base..base+3
    (zeros elsewhere, and knots past the grid are dropped)."""
    base = torch.floor(g).long() - 1
    t = g - (base + 1).to(g.dtype)
    w4 = (cubic_bspline_weight_derivs(t) if derivative
          else cubic_bspline_weights(t))  # (N, 4)
    idx = base[:, None] + torch.arange(4, device=g.device)[None, :]
    iota = torch.arange(size, device=g.device)
    onehot = (iota[None, None, :] == idx[:, :, None]).to(g.dtype)
    return torch.einsum("nks,nk->ns", onehot, w4)


def eval_surface_dense_rows(grid, wx, wy):
    """Surface values (N, C) from precomputed per-axis weight rows: grid
    (H, W, C), wx (N, W), wy (N, H)."""
    rows = torch.einsum("nh,hwc->nwc", wy, grid)
    return torch.einsum("nw,nwc->nc", wx, rows)

"""Fitting camera models to dense per-pixel observation-direction images.

The reference's FitToDenseModel for grid models (reference:
applications/camera_calibration/src/camera_calibration/models/
central_generic.cc:267-418): knots are seeded from the nearest valid dense
pixel (ring search, then iterative neighbor extrapolation for holes), then
all knots are refined by nonlinear least squares against subsampled
directions with 2-DoF-per-knot manifold updates.

Seeding and the linear start are host NumPy; the refinement is the
matrix-free LM of ``ba/gn.py``, one ``lm_solve`` call, on the device the
caller names (the pipeline passes ``config.host_device()``).  Its residual
contracts precomputed dense per-axis B-spline weight rows with the grid.
"""

from __future__ import annotations

import numpy as np
import torch

from camera_calibration_torch.ba.gn import lm_solve
from camera_calibration_torch.config import host_device
from camera_calibration_torch.models import central_generic as cg
from camera_calibration_torch.models.base import replace
from camera_calibration_torch.ops import bspline, manifolds


def _dense_rows_lm(x0, wx, wy, target, *, normalize, k_tangent,
                   max_iterations, cg_iterations):
    """LM over grid knots against the dense weight-row residual: the
    surface at the samples (normalized for a direction grid) minus
    ``target``."""
    gh, gw = x0.shape[:2]

    def residual_fn(grid):
        vals = bspline.eval_surface_dense_rows(grid, wx, wy)
        if normalize:
            vals = vals / torch.linalg.vector_norm(vals, dim=-1,
                                                   keepdim=True)
        return (vals - target).reshape(-1)

    def retract_fn(grid, tangent):
        if normalize:
            return manifolds.retract_direction(grid, tangent)
        return grid + tangent

    return lm_solve(residual_fn, retract_fn, x0,
                    x0.new_zeros((gh, gw, k_tangent)),
                    max_iterations=max_iterations,
                    cg_iterations=cg_iterations).state


def _linear_kron_solve(wx, wy, target, seed, ridge: float = 1e-6,
                       normalize: bool = True):
    """Solve knots minimizing ‖(wy⊗wx)·G − target‖² + ridge anchoring.

    wx (N, gw) / wy (N, gh) B-spline weight rows; target (N, C); seed
    (gh, gw, C) anchors knots with no data support (the kron normal
    matrix is singular there without it).  Host NumPy — the normal
    matrix is at most a few hundred square.
    """
    n = wx.shape[0]
    gh, gw = wy.shape[1], wx.shape[1]
    a = (wy[:, :, None] * wx[:, None, :]).reshape(n, gh * gw)
    lam = ridge * max(1.0, n / (gh * gw))
    h = a.T @ a + lam * np.eye(gh * gw)
    rhs = a.T @ np.asarray(target) + lam * np.asarray(seed).reshape(
        gh * gw, -1
    )
    g = np.linalg.solve(h, rhs).reshape(gh, gw, -1)
    if normalize:
        g /= np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)
    return g


def _seed_grid_from_dense(dense_dirs, valid, model):
    """Initialize each knot direction from the dense direction image.

    dense_dirs: (H, W, 3) np array; valid: (H, W) bool.
    Mirrors the reference's nearest-valid-pixel ring search (r < 5) with
    iterative neighbor extrapolation for the remaining holes
    (central_generic.cc:267-341 semantics).
    """
    h, w = valid.shape
    gh, gw = model.grid_height, model.grid_width
    knot_px = cg.grid_point_pixels(model).cpu().numpy()
    grid = np.zeros((gh, gw, 3), np.float64)
    filled = np.zeros((gh, gw), bool)

    vy, vx = np.nonzero(valid)
    for gy in range(gh):
        for gx in range(gw):
            px = knot_px[gy, gx]
            cx = int(np.clip(np.floor(px[0]), 0, w - 1))
            cy = int(np.clip(np.floor(px[1]), 0, h - 1))
            found = False
            for r in range(5):
                x0, x1 = max(0, cx - r), min(w - 1, cx + r)
                y0, y1 = max(0, cy - r), min(h - 1, cy + r)
                sub = valid[y0 : y1 + 1, x0 : x1 + 1]
                if sub.any():
                    yy, xx = np.nonzero(sub)
                    d2 = (yy + y0 - cy) ** 2 + (xx + x0 - cx) ** 2
                    i = np.argmin(d2)
                    grid[gy, gx] = dense_dirs[yy[i] + y0, xx[i] + x0]
                    filled[gy, gx] = True
                    found = True
                    break
            if not found:
                pass  # fill by extrapolation below
    # Iterative neighbor-mean extrapolation for unfilled knots.
    while not filled.all():
        newly = np.zeros_like(filled)
        acc = np.zeros((gh, gw, 3))
        cnt = np.zeros((gh, gw))
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            shifted = np.roll(filled, (dy, dx), (0, 1))
            vals = np.roll(grid, (dy, dx), (0, 1))
            # zero out wrap-around
            if dy == 1:
                shifted[0, :] = False
            elif dy == -1:
                shifted[-1, :] = False
            if dx == 1:
                shifted[:, 0] = False
            elif dx == -1:
                shifted[:, -1] = False
            m = shifted & ~filled
            acc[m] += vals[m]
            cnt[m] += 1
        m = (cnt > 0) & ~filled
        if not m.any():
            # disconnected: fill remaining with forward axis
            grid[~filled] = np.array([0.0, 0.0, 1.0])
            filled[:] = True
            break
        grid[m] = acc[m] / cnt[m][:, None]
        newly |= m
        filled |= m
    norms = np.linalg.norm(grid, axis=-1, keepdims=True)
    return grid / np.maximum(norms, 1e-12)


def fit_central_generic_to_dense(
    dense_dirs,
    valid,
    grid_resolution,
    *,
    width=None,
    height=None,
    calibration_min_x=0,
    calibration_min_y=0,
    calibration_max_x=None,
    calibration_max_y=None,
    max_sample_count: int = 12000,
    max_iterations: int = 30,
    cg_iterations: int = 60,
    dtype=torch.float64,
    linear_init: bool = True,
    device=None,
):
    """Fit a CentralGenericModel to a dense (H, W, 3) direction image.

    Returns the fitted model on ``device`` (default:
    ``config.host_device()``), where the refinement runs.
    (reference: central_generic.cc:267-418)  12k samples keep ≥20 samples
    per knot cell at VGA with the default ~25 px/cell grids.
    """
    device = host_device() if device is None else torch.device(device)
    dense_dirs = np.asarray(dense_dirs, np.float64)
    valid = np.asarray(valid, bool)
    h, w = valid.shape
    width = w if width is None else width
    height = h if height is None else height
    if calibration_max_x is None:
        calibration_max_x = width - 1
    if calibration_max_y is None:
        calibration_max_y = height - 1
    gh, gw = grid_resolution if isinstance(grid_resolution, tuple) else (
        grid_resolution,
        grid_resolution,
    )
    model = cg.CentralGenericModel(
        grid=torch.zeros((gh, gw, 3), dtype=dtype, device=device),
        width=int(width),
        height=int(height),
        calibration_min_x=int(calibration_min_x),
        calibration_min_y=int(calibration_min_y),
        calibration_max_x=int(calibration_max_x),
        calibration_max_y=int(calibration_max_y),
    )
    grid0 = _seed_grid_from_dense(dense_dirs, valid, model)

    # Subsample valid pixels for the refinement.
    vy, vx = np.nonzero(valid)
    n_valid = vy.size
    stride = max(1, n_valid // max_sample_count)
    sel = np.arange(0, n_valid, stride)
    px = np.stack([vx[sel] + 0.5, vy[sel] + 0.5], -1).astype(np.float64)
    target_np = dense_dirs[vy[sel], vx[sel]]
    target_np /= np.linalg.norm(target_np, axis=-1, keepdims=True)

    model = replace(model, grid=torch.as_tensor(grid0, dtype=dtype,
                                                device=device))
    gxy = cg.pixel_to_grid(model, torch.as_tensor(px, dtype=dtype,
                                                  device=device))
    target = torch.as_tensor(target_np, dtype=dtype, device=device)
    wx = bspline.dense_axis_weights(gxy[:, 0], gw)  # (N, gw)
    wy = bspline.dense_axis_weights(gxy[:, 1], gh)  # (N, gh)

    # Linear least-squares start: without the unit-norm constraint the
    # spline fit is linear in the knots, so one kron normal-equation solve
    # (ridge-anchored to the ring-seeded grid for knots outside data
    # support) lands in the LM's basin, and a few LM iterations finish.
    if linear_init:
        grid_start = torch.as_tensor(np.ascontiguousarray(_linear_kron_solve(
            wx.cpu().numpy(), wy.cpu().numpy(), target_np, grid0)),
            dtype=dtype, device=device)
        lm_budget = min(max_iterations, 8)
    else:
        # the capped-CG LM from the ring seed (the noncentral line-field
        # fit is tuned to this trajectory)
        grid_start = model.grid
        lm_budget = max_iterations
    grid_fit = _dense_rows_lm(
        grid_start, wx, wy, target, normalize=True, k_tangent=2,
        max_iterations=lm_budget, cg_iterations=cg_iterations)
    return replace(model, grid=grid_fit)


def _seed_values_from_dense(dense_vals, valid, model):
    """Knot seeding for an arbitrary-valued field (nearest valid pixel +
    neighbor-mean extrapolation, no normalization)."""
    h, w = valid.shape
    gh, gw = model.grid_height, model.grid_width
    knot_px = cg.grid_point_pixels(model).cpu().numpy()
    grid = np.zeros((gh, gw, dense_vals.shape[-1]), np.float64)
    filled = np.zeros((gh, gw), bool)
    for gy in range(gh):
        for gx in range(gw):
            px = knot_px[gy, gx]
            cx = int(np.clip(np.floor(px[0]), 0, w - 1))
            cy = int(np.clip(np.floor(px[1]), 0, h - 1))
            for r in range(5):
                x0, x1 = max(0, cx - r), min(w - 1, cx + r)
                y0, y1 = max(0, cy - r), min(h - 1, cy + r)
                sub = valid[y0:y1 + 1, x0:x1 + 1]
                if sub.any():
                    yy, xx = np.nonzero(sub)
                    d2 = (yy + y0 - cy) ** 2 + (xx + x0 - cx) ** 2
                    i = np.argmin(d2)
                    grid[gy, gx] = dense_vals[yy[i] + y0, xx[i] + x0]
                    filled[gy, gx] = True
                    break
    while not filled.all():
        acc = np.zeros_like(grid)
        cnt = np.zeros((gh, gw))
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            shifted = np.roll(filled, (dy, dx), (0, 1))
            vals = np.roll(grid, (dy, dx), (0, 1))
            if dy == 1:
                shifted[0, :] = False
            elif dy == -1:
                shifted[-1, :] = False
            if dx == 1:
                shifted[:, 0] = False
            elif dx == -1:
                shifted[:, -1] = False
            m = shifted & ~filled
            acc[m] += vals[m]
            cnt[m] += 1
        m = (cnt > 0) & ~filled
        if not m.any():
            filled[:] = True
            break
        grid[m] = acc[m] / cnt[m][:, None]
        filled |= m
    return grid


def fit_noncentral_to_lines(
    line_dirs,
    line_anchors,
    valid,
    grid_resolution,
    *,
    width=None,
    height=None,
    max_sample_count: int = 12000,
    max_iterations: int = 30,
    cg_iterations: int = 60,
    dtype=torch.float64,
    device=None,
):
    """Fit a NoncentralGenericModel to a dense per-pixel line field.

    line_dirs / line_anchors: (H, W, 3) oriented unit directions and line
    anchor points (anchors that vary smoothly, e.g. closest points to the
    effective camera centroid).  The direction grid is fitted as a central
    model (from the ring seed, without the linear start), the point grid by
    the capped-CG LM on the anchors: its early termination smooths the
    weakly constrained along-ray anchor directions.  Runs on ``device``
    (default: ``config.host_device()``).
    """
    from camera_calibration_torch.models import noncentral_generic as ncg

    device = host_device() if device is None else torch.device(device)
    line_dirs = np.asarray(line_dirs, np.float64)
    line_anchors = np.asarray(line_anchors, np.float64)
    valid = np.asarray(valid, bool)
    h, w = valid.shape
    width = w if width is None else width
    height = h if height is None else height

    # Fit in the field's own raster, rewrap with the real image bounds at
    # the end (the buffer covers the full image uniformly).
    central = fit_central_generic_to_dense(
        line_dirs, valid, grid_resolution,
        width=w, height=h,
        max_sample_count=max_sample_count,
        max_iterations=max_iterations,
        cg_iterations=cg_iterations,
        dtype=dtype,
        linear_init=False,
        device=device,
    )

    gh, gw = central.grid.shape[:2]
    probe = cg.CentralGenericModel(
        grid=torch.zeros((gh, gw, 3), dtype=dtype, device=device),
        width=w, height=h,
        calibration_min_x=0, calibration_min_y=0,
        calibration_max_x=w - 1, calibration_max_y=h - 1,
    )
    point0 = _seed_values_from_dense(line_anchors, valid, probe)

    vy, vx = np.nonzero(valid)
    stride = max(1, vy.size // max_sample_count)
    sel = np.arange(0, vy.size, stride)
    px = np.stack([vx[sel] + 0.5, vy[sel] + 0.5], -1).astype(np.float64)

    target = torch.as_tensor(line_anchors[vy[sel], vx[sel]], dtype=dtype,
                             device=device)
    gxy = cg.pixel_to_grid(probe, torch.as_tensor(px, dtype=dtype,
                                                  device=device))
    wx = bspline.dense_axis_weights(gxy[:, 0], gw)
    wy = bspline.dense_axis_weights(gxy[:, 1], gh)
    point_fit = _dense_rows_lm(
        torch.as_tensor(point0, dtype=dtype, device=device), wx, wy, target,
        normalize=False, k_tangent=3, max_iterations=max_iterations,
        cg_iterations=cg_iterations)
    return ncg.NoncentralGenericModel(
        direction_grid=central.grid,
        point_grid=point_fit,
        width=int(width), height=int(height),
        calibration_min_x=0, calibration_min_y=0,
        calibration_max_x=int(width) - 1,
        calibration_max_y=int(height) - 1,
    )

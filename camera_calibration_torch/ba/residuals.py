"""Reprojection residuals and per-observation Jacobian blocks.

For every observation (imageset i, camera c, point p, measured pixel m) the
residual is ``r = π_c(R_c (R_r x_p + t_r) + t_c) − m`` with a Huber (1 px)
robust loss.  Jacobian blocks are closed form: the pose and point chains go
through small cross-product matrices; the intrinsics block of a grid model
is the sparse 4×4-window knot Jacobian from the implicit-function-theorem
projection sensitivities (``models/central_generic_cuda.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from camera_calibration_torch.ba import window_cuda
from camera_calibration_torch.ba.state import (
    BAState, broadcast_rows, transform_to_camera,
)
from camera_calibration_torch.models import central_generic as cg
from camera_calibration_torch.models import central_generic_cuda as cgc
from camera_calibration_torch.models import protocol
from camera_calibration_torch.ops import losses, manifolds, se3


@dataclasses.dataclass(frozen=True)
class GridIntr:
    """Sparse intrinsics block of a spline-grid model.

    ``j_win`` is (2·4·4·K, n) with rows [i, y, x, j] and n contiguous; the
    window of observation n starts at knot ``base_xy[n] = (bx, by)``.
    """

    j_win: torch.Tensor  # (2*4*4*K, n)
    base_xy: torch.Tensor  # (n, 2) int32 window base (bx, by)
    k_tangent: int  # K: 2 central, 5 noncentral


@dataclasses.dataclass(frozen=True)
class ObsBlocks:
    """Per-observation residuals + Jacobian blocks for one camera segment."""

    r: torch.Tensor  # (n, 2) residual px - measured
    j_rig: torch.Tensor  # (n, 2, 6)
    j_cam: torch.Tensor  # (n, 2, 6)
    j_point: torch.Tensor  # (n, 2, 3)
    intr: GridIntr
    weight: torch.Tensor  # (n,) Huber IRLS weight · validity
    valid: torch.Tensor  # (n,) bool
    cost: torch.Tensor  # (n,) robust cost (0 where invalid)


def _cross_matrix(v):
    """[v]_× for (..., 3)."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -v[..., 2], v[..., 1]], -1),
            torch.stack([v[..., 2], zero, -v[..., 0]], -1),
            torch.stack([-v[..., 1], v[..., 0], zero], -1),
        ],
        dim=-2,
    )


def _grid_projection_blocks(model, x_cam, warm_xy, max_proj_iterations,
                            frames):
    """Grid-model projection + (px, valid, d px / d x_cam, GridIntr).

    One call of ``central_generic_cuda.project_blocks`` (one kernel launch
    on the card) runs the projection loop, the sensitivities and the window
    knot Jacobian.
    """
    dtype = model.grid.dtype
    norm = torch.linalg.vector_norm(x_cam, dim=-1, keepdim=True)
    d = x_cam / torch.clamp_min(norm, 1e-18)
    g0 = cg.pixel_to_grid(model, warm_xy)
    lo, hi = cg._static_clamp_bounds(model)
    eps = cg.default_eps(dtype)
    if frames is None:
        frames = manifolds.direction_tangents(model.grid)
    t1, t2 = frames
    sx, sy = cg.pixel_scale_to_grid_scale(model)
    g, cost, p, j_win, base = cgc.project_blocks(
        model.grid, t1.contiguous(), t2.contiguous(), d.contiguous(),
        g0.contiguous(), lo, hi, (1.0 / sx, 1.0 / sy),
        int(max_proj_iterations), eps,
    )
    pvalid = (cost < 1e4 * eps) & (norm[:, 0] > 1e-12)
    px = cg.grid_to_pixel(model, g)
    # d = x_cam/|x_cam|; A = P·(I − d dᵀ)/|x_cam|  — wrt x_cam
    pd = torch.sum(p * d[:, None, :], dim=-1)
    a = (p - pd[..., None] * d[:, None, :]) / torch.clamp_min(
        norm[..., None], 1e-18)
    return px, pvalid, a, GridIntr(j_win=j_win, base_xy=base, k_tangent=2)


def segment_blocks(
    model,
    state: BAState,
    imageset_idx,
    camera_idx,
    point_idx,
    measured_px,
    obs_valid,
    warm_xy,
    *,
    huber_px: float = 1.0,
    max_proj_iterations: int = 10,
    tangent_frames=None,
    grid_shape=None,
):
    """Residuals + all Jacobian blocks for one camera's observations.

    Returns (ObsBlocks, new_warm_xy).
    """
    protocol.require_supported(model)
    dtype = state.points.dtype
    x = broadcast_rows(state.points, point_idx, grid_shape, 1)
    x_cam, x_rig = transform_to_camera(
        state, imageset_idx, camera_idx, x, grid_shape=grid_shape
    )
    px, pvalid, a, intr = _grid_projection_blocks(
        model, x_cam, warm_xy, max_proj_iterations, tangent_frames
    )
    valid = obs_valid & pvalid

    r_c = se3.quat_to_matrix(state.cam_q_rig[camera_idx])  # (n,3,3)
    r_r = se3.quat_to_matrix(
        broadcast_rows(state.rig_q_global, imageset_idx, grid_shape, 0)
    )
    a_rc = a @ r_c  # (n,2,3)
    j_point = a_rc @ r_r
    v_r = x_rig - broadcast_rows(
        state.rig_t_global, imageset_idx, grid_shape, 0
    )  # R_r x
    j_rig = torch.cat([-(a_rc @ _cross_matrix(v_r)), a_rc], dim=-1)
    v_c = x_cam - state.cam_t_rig[camera_idx]  # R_c x_rig
    j_cam = torch.cat([-(a @ _cross_matrix(v_c)), a], dim=-1)

    r = torch.where(valid[:, None], px - measured_px, 0.0)
    sq = torch.sum(r * r, dim=-1)
    vf = valid.to(dtype)
    mask3 = valid[:, None, None]
    blocks = ObsBlocks(
        r=r,
        j_rig=torch.where(mask3, j_rig, 0.0),
        j_cam=torch.where(mask3, j_cam, 0.0),
        j_point=torch.where(mask3, j_point, 0.0),
        intr=GridIntr(
            j_win=torch.where(valid[None, :], intr.j_win, 0.0),
            base_xy=intr.base_xy,
            k_tangent=intr.k_tangent,
        ),
        weight=losses.huber_weight(sq, huber_px) * vf,
        valid=valid,
        cost=losses.huber_cost(sq, huber_px) * vf,
    )
    new_warm = torch.where(pvalid[:, None], px, warm_xy)
    return blocks, new_warm


def intr_apply_j(intr: GridIntr, tangent_intr):
    """Intrinsics contribution to J·v: (n, 2)."""
    return window_cuda.window_apply_j(
        intr.j_win, intr.base_xy, tangent_intr.contiguous())


def intr_apply_jtw(intr: GridIntr, ws, tangent_shape_like):
    """Intrinsics part of JᵀW·s, scattered into the tangent layout."""
    gh, gw, k = tangent_shape_like.shape
    return window_cuda.window_apply_jtw(
        intr.j_win, intr.base_xy, ws.contiguous(), gh, gw, k)


def segment_cost(
    model,
    state: BAState,
    imageset_idx,
    camera_idx,
    point_idx,
    measured_px,
    obs_valid,
    warm_xy,
    *,
    huber_px: float = 1.0,
    max_proj_iterations: int = 10,
    grid_shape=None,
):
    """Cost-only evaluation (for LM accept/reject tests).

    Returns (per-obs robust cost, validity, warm pixels).
    """
    dtype = state.points.dtype
    x = broadcast_rows(state.points, point_idx, grid_shape, 1)
    x_cam, _ = transform_to_camera(
        state, imageset_idx, camera_idx, x, grid_shape=grid_shape
    )
    px, _, pvalid = protocol.project_points(
        model, x_cam, init_xy=warm_xy, max_iterations=max_proj_iterations
    )
    valid = obs_valid & pvalid
    r = px - measured_px
    sq = torch.sum(r * r, dim=-1)
    cost = losses.huber_cost(sq, huber_px) * valid.to(dtype)
    new_warm = torch.where(pvalid[:, None], px, warm_xy)
    return cost, valid, new_warm

"""NoncentralGeneric projection on the card: the LM loop in one kernel.

:func:`project_points` is :func:`noncentral_generic.project_points` with the
loop in one launch of ``ncg_projection_kernel``
(``csrc/project_noncentral.cu``): one thread a point, iterating on the card
until the point is done or ``max_iterations`` have run, with no read on the
host.  Tensors on the CPU go to the plain function, which stays the
reference (host test included); float32 CUDA tensors go to the kernel;
anything else raises.  The clamp bounds, the warm-start center and the
pixel-to-grid mapping reach the kernel as Python floats, so a call copies
nothing to the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from camera_calibration_torch import _cuda
from camera_calibration_torch.models import central_generic as cg
from camera_calibration_torch.models import noncentral_generic as ncg
from camera_calibration_torch.ops.linalg import solve2x2

NAME = "project_noncentral"


@functools.cache
def plan(gh: int, gw: int, device_index: int = 0) -> dict:
    """The kernel's launch plan at this grid (``cct_project_noncentral_plan``):
    whether the grids are staged in shared memory, threads per block, one
    block's shared memory, and the blocks one SM holds."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        _cuda.lib().cct_project_noncentral_plan(gh, gw, out)
    return {"staged": bool(out[0]), "threads": out[1], "smem_bytes": out[2],
            "blocks_per_sm": out[3]}


def lm_loop_plain(model, points, init_xy, max_iterations: int,
                  eps: float = 1e-10):
    """:func:`noncentral_generic.project_points`' loop as the kernel runs it,
    in plain PyTorch: exactly ``max_iterations`` iterations, with per-point
    ``done`` and no read on the host.  A done point never moves again, so
    this is ``project_points``' result; it also says how long each point
    ran, which is what a bound on the kernel's time counts.  Returns
    (pixel_xy, grid_xy, valid, done_at): ``done_at`` is the iteration after
    whose step the point was done (it ran ``done_at + 1`` iterations), or
    -1 where it ran all ``max_iterations`` without being done."""
    dtype, dev = model.direction_grid.dtype, points.device
    n = points.shape[0]
    g = ncg.pixel_to_grid(model, init_xy)
    lo = ncg.pixel_to_grid(model, torch.tensor(
        [model.calibration_min_x, model.calibration_min_y], dtype=dtype,
        device=dev))
    hi = ncg.pixel_to_grid(model, torch.tensor(
        [model.calibration_max_x + 0.999, model.calibration_max_y + 0.999],
        dtype=dtype, device=dev))
    eye = torch.eye(2, dtype=dtype, device=dev)
    lam = torch.full((n,), -1.0, dtype=dtype, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    done_at = torch.full((n,), -1, device=dev)
    for it in range(max_iterations):
        r, jac = ncg._residual_and_jac(model, g, points)
        cost = torch.sum(r * r, dim=-1)
        h = jac.transpose(1, 2) @ jac
        b = torch.einsum("nik,ni->nk", jac, r)
        lam = torch.where(lam < 0, 0.01 * 0.5 * (h[:, 0, 0] + h[:, 1, 1]),
                          lam)
        step = solve2x2(h + lam[:, None, None] * eye, b)
        g_test = torch.clamp(g - step, lo, hi)
        accept = (ncg._cost_at(model, g_test, points) < cost) & ~done
        g = torch.where(accept[:, None], g_test, g)
        lam = torch.where(accept, 0.5 * lam, 2.0 * lam)
        done_at = torch.where(~done & (cost < eps), it, done_at)
        done = done | (cost < eps)
    final_cost = ncg._cost_at(model, g, points)
    scale = torch.clamp_min(torch.linalg.vector_norm(points, dim=-1), 1e-6)
    valid = torch.sqrt(final_cost) < 1e-4 * scale
    return ncg.grid_to_pixel(model, g), g, valid, done_at


def project_points_and_cost(model, points, init_xy=None,
                            max_iterations: int = 50,
                            eps: float | None = None):
    """(pixel_xy (N, 2), grid_xy (N, 2), valid (N,), final cost (N,)) of the
    kernel.  ``points`` (N, 3) and ``init_xy`` (N, 2) pixels or None (the
    calibrated area's center), contiguous float32 on the model's card."""
    grids = {"direction_grid": model.direction_grid,
             "point_grid": model.point_grid}
    inputs = {"points": points}
    if init_xy is not None:
        inputs["init_xy"] = init_xy
    _cuda.require_cuda_f32(NAME, **grids, **inputs)
    gh, gw = model.grid_height, model.grid_width
    n = points.shape[0]
    for key, t in grids.items():
        if t.shape != (gh, gw, 3):
            raise ValueError(f"{NAME}: {key} must be (gh, gw, 3), got "
                             f"{tuple(t.shape)}")
    if gh < 4 or gw < 4:
        raise ValueError(f"{NAME}: the grids must be at least 4×4")
    if points.shape != (n, 3) or (init_xy is not None
                                  and init_xy.shape != (n, 2)):
        raise ValueError(f"{NAME}: points must be (N, 3) and init_xy (N, 2)")
    if len({t.device for t in (*grids.values(), *inputs.values())}) > 1:
        raise ValueError(f"{NAME}: the inputs are on different cards")
    # the clamp range as Python floats: both grid models map pixels to
    # grid coords alike
    (lo_x, lo_y), (hi_x, hi_y) = cg._static_clamp_bounds(model)
    ex, ey = ncg._extent(model)
    cx = 0.5 * (model.calibration_min_x + model.calibration_max_x + 1)
    cy = 0.5 * (model.calibration_min_y + model.calibration_max_y + 1)
    dev = points.device
    px = torch.empty((n, 2), dtype=torch.float32, device=dev)
    g = torch.empty((n, 2), dtype=torch.float32, device=dev)
    cost = torch.empty((n,), dtype=torch.float32, device=dev)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        _cuda.launch(
            NAME, points.data_ptr(),
            None if init_xy is None else init_xy.data_ptr(),
            model.direction_grid.data_ptr(), model.point_grid.data_ptr(),
            n, gh, gw, float(model.calibration_min_x),
            float(model.calibration_min_y), float(ex), float(ey), cx, cy,
            lo_x, lo_y, hi_x, hi_y, int(max_iterations),
            1e-10 if eps is None else float(eps), px.data_ptr(), g.data_ptr(),
            cost.data_ptr(), valid.data_ptr())
    return px, g, valid, cost


def project_points(model, points, init_xy=None, max_iterations: int = 50,
                   eps: float | None = None):
    """(pixel_xy, grid_xy, valid): :func:`noncentral_generic.project_points`,
    through the kernel on the card."""
    tensors = (model.direction_grid, model.point_grid, points) + (
        () if init_xy is None else (init_xy,))
    if all(t.device.type == "cpu" for t in tensors):
        return ncg.project_points(model, points, init_xy=init_xy,
                                  max_iterations=max_iterations, eps=eps)
    return project_points_and_cost(model, points, init_xy, max_iterations,
                                   eps)[:3]

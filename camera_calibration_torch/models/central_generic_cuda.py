"""CentralGeneric projection kernels and their plain PyTorch versions.

Two functions, each with a kernel (``csrc/project.cu``, one template
instantiated twice) and a plain version that computes the same thing:

- :func:`project_grid_coords`: per point, a damped 2×2 Levenberg-Marquardt
  inversion of the normalized spline surface on grid coordinates (the
  counterpart of ``project_grid_coords_pallas``, the reference package's
  ``models/central_generic_pallas.py``).
- :func:`project_blocks`: the same loop, then the implicit-function-theorem
  projection sensitivities and the 4×4-window knot Jacobian ``j_win`` of
  the bundle-adjustment blocks pass (the counterpart of
  ``project_blocks_pallas``).

A tensor on the CPU goes to the plain version; a float32 CUDA tensor goes to
the kernel; anything else raises.  The plain versions follow the reference
package's XLA forms (``central_generic.project_directions`` and
``residuals._grid_projection_blocks``) with a 4×4 window gather in place of
the dense one-hot contraction.
"""

from __future__ import annotations

import torch

from camera_calibration_torch import _cuda
from camera_calibration_torch.ops import bspline
from camera_calibration_torch.ops.linalg import solve2x2


# ------------------------------ plain versions ------------------------------


def _cost_at(grid, dirs, g):
    u = bspline.eval_surface(grid, g)
    un = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    return torch.sum((un - dirs) ** 2, dim=-1)


def project_grid_coords_plain(grid, dirs, g0, lo, hi, max_iterations, eps):
    """Batched LM projection in plain PyTorch: (g (N, 2), final cost (N,))."""
    g, _ = lm_loop_plain(grid, dirs, g0, lo, hi, max_iterations, eps)
    return g, _cost_at(grid, dirs.to(grid.dtype), g)


def lm_loop_plain(grid, dirs, g0, lo, hi, max_iterations, eps):
    """The projection LM loop: (g (N, 2), iterations run per point (N,)).

    Every point iterates with its own λ, reject count and ``done`` flag; a
    done point never moves again, so leaving the loop once all points are
    done (one host sync per iteration) gives the same result as running all
    ``max_iterations``.  The per-point count is the work the kernel does
    for the point, which is what a bound on its time counts.
    """
    dtype = grid.dtype
    dirs = dirs.to(dtype)
    n = dirs.shape[0]
    lo_t = torch.tensor(lo, dtype=dtype, device=grid.device)
    hi_t = torch.tensor(hi, dtype=dtype, device=grid.device)
    eye2 = torch.eye(2, dtype=dtype, device=grid.device)
    g = g0.to(dtype)
    lam = torch.full((n,), -1.0, dtype=dtype, device=grid.device)
    rejects = torch.zeros(n, dtype=torch.int32, device=grid.device)
    done = torch.zeros(n, dtype=torch.bool, device=grid.device)
    iterations = torch.zeros(n, dtype=torch.int32, device=grid.device)
    for _ in range(int(max_iterations)):
        if bool(done.all()):
            break
        iterations += (~done).to(torch.int32)
        u, du = bspline.eval_surface_with_jac(grid, g)
        norm = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
        un = u / norm
        # d un/d g = N(u) @ du with N = (I - un unᵀ)/|u|
        proj = du - un[..., :, None] * torch.sum(
            un[..., :, None] * du, dim=-2, keepdim=True)
        jac = proj / norm[..., None]
        r = un - dirs
        cost = torch.sum(r * r, dim=-1)
        h = torch.einsum("nik,nil->nkl", jac, jac)
        b = torch.einsum("nik,ni->nk", jac, r)
        mean_diag = 0.5 * (h[:, 0, 0] + h[:, 1, 1])
        lam = torch.where(lam < 0, 0.01 * mean_diag, lam)
        step = solve2x2(h + lam[:, None, None] * eye2, b)
        g_test = torch.minimum(torch.maximum(g - step, lo_t), hi_t)
        test_cost = _cost_at(grid, dirs, g_test)
        accept = (test_cost < cost) & ~done
        g = torch.where(accept[:, None], g_test, g)
        lam = torch.where(accept, 0.5 * lam, 2.0 * lam)
        rejects = torch.where(accept, torch.zeros_like(rejects), rejects + 1)
        done = done | (cost < eps) | (rejects >= 3)
    return g, iterations


def sensitivities_plain(grid, g, inv_scale):
    """Implicit-function-theorem sensitivities at converged grid coords.

    Returns (p_px (N, 2, 3) = d pixel / d direction, pn (N, 2, 3) = p_px·N(u),
    weights (N, 4, 4) spline weights [y, x] of the window, base (N, 2) int32
    window base (bx, by)).  ``inv_scale`` = (1/sx, 1/sy) pixel per grid unit.
    """
    dtype = grid.dtype
    n = g.shape[0]
    u, du = bspline.eval_surface_with_jac(grid, g)
    norm = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    un = u / norm
    eye3 = torch.eye(3, dtype=dtype, device=grid.device)
    n_jac = (eye3[None] - torch.einsum("ni,nj->nij", un, un)) / norm[..., None]
    big_u = torch.einsum("nij,njk->nik", n_jac, du)  # (N, 3, 2) = ∂un/∂g
    uu = torch.einsum("nik,nil->nkl", big_u, big_u)  # (N, 2, 2)
    # P = (UᵀU)⁻¹ Uᵀ via 2×2 solves against the rows of U
    uu_inv_ut = solve2x2(uu[:, None].expand(n, 3, 2, 2), big_u).transpose(-1, -2)
    scale = torch.tensor(inv_scale, dtype=dtype, device=grid.device)
    p_px = uu_inv_ut * scale[None, :, None]
    pn = torch.einsum("nik,nkl->nil", p_px, n_jac)
    base = bspline.window_base(g)
    t = g - (base + 1).to(dtype)
    wx = bspline.cubic_bspline_weights(t[:, 0])
    wy = bspline.cubic_bspline_weights(t[:, 1])
    weights = wy[:, :, None] * wx[:, None, :]
    return p_px, pn, weights, base.to(torch.int32)


def project_blocks_plain(grid, t1, t2, dirs, g0, lo, hi, inv_scale,
                         max_iterations, eps):
    """Projection + sensitivities + window knot Jacobian in plain PyTorch.

    Returns (g (N, 2), cost (N,), p_px (N, 2, 3), j_win (64, N) with rows
    [i, y, x, j] = −w_y·w_x·(pn_i · frame_j at the knot), base (N, 2)
    int32).  A knot outside the grid gets weight 0.
    """
    g, cost = project_grid_coords_plain(grid, dirs, g0, lo, hi,
                                        max_iterations, eps)
    p_px, pn, _, base = sensitivities_plain(grid, g, inv_scale)
    gh, gw = grid.shape[:2]
    ix, wx = bspline.axis_window(g[:, 0], gw)
    iy, wy = bspline.axis_window(g[:, 1], gh)
    weights = wy[:, :, None] * wx[:, None, :]
    frames = torch.stack([t1, t2], dim=-1)  # (gh, gw, 3, 2)
    win_frames = frames[iy[:, :, None], ix[:, None, :]]  # (N, 4, 4, 3, 2)
    j_win = -torch.einsum("nyx,nic,nyxcj->iyxjn", weights, pn, win_frames)
    return g, cost, p_px, j_win.reshape(-1, g.shape[0]), base


# --------------------------------- kernels ---------------------------------


def _check_shapes(name, grid, dirs, g0):
    if grid.dim() != 3 or grid.shape[2] != 3:
        raise ValueError(f"{name}: grid must be (gh, gw, 3), got "
                         f"{tuple(grid.shape)}")
    if grid.shape[0] < 4 or grid.shape[1] < 4:
        raise ValueError(f"{name}: grid must be at least 4×4")
    n = dirs.shape[0]
    if dirs.shape != (n, 3) or g0.shape != (n, 2):
        raise ValueError(f"{name}: dirs must be (N, 3) and g0 (N, 2), got "
                         f"{tuple(dirs.shape)} and {tuple(g0.shape)}")
    return n


def project_grid_coords(grid, dirs, g0, lo, hi, max_iterations, eps):
    """LM projection: (grid coords (N, 2), final cost (N,)).

    grid (gh, gw, 3) unit directions; dirs (N, 3) unit; g0 (N, 2) warm start
    in grid coords; lo/hi the (x, y) clamp bounds of the test steps.
    """
    if dirs.device.type == "cpu":
        return project_grid_coords_plain(grid, dirs, g0, lo, hi,
                                         max_iterations, eps)
    name = "project"
    _cuda.require_cuda_f32(name, grid=grid, dirs=dirs, g0=g0)
    n = _check_shapes(name, grid, dirs, g0)
    gh, gw = grid.shape[:2]
    _cuda.check_smem(gh * gw * 3 * 4, name)
    g_out = torch.empty((2, n), dtype=torch.float32, device=dirs.device)
    cost = torch.empty((n,), dtype=torch.float32, device=dirs.device)
    if n:
        _cuda.launch(name, dirs.data_ptr(), g0.data_ptr(), grid.data_ptr(),
                     n, gh, gw, float(lo[0]), float(lo[1]), float(hi[0]),
                     float(hi[1]), int(max_iterations), float(eps),
                     g_out.data_ptr(), cost.data_ptr())
    return g_out.T, cost


def project_blocks(grid, t1, t2, dirs, g0, lo, hi, inv_scale, max_iterations,
                   eps):
    """Fused projection + sensitivities + window knot Jacobian.

    Same contract as :func:`project_blocks_plain`.  On the card ``g``,
    ``p_px`` and ``base`` are views of row-major (rows, N) buffers.
    """
    if dirs.device.type == "cpu":
        return project_blocks_plain(grid, t1, t2, dirs, g0, lo, hi,
                                    inv_scale, max_iterations, eps)
    name = "project_blocks"
    _cuda.require_cuda_f32(name, grid=grid, t1=t1, t2=t2, dirs=dirs, g0=g0)
    n = _check_shapes(name, grid, dirs, g0)
    if t1.shape != grid.shape or t2.shape != grid.shape:
        raise ValueError(f"{name}: frames must have the grid's shape")
    gh, gw = grid.shape[:2]
    _cuda.check_smem(gh * gw * 9 * 4, name)
    dev = dirs.device
    g_out = torch.empty((2, n), dtype=torch.float32, device=dev)
    cost = torch.empty((n,), dtype=torch.float32, device=dev)
    ppx = torch.empty((6, n), dtype=torch.float32, device=dev)
    j_win = torch.empty((64, n), dtype=torch.float32, device=dev)
    base = torch.empty((2, n), dtype=torch.int32, device=dev)
    if n:
        _cuda.launch(name, dirs.data_ptr(), g0.data_ptr(), grid.data_ptr(),
                     t1.data_ptr(), t2.data_ptr(), n, gh, gw,
                     float(lo[0]), float(lo[1]), float(hi[0]), float(hi[1]),
                     int(max_iterations), float(eps), float(inv_scale[0]),
                     float(inv_scale[1]), g_out.data_ptr(), cost.data_ptr(),
                     ppx.data_ptr(), j_win.data_ptr(), base.data_ptr())
    # ppx rows are [i*3 + c]: (6, N) -> (N, 2, 3) view
    return g_out.T, cost, ppx.T.reshape(n, 2, 3), j_win, base.T

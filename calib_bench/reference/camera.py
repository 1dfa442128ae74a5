"""Plain reference of the benchmark's camera models and cost, in float64.

It imports nothing of the program.  A state is a dict of float64 tensors:
``rig_q`` (M, 4) board-to-camera rotations (w, x, y, z), ``rig_t`` (M, 3),
``points`` (P, 3), ``directions`` (gh, gw, 3) knot directions, ``origins``
(gh, gw, 3) knot line origins or None (a central camera), optional
``cam_q`` (4,) and ``cam_t`` (3,) of the one camera in the rig, and the
image ``width`` and ``height``.  Rows are in (view × corner) grid layout:
row ``i·P + j`` is corner j seen in view i.

The camera models are the definitions the program implements:

- pixel ↔ grid: knot (x, y) sits at pixel ((x − 1)·w/(gw − 3),
  (y − 1)·h/(gh − 3)) (a one-cell border; pixel-corner convention);
- a knot field is read at grid coordinate g by the uniform cubic B-spline
  of the 4×4 knots from floor(g) − 1;
- central: the pixel's ray is the normalized direction field;
- noncentral: the pixel's line runs through the origin field along the
  normalized direction field;
- a point projects to the pixel of the calibrated area [0, w) × [0, h)
  whose ray or line passes through it, found here by Gauss–Newton with
  central-difference Jacobians from a given start pixel;
- the cost of an observation is Huber(1 px) of its squared reprojection
  error: |r|²/2 below 1 px, |r| − 1/2 above; the total sums the rows that
  are kept and project.

:func:`evaluate` also gives the step gain of a state: the cost drop that one
more Gauss–Newton step would still make from it (the quadratic model's
½·gᵀH⁻¹g, Huber rows weighted as iteratively reweighted least squares),
over the cost, the larger of a step over every point alone and a step over
every view's pose alone (each point's 3×3 and each view's 6×6 normal
equations, the rest held).  A solved state reads about 0; a state short of
its optimum reads more.  The pixel's derivative by the camera-frame point
is the implicit one of the projection's equations at their solution.
"""

from __future__ import annotations

import torch

BLOCK_ROWS = 1 << 18
GN_ITERATIONS = 10
FD_STEP = 1e-6  # grid units, for the central-difference Jacobian
CENTRAL_TOL = 1e-9  # |n(g) − d| at convergence
NONCENTRAL_TOL = 1e-9  # point-to-line distance over the point's distance


def quat_matrix(q):
    """(…, 3, 3) rotation matrices of quaternions (w, x, y, z), each
    normalized first."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def camera_points(state, rows, n_points):
    """(N, 3) camera-frame corners of grid-layout ``rows``."""
    view = torch.div(rows, n_points, rounding_mode="floor")
    corner = rows - view * n_points
    r = quat_matrix(state["rig_q"])[view]
    x = (r @ state["points"][corner][:, :, None])[:, :, 0] \
        + state["rig_t"][view]
    if state.get("cam_q") is not None:
        x = (quat_matrix(state["cam_q"]) @ x.T).T + state["cam_t"]
    return x


def _bspline(t):
    t2 = t * t
    t3 = t2 * t
    u = 1.0 - t
    return torch.stack([u * u * u / 6.0, (3.0 * t3 - 6.0 * t2 + 4.0) / 6.0,
                        (-3.0 * t3 + 3.0 * t2 + 3.0 * t + 1.0) / 6.0,
                        t3 / 6.0], -1)


def field(grid, g):
    """(N, C) B-spline value of a (gh, gw, C) knot field at grid coords
    g (N, 2) = (x, y)."""
    gh, gw = grid.shape[:2]
    base = torch.floor(g) - 1.0
    bx = base[:, 0].clamp(0, gw - 4)
    by = base[:, 1].clamp(0, gh - 4)
    wx = _bspline(g[:, 0] - bx - 1.0)
    wy = _bspline(g[:, 1] - by - 1.0)
    off = torch.arange(4, device=g.device)
    ix = bx.long()[:, None] + off
    iy = by.long()[:, None] + off
    win = grid[iy[:, :, None], ix[:, None, :]]  # (N, 4, 4, C)
    return torch.einsum("ny,nx,nyxc->nc", wy, wx, win)


def to_grid(state, px):
    gh, gw = state["directions"].shape[:2]
    return torch.stack([1.0 + (gw - 3.0) * px[:, 0] / state["width"],
                        1.0 + (gh - 3.0) * px[:, 1] / state["height"]], -1)


def to_pixel(state, g):
    gh, gw = state["directions"].shape[:2]
    return torch.stack([(g[:, 0] - 1.0) * state["width"] / (gw - 3.0),
                        (g[:, 1] - 1.0) * state["height"] / (gh - 3.0)], -1)


def _residual(state, g, x):
    """Central: normalized ray direction minus the point's direction.
    Noncentral: the point's offset from the pixel's line."""
    u = field(state["directions"], g)
    d = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    if state.get("origins") is None:
        return d - x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    v = x - field(state["origins"], g)
    return v - torch.sum(v * d, -1, keepdim=True) * d


def _converged(state, r, x):
    err = torch.linalg.vector_norm(r, dim=-1)
    if state.get("origins") is None:
        return err < CENTRAL_TOL
    return err < NONCENTRAL_TOL * torch.linalg.vector_norm(x, dim=-1)


def _project_block(state, x, start_px):
    lo = to_grid(state, torch.zeros(1, 2, dtype=x.dtype, device=x.device))
    hi = to_grid(state, torch.tensor(
        [[state["width"] - 1 + 0.999, state["height"] - 1 + 0.999]],
        dtype=x.dtype, device=x.device))
    g = torch.minimum(torch.maximum(to_grid(state, start_px), lo), hi)
    for _ in range(GN_ITERATIONS):
        r, jx, jy, (a, b, c, det) = _linearized(state, g, x)
        gx, gy = (jx * r).sum(-1), (jy * r).sum(-1)
        step = torch.stack([(c * gx - b * gy) / det, (a * gy - b * gx) / det],
                           -1)
        g = torch.minimum(torch.maximum(g - step, lo), hi)
    ok = _converged(state, _residual(state, g, x), x)
    return g, ok


def _linearized(state, g, x):
    """The residual at grid coords g, its central-difference derivatives
    by g's x and y, and the entries (a, b, c) and determinant of their
    2×2 normal matrix."""
    ex = torch.tensor([FD_STEP, 0.0], dtype=x.dtype, device=x.device)
    ey = torch.tensor([0.0, FD_STEP], dtype=x.dtype, device=x.device)
    r = _residual(state, g, x)
    jx = (_residual(state, g + ex, x) - _residual(state, g - ex, x)) \
        / (2 * FD_STEP)
    jy = (_residual(state, g + ey, x) - _residual(state, g - ey, x)) \
        / (2 * FD_STEP)
    a, b, c = (jx * jx).sum(-1), (jx * jy).sum(-1), (jy * jy).sum(-1)
    det = a * c - b * b
    det = torch.where(det.abs() > 1e-300, det, torch.ones_like(det))
    return r, jx, jy, (a, b, c, det)


def _pixel_jacobian(state, g, x):
    """(N, 2, 3) derivative of the pixel by the camera-frame point at the
    solution g of the projection's equations: dg/dx = −(JᵀJ)⁻¹Jᵀ·∂r/∂x
    (J = ∂r/∂g; the residual is 0 there), scaled from grid to pixels."""
    _r, jx, jy, (a, b, c, det) = _linearized(state, g, x)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    if state.get("origins") is None:
        n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        u = x / n
        dr = -(eye - u[:, :, None] * u[:, None, :]) / n[:, :, None]
    else:
        d = field(state["directions"], g)
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        dr = eye - d[:, :, None] * d[:, None, :]
    tx = torch.einsum("nc,ncj->nj", jx, dr)
    ty = torch.einsum("nc,ncj->nj", jy, dr)
    gh, gw = state["directions"].shape[:2]
    sx, sy = state["width"] / (gw - 3.0), state["height"] / (gh - 3.0)
    return -torch.stack([sx * (c[:, None] * tx - b[:, None] * ty) / det[:, None],
                         sy * (a[:, None] * ty - b[:, None] * tx)
                         / det[:, None]], 1)


def project(state, x_cam, start_px, block=BLOCK_ROWS, jacobian=False):
    """Pixels (N, 2) of camera-frame points (N, 3) and whether each
    projects (converges inside the calibrated area), from ``start_px``;
    with ``jacobian``, also the pixels' (N, 2, 3) derivatives by the
    points."""
    pxs, oks, jacs = [], [], []
    for i in range(0, x_cam.shape[0], block):
        x = x_cam[i:i + block]
        g, ok = _project_block(state, x, start_px[i:i + block])
        pxs.append(to_pixel(state, g))
        oks.append(ok)
        if jacobian:
            jacs.append(_pixel_jacobian(state, g, x))
    out = torch.cat(pxs), torch.cat(oks)
    return out + (torch.cat(jacs),) if jacobian else out


def huber(sq):
    return torch.where(sq < 1.0, 0.5 * sq,
                       torch.sqrt(torch.clamp_min(sq, 1.0)) - 0.5)


def _skew(v):
    z = torch.zeros_like(v[:, 0])
    return torch.stack([torch.stack([z, -v[:, 2], v[:, 1]], -1),
                        torch.stack([v[:, 2], z, -v[:, 0]], -1),
                        torch.stack([-v[:, 1], v[:, 0], z], -1)], -2)


def _decrement(h, grad):
    """Σ ½·gᵀH⁻¹g over a batch of normal equations (pseudo-inverse: a
    point seen from one view has no depth)."""
    step = (torch.linalg.pinv(h, hermitian=True, rtol=1e-12)
            @ grad[:, :, None])[:, :, 0]
    return 0.5 * float((grad * step).sum())


def evaluate(state, pixel, kept, block=BLOCK_ROWS, precision=None,
             gain=False):
    """The total Huber ``cost`` of ``state`` against the observed ``pixel``
    (M·P, 2) of the ``kept`` rows, the ``rows`` that count, the ``rms``
    error (px) of those rows and, with ``gain``, the state's step ``gain``
    (see the module's text).

    ``precision="tf32"`` evaluates the cost as a computation in TF32 would:
    the pixels (projected in float64 from the state as given) and the
    observations rounded to TF32, the residuals and their squares rounded
    to TF32, the sum in float32."""
    n_points = state["points"].shape[0]
    n_views = state["rig_q"].shape[0]
    dev, f64 = pixel.device, torch.float64
    total = torch.zeros((), dtype=f64, device=dev)
    sq_total = torch.zeros((), dtype=f64, device=dev)
    count = 0
    if gain:
        h_pt = torch.zeros((n_points, 3, 3), dtype=f64, device=dev)
        g_pt = torch.zeros((n_points, 3), dtype=f64, device=dev)
        h_view = torch.zeros((n_views, 6, 6), dtype=f64, device=dev)
        g_view = torch.zeros((n_views, 6), dtype=f64, device=dev)
        r_cam = (quat_matrix(state["cam_q"]) if state.get("cam_q") is not None
                 else torch.eye(3, dtype=f64, device=dev))
        r_view = quat_matrix(state["rig_q"])
    for i in range(0, pixel.shape[0], block):
        rows = torch.arange(i, min(i + block, pixel.shape[0]), device=dev)
        x = camera_points(state, rows, n_points)
        obs = pixel[rows]
        if gain:
            px, ok, d_px = project(state, x, obs, block=block, jacobian=True)
        else:
            px, ok = project(state, x, obs, block=block)
        use = kept[rows] & ok
        if precision == "tf32":
            r = round_tf32(round_tf32(px.float()) - round_tf32(obs.float()))
            sq = round_tf32((r * r).sum(-1))
            c = huber(sq)
            total = total + torch.where(use, c, 0.0).sum().double()
        else:
            r = px - obs
            sq = (r ** 2).sum(-1)
            total = total + torch.where(use, huber(sq), 0.0).sum()
        sq_total = sq_total + torch.where(use, sq.double(), 0.0).sum()
        count += int(use.sum())
        if gain:
            # Huber's IRLS weight; rows that do not count weigh 0
            w = torch.where(use, torch.where(
                sq < 1.0, 1.0, torch.rsqrt(torch.clamp_min(sq, 1.0))), 0.0)
            r = torch.where(use[:, None], r.double(), 0.0)
            view = torch.div(rows, n_points, rounding_mode="floor")
            corner = rows - view * n_points
            rv = r_view[view]
            j_rig = d_px @ r_cam
            j_pt = j_rig @ rv
            xr = (rv @ state["points"][corner][:, :, None])[:, :, 0]
            j_view = torch.cat([-(j_rig @ _skew(xr)), j_rig], -1)
            for j, h, grad, idx in ((j_pt, h_pt, g_pt, corner),
                                    (j_view, h_view, g_view, view)):
                jw = j * w[:, None, None]
                h.index_add_(0, idx, jw.transpose(1, 2) @ j)
                grad.index_add_(0, idx, (jw.transpose(1, 2)
                                         @ r[:, :, None])[:, :, 0])
    out = {"cost": float(total), "rows": count,
           "rms": float(torch.sqrt(sq_total / max(count, 1)))}
    if gain:
        out["gain"] = max(_decrement(h_pt, g_pt),
                          _decrement(h_view, g_view)) / out["cost"]
    return out


def round_tf32(x):
    """float32 values rounded to TF32's 10 mantissa bits (to nearest,
    ties to even)."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def round_state(state, fn):
    """The state with every float tensor passed through ``fn`` (and back
    to float64)."""
    return {k: (fn(v).double() if torch.is_tensor(v) and v.is_floating_point()
                else v) for k, v in state.items()}

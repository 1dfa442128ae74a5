"""Parametric central camera models: ThinPrismFisheye, OpenCV, Radial-spline.

- CentralThinPrismFisheye: fx fy cx cy k1 k2 k3 k4 p1 p2 sx1 sy1, with an
  optional equidistant (fisheye) pre-step that scales the normalized
  coordinates by atan(r)/r.
- CentralOpenCV: fx fy cx cy k1..k6 p1 p2, a rational radial factor.
- CentralRadial: fx fy cx cy p1 p2 sx1 sy1 and a 1D cubic B-spline radial
  factor over the incidence angle θ ∈ [0, π/2).

Projection is closed form and batched.  Unprojection inverts the
distortion with a batched Gauss-Newton whose 2×2 Jacobians come from
``torch.func.jacfwd`` under ``torch.func.vmap``.  Fitting to a dense
direction image solves a linear least-squares problem on lifted products
of the normalized coordinates, then refines the projection residuals with
the matrix-free LM of ``ba/gn.py``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from camera_calibration_torch.config import default_device
from camera_calibration_torch.models.base import replace
from camera_calibration_torch.ops import bspline, se3
from camera_calibration_torch.ops.linalg import solve2x2


@dataclasses.dataclass(frozen=True)
class CentralThinPrismFisheyeModel:
    # fx fy cx cy k1 k2 k3 k4 p1 p2 sx1 sy1
    params: torch.Tensor
    width: int = 0
    height: int = 0
    use_equidistant_projection: bool = True

    @property
    def is_central(self):
        return True


@dataclasses.dataclass(frozen=True)
class CentralOpenCVModel:
    # fx fy cx cy k1 k2 k3 k4 k5 k6 p1 p2
    params: torch.Tensor
    width: int = 0
    height: int = 0

    @property
    def is_central(self):
        return True


@dataclasses.dataclass(frozen=True)
class CentralRadialModel:
    # fx fy cx cy p1 p2 sx1 sy1 + spline knots (resolution K)
    params: torch.Tensor
    width: int = 0
    height: int = 0

    @property
    def spline_resolution(self):
        return self.params.shape[-1] - 8

    @property
    def is_central(self):
        return True


MODELS = (CentralThinPrismFisheyeModel, CentralOpenCVModel, CentralRadialModel)


def _norm(v, keepdim=False):
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


# ----------------------------- distortion cores -----------------------------


def _tpf_distort(model: CentralThinPrismFisheyeModel, nxy):
    """Normalized (possibly fisheye) coords -> distorted coords (..., 2)."""
    p = model.params
    x, y = nxy[..., 0], nxy[..., 1]
    x2, y2, xy = x * x, y * y, x * y
    r2 = x2 + y2
    r4 = r2 * r2
    radial = p[4] * r2 + p[5] * r4 + p[6] * r4 * r2 + p[7] * r4 * r4
    dx = 2 * p[8] * xy + p[9] * (r2 + 2 * x2) + p[10] * r2
    dy = 2 * p[9] * xy + p[8] * (r2 + 2 * y2) + p[11] * r2
    return torch.stack([x + radial * x + dx, y + radial * y + dy], dim=-1)


def _fisheye_forward(nxy):
    """(x/z, y/z) -> equidistant fisheye coords: scale by atan(r)/r."""
    r = _norm(nxy, keepdim=True)
    safe_r = torch.clamp_min(r, 1e-12)
    return nxy * torch.arctan(safe_r) / safe_r


def _fisheye_inverse(fxy):
    """Fisheye coords (|.| = θ) -> (x/z, y/z): scale by tan(θ)/θ."""
    theta = _norm(fxy, keepdim=True)
    safe = torch.clamp_min(theta, 1e-12)
    scale = torch.where(theta > 1e-8, torch.tan(safe) / safe, 1.0)
    return fxy * scale


def _opencv_distort(model: CentralOpenCVModel, nxy):
    p = model.params
    x, y = nxy[..., 0], nxy[..., 1]
    x2, y2, xy = x * x, y * y, x * y
    r2 = x2 + y2
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1 + p[4] * r2 + p[5] * r4 + p[6] * r6) / (
        1 + p[7] * r2 + p[8] * r4 + p[9] * r6
    )
    dx = 2 * p[10] * xy + p[11] * (r2 + 2 * x2)
    dy = 2 * p[11] * xy + p[10] * (r2 + 2 * y2)
    return torch.stack([x * radial + dx, y * radial + dy], dim=-1)


def _radial_factor(model: CentralRadialModel, theta):
    """1D B-spline factor over θ: the 4 knots from ``chunk - 1`` weighted
    by the cubic basis of the fractional position."""
    k = model.spline_resolution
    pos = 1.0 + (k - 3.0) / (math.pi / 2) * theta
    chunk = torch.clamp(torch.floor(pos).to(torch.int64), 1, k - 3)
    frac = pos - chunk.to(pos.dtype)
    knots = model.params[8:]
    win = knots[(chunk - 1)[..., None] + torch.arange(4, device=theta.device)]
    return torch.sum(bspline.cubic_bspline_weights(frac) * win, dim=-1)


def _radial_distort(model: CentralRadialModel, nxy, theta):
    p = model.params
    x, y = nxy[..., 0], nxy[..., 1]
    x2, y2, xy = x * x, y * y, x * y
    r2 = x2 + y2
    factor = _radial_factor(model, theta)
    dx = 2 * p[4] * xy + p[5] * (r2 + 2 * x2) + p[6] * r2
    dy = 2 * p[5] * xy + p[4] * (r2 + 2 * y2) + p[7] * r2
    return torch.stack([x + factor * x + dx, y + factor * y + dy], dim=-1)


# ------------------------------- projection -------------------------------


def _apply_fc(model, dxy):
    p = model.params
    return torch.stack(
        [p[0] * dxy[..., 0] + p[2], p[1] * dxy[..., 1] + p[3]], dim=-1)


def _inner_distort(model, nxy, theta=None):
    if isinstance(model, CentralThinPrismFisheyeModel):
        if model.use_equidistant_projection:
            nxy = _fisheye_forward(nxy)
        return _tpf_distort(model, nxy)
    if isinstance(model, CentralOpenCVModel):
        return _opencv_distort(model, nxy)
    if isinstance(model, CentralRadialModel):
        return _radial_distort(model, nxy, theta)
    raise TypeError(type(model))


def project_points(model, points, init_xy=None, max_iterations=None):
    """Camera-space points (N, 3) -> (pixels, pixels, valid).

    Closed form; ``init_xy`` and ``max_iterations`` are accepted so that the
    call matches the grid models'.  ``valid`` needs z > 0 and the pixel
    inside the image.
    """
    z = points[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, 1e-12)
    nxy = points[..., :2] / safe_z[..., None]
    if isinstance(model, CentralRadialModel):
        norm = _norm(points)
        cos_t = torch.clamp(z / torch.clamp_min(norm, 1e-18), -1.0, 1.0)
        dxy = _inner_distort(model, nxy, torch.arccos(cos_t))
    else:
        dxy = _inner_distort(model, nxy)
    px = _apply_fc(model, dxy)
    valid = (
        (z > 1e-12)
        & (px[..., 0] >= 0)
        & (px[..., 0] < model.width)
        & (px[..., 1] >= 0)
        & (px[..., 1] < model.height)
    )
    return px, px, valid


def project_directions(model, dirs, **kw):
    return project_points(model, dirs, **kw)


def unproject(model, pixels, max_iterations: int = 20):
    """Pixel-corner coords (N, 2) -> (unit directions (N, 3), valid).

    Gauss-Newton on the normalized coordinates (x/z, y/z), from the
    undistorted guess, for ``max_iterations`` steps; a pixel is valid where
    the distortion of the result is within 1e-6 of the target.  For the
    Radial model θ is recomputed from (x/z, y/z) at every step.
    """
    p = model.params
    target = torch.stack(
        [(pixels[..., 0] - p[2]) / p[0], (pixels[..., 1] - p[3]) / p[1]],
        dim=-1)

    def distort_of_nxy(nxy):
        if isinstance(model, CentralRadialModel):
            d = torch.cat([nxy, torch.ones_like(nxy[..., :1])], -1)
            theta = torch.arccos(torch.clamp(1.0 / _norm(d), -1.0, 1.0))
            return _radial_distort(model, nxy, theta)
        return _inner_distort(model, nxy)

    def f_single(v):
        return distort_of_nxy(v[None])[0]

    jac_fn = torch.func.vmap(torch.func.jacfwd(f_single))
    eye = torch.eye(2, dtype=target.dtype, device=target.device)
    x = target
    for _ in range(int(max_iterations)):
        jac = jac_fn(x)
        r = distort_of_nxy(x) - target
        h = torch.einsum("nij,nik->njk", jac, jac) + 1e-12 * eye
        b = torch.einsum("nij,ni->nj", jac, r)
        x = x - solve2x2(h, b)
    valid = _norm(distort_of_nxy(x) - target) < 1e-6
    # distort_of_nxy includes the fisheye pre-step of a TPF model, so x is
    # the undistorted (x/z, y/z)
    d = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    return d / _norm(d, keepdim=True), valid


# --------------------------------- fitting ---------------------------------


def _axis_solve(coord, rows, ones):
    a = np.stack(rows + [ones], -1)
    sol, *_ = np.linalg.lstsq(a, coord, rcond=None)
    return sol


def _linear_init(model_template, px, nxy):
    """Initial parameters from linear least squares on the sampled pixels:
    every distortion term is a known polynomial of the (fisheye-mapped)
    normalized coordinates, so each pixel axis is linear in the lifted
    unknowns (fx, fx·k1, …, cx)."""
    if (isinstance(model_template, CentralThinPrismFisheyeModel)
            and model_template.use_equidistant_projection):
        rr = np.linalg.norm(nxy, axis=-1)
        theta = np.arctan(rr)
        scale = np.where(rr > 1e-12, theta / np.maximum(rr, 1e-12), 1.0)
        base = nxy * scale[:, None]
    else:
        base = nxy
    x_, y_ = base[:, 0], base[:, 1]
    r2 = x_ * x_ + y_ * y_
    r4, r6, r8 = r2 * r2, r2 ** 3, r2 ** 4
    xy = x_ * y_
    ones = np.ones_like(x_)

    params0 = np.zeros(model_template.params.shape[-1])
    if isinstance(model_template, CentralThinPrismFisheyeModel):
        # px = fx·(x + k·radial + 2p1·xy + p2(r²+2x²) + sx1·r²) + cx
        sx_sol = _axis_solve(px[:, 0], [
            x_, x_ * r2, x_ * r4, x_ * r6, x_ * r8,
            2 * xy, r2 + 2 * x_ * x_, r2,
        ], ones)
        sy_sol = _axis_solve(px[:, 1], [
            y_, y_ * r2, y_ * r4, y_ * r6, y_ * r8,
            r2 + 2 * y_ * y_, 2 * xy, r2,
        ], ones)
        fx, cx = sx_sol[0], sx_sol[-1]
        fy, cy = sy_sol[0], sy_sol[-1]
        if abs(fx) > 1e-9 and abs(fy) > 1e-9:
            params0[4:8] = 0.5 * (sx_sol[1:5] / fx + sy_sol[1:5] / fy)
            params0[8] = 0.5 * (sx_sol[5] / fx + sy_sol[6] / fy)
            params0[9] = 0.5 * (sx_sol[6] / fx + sy_sol[5] / fy)
            params0[10] = sx_sol[7] / fx
            params0[11] = sy_sol[7] / fy
    elif isinstance(model_template, CentralOpenCVModel):
        # the numerator polynomial and the tangential part; the rational
        # denominator k4..k6 starts at 0
        sx_sol = _axis_solve(px[:, 0], [
            x_, x_ * r2, x_ * r4, x_ * r6, 2 * xy, r2 + 2 * x_ * x_,
        ], ones)
        sy_sol = _axis_solve(px[:, 1], [
            y_, y_ * r2, y_ * r4, y_ * r6, r2 + 2 * y_ * y_, 2 * xy,
        ], ones)
        fx, cx = sx_sol[0], sx_sol[-1]
        fy, cy = sy_sol[0], sy_sol[-1]
        if abs(fx) > 1e-9 and abs(fy) > 1e-9:
            params0[4:7] = 0.5 * (sx_sol[1:4] / fx + sy_sol[1:4] / fy)
            params0[10] = 0.5 * (sx_sol[4] / fx + sy_sol[5] / fy)  # p1
            params0[11] = 0.5 * (sx_sol[5] / fx + sy_sol[4] / fy)  # p2
    else:
        # Radial: a pinhole from the central 30% of the field (the spline
        # takes the radial profile during the LM refinement)
        rr = np.linalg.norm(nxy, axis=-1)
        central = rr < max(np.percentile(rr, 30), 1e-3)
        a = np.zeros((2 * int(central.sum()), 4))
        a[0::2, 0] = nxy[central, 0]
        a[0::2, 2] = 1.0
        a[1::2, 1] = nxy[central, 1]
        a[1::2, 3] = 1.0
        sol, *_ = np.linalg.lstsq(a, px[central].reshape(-1), rcond=None)
        fx, fy, cx, cy = sol
    params0[:4] = [fx, fy, cx, cy]
    return params0


def fit_parametric_to_dense(
    model_template,
    dense_dirs,
    valid,
    *,
    max_sample_count: int = 20000,
    max_iterations: int = 50,
    dtype=torch.float64,
    co_estimate_rotation: bool = False,
    pixel_coords=None,
    device=None,
):
    """Fit a parametric model to a dense (H, W, 3) direction image (numpy
    arrays).

    At most ``max_sample_count`` valid pixels (every ``stride``-th), at the
    pixel centers or at ``pixel_coords`` (H, W, 2) where given; a linear
    initialisation (:func:`_linear_init`), then LM on the projection
    residuals.  With ``co_estimate_rotation`` a rotation of the direction
    field is estimated jointly and ``(model, quaternion)`` is returned.
    Tensors are made on ``device`` (default: the card).
    """
    from camera_calibration_torch.ba.gn import lm_solve

    device = default_device(device)
    dense_dirs = np.asarray(dense_dirs, np.float64)
    valid = np.asarray(valid, bool)
    vy, vx = np.nonzero(valid)
    stride = max(1, vy.size // max_sample_count)
    sel = np.arange(0, vy.size, stride)
    if pixel_coords is not None:
        px = np.asarray(pixel_coords, np.float64)[vy[sel], vx[sel]]
    else:
        px = np.stack([vx[sel] + 0.5, vy[sel] + 0.5], -1)
    d = dense_dirs[vy[sel], vx[sel]]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    front = d[:, 2] > 1e-6
    px, d = px[front], d[front]
    nxy = d[:, :2] / d[:, 2:3]

    n_params = model_template.params.shape[-1]
    model = replace(model_template, params=torch.as_tensor(
        _linear_init(model_template, px, nxy), dtype=dtype, device=device))
    pts = torch.as_tensor(d, dtype=dtype, device=device)
    target_px = torch.as_tensor(px, dtype=dtype, device=device)

    def residual(params, dirs):
        pred, _, pvalid = project_points(replace(model, params=params), dirs)
        return ((pred - target_px) * pvalid[:, None]).reshape(-1)

    if not co_estimate_rotation:
        result = lm_solve(
            lambda params: residual(params, pts),
            lambda params, delta: params + delta,
            model.params, torch.zeros_like(model.params),
            max_iterations=max_iterations, cg_iterations=2 * n_params)
        return replace(model, params=result.state)

    # State (params, quaternion q): the directions are rotated by q before
    # projection, and the tangent's 3-vector rotates q on the left.
    def retract2(state, delta):
        params, q = state
        dp, dw = delta
        return params + dp, se3.quat_mul(se3.quat_exp(dw), q)

    q0 = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)
    result = lm_solve(
        lambda state: residual(state[0], se3.quat_rotate(state[1], pts)),
        retract2,
        (model.params, q0),
        (torch.zeros_like(model.params),
         torch.zeros(3, dtype=dtype, device=device)),
        max_iterations=max_iterations, cg_iterations=2 * n_params + 6)
    params_f, q_f = result.state
    return replace(model, params=params_f), q_f

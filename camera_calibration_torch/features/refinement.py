"""Sub-pixel corner refinement on the whole image: 8-DoF symmetry and
matching stages, batched over features.

The counterpart of the reference package's ``features/refinement.py``,
which the detector's gradient mode uses (the intensity mode runs the
patch-resident form, ``patch_refinement.py``):

- *symmetry* stage: optimize the full local 8-DoF homography
  ``pixel_tr_pattern`` so that the image is symmetric around the feature:
  single-channel residual I(H·s) − I(−H·s), or gradient residual
  ∇I(H·s) + ∇I(−H·s); LM with λ·{0.5, 2}, 30 iterations, and a divergence
  check against the original window;
- *matching* stage: the known pattern rendered through the local
  homography, optimizing position + affine intensity (4 DoF), after a
  coarse 7×7 translation search.

All features iterate together: the per-feature 8×8 (or 4×4) normal
equations come from one batched einsum over samples and one batched
Cholesky solve, with a per-feature λ/accept state.  Every iteration is
tensor code on the image's device, with no host synchronisation inside the
loops; the iteration counts are fixed, as in the reference package.
"""

from __future__ import annotations

import torch

from camera_calibration_torch.ops import interp, linalg


def make_sample_offsets(rng, window_half_size: int, count: int | None = None):
    """Random sample offsets in [−1, 1]² (scaled by the window at use time):
    by default a pool of 8·(2w+1)² uniform samples, drawn from ``rng``
    (a NumPy generator)."""
    if count is None:
        count = 8 * (2 * window_half_size + 1) ** 2
    return rng.uniform(-1.0, 1.0, (count, 2))


def apply_h(h, pts):
    """Apply homographies (N, 3, 3) to points (N, S, 2) -> (N, S, 2)."""
    x = pts[..., 0]
    y = pts[..., 1]
    px = h[:, None, 0, 0] * x + h[:, None, 0, 1] * y + h[:, None, 0, 2]
    py = h[:, None, 1, 0] * x + h[:, None, 1, 1] * y + h[:, None, 1, 2]
    pw = h[:, None, 2, 0] * x + h[:, None, 2, 1] * y + h[:, None, 2, 2]
    safe = torch.where(torch.abs(pw) > 1e-12, pw, 1e-12)
    return torch.stack([px / safe, py / safe], dim=-1)


def initial_homography(pixel_tr_pattern, positions):
    """``pixel_tr_pattern`` with its translation set to the feature
    position and scaled so that h[2, 2] = 1."""
    h0 = pixel_tr_pattern.clone()
    h0[:, 0, 2] = positions[:, 0] * h0[:, 2, 2]
    h0[:, 1, 2] = positions[:, 1] * h0[:, 2, 2]
    return h0 / h0[:, 2:3, 2:3]


def position_wrt_homography(h, s):
    """d(H·s)/d(h00, h01, h02, h10, h11, h12, h20, h21): (N, S, 2, 8) for
    homographies (N, 3, 3) with h22 = 1 and points (N, S, 2)."""
    x = s[..., 0]
    y = s[..., 1]
    denom = h[:, None, 2, 0] * x + h[:, None, 2, 1] * y + 1.0
    t0 = 1.0 / denom
    t1 = -t0 * t0
    num_x = h[:, None, 0, 0] * x + h[:, None, 0, 1] * y + h[:, None, 0, 2]
    num_y = h[:, None, 1, 0] * x + h[:, None, 1, 1] * y + h[:, None, 1, 2]
    t2 = num_x * t1
    t3 = num_y * t1
    zeros = torch.zeros_like(x)
    row0 = torch.stack([x * t0, y * t0, t0, zeros, zeros, zeros, x * t2,
                        y * t2], -1)
    row1 = torch.stack([zeros, zeros, zeros, x * t0, y * t0, t0, x * t3,
                        y * t3], -1)
    return torch.stack([row0, row1], dim=-2)


def lm_step(big_h, b, lam, k):
    """The damped step of every feature: λ starts at 1e-3 of the mean
    diagonal; a non-finite step is 0.  Returns (step (N, k), λ)."""
    diag_mean = torch.diagonal(big_h, dim1=-2, dim2=-1).sum(-1) / k
    lam = torch.where(lam < 0, 1e-3 * diag_mean, lam)
    eye = torch.eye(k, dtype=big_h.dtype, device=big_h.device)
    step = linalg.cholesky_solve_small(big_h + lam[:, None, None] * eye, b)
    return torch.where(torch.isfinite(step), step, 0.0), lam


def update_homography(h, step):
    """h minus the 8-vector step on its first eight entries."""
    pad = torch.zeros_like(step[:, :1])
    return h - torch.cat([step, pad], dim=1).reshape(-1, 3, 3)


def diverged(pos, positions, window_half_size):
    """Features that left their original window."""
    return torch.any(torch.abs(pos - positions) >= window_half_size, dim=-1)


def coarse_offsets(search_radius_px, dtype, device):
    """The 7×7 translation offsets of the matching stage's coarse search,
    x fastest: (49, 2)."""
    lin = torch.linspace(-search_radius_px, search_radius_px, 7,
                         dtype=dtype, device=device)
    oy, ox = torch.meshgrid(lin, lin, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], -1)


def refine_features_symmetry(image, positions, pixel_tr_pattern,
                             pattern_samples, sample_valid, window_half_size,
                             num_iterations: int = 30,
                             use_gradient: bool = False):
    """Batched symmetry refinement on the whole image.

    image: (H, W), or (H, W, 2) gradient image if ``use_gradient``.
    positions: (N, 2) initial positions, pixel-center convention.
    pixel_tr_pattern: (N, 3, 3) local homography pattern→pixel; its
      translation column is replaced by the feature position.
    pattern_samples: (N, S, 2) sample positions in pattern space.
    sample_valid: (N, S) bool mask for padded samples.
    Returns (positions (N, 2), final_cost (N,), converged (N,) bool).
    """
    dtype = image.dtype
    img_shape = image.shape
    sm = sample_valid.to(dtype)

    def cost_of(h):
        pa = apply_h(h, pattern_samples)
        pb = apply_h(h, -pattern_samples)
        ia = interp.bilinear(image, pa)
        ib = interp.bilinear(image, pb)
        ok = interp.in_bounds(img_shape, pa) & interp.in_bounds(img_shape, pb)
        if use_gradient:
            r = ia + ib  # gradients cancel at mirrored points
            sq = torch.sum(r * r, dim=-1)
        else:
            r = ia - ib
            sq = r * r
        valid_all = torch.all(ok | ~sample_valid, dim=1)
        cost = torch.sum(sq * sm * ok.to(dtype), dim=1)
        return torch.where(valid_all, cost, torch.inf)

    def one_side(h, sign):
        s = sign * pattern_samples
        pos = apply_h(h, s)
        val, grad = interp.bilinear_with_jacobian(image, pos)
        if not use_gradient:
            val, grad = val[..., None], grad[..., None, :]
        jac = torch.einsum("nscd,nsdk->nsck", grad,
                           position_wrt_homography(h, s))
        return val, jac, interp.in_bounds(img_shape, pos)

    def h_and_b(h):
        va, ja, oka = one_side(h, 1.0)
        vb, jb, okb = one_side(h, -1.0)
        if use_gradient:
            r, jac = va + vb, ja + jb
        else:
            r, jac = va - vb, ja - jb
        w = (sm * (oka & okb).to(dtype))[..., None]  # (N, S, 1)
        big_h = torch.einsum("nscj,nsck,nsc->njk", jac, jac,
                             w[..., 0:1] * torch.ones_like(r))
        b = torch.einsum("nscj,nsc->nj", jac, r * w)
        cost = torch.sum(r * r * w, dim=(1, 2))
        valid = torch.all((oka & okb) | ~sample_valid, dim=1)
        return big_h, b, torch.where(valid, cost, torch.inf), valid

    return _symmetry_loop(initial_homography(pixel_tr_pattern, positions),
                          positions, h_and_b, cost_of, window_half_size,
                          num_iterations)


def _symmetry_loop(h, positions, h_and_b, cost_of, window_half_size,
                   num_iterations):
    """The symmetry stage's LM loop over the 8 free entries of the
    homographies ``h`` (N, 3, 3), shared by the whole-image and patch
    forms: ``h_and_b(h)`` gives the normal equations, the cost and the
    validity at ``h``, ``cost_of(h)`` the cost of a test point.  Returns
    (positions, best cost, converged)."""
    n = positions.shape[0]
    lam = torch.full((n,), -1.0, dtype=h.dtype, device=h.device)
    best_cost = torch.full((n,), torch.inf, dtype=h.dtype, device=h.device)
    active = torch.ones((n,), dtype=torch.bool, device=h.device)
    for _ in range(num_iterations):
        big_h, b, cost, valid = h_and_b(h)
        step, lam = lm_step(big_h, b, lam, 8)
        h_test = update_homography(h, step)
        test_cost = cost_of(h_test)
        accept = (test_cost < cost) & active & valid
        h = torch.where(accept[:, None, None], h_test, h)
        lam = torch.where(accept, 0.5 * lam, 2.0 * lam)
        best_cost = torch.minimum(best_cost,
                                  torch.where(valid, cost, torch.inf))
        best_cost = torch.where(accept, test_cost, best_cost)
        active = active & ~diverged(h[:, 0:2, 2], positions,
                                    window_half_size) & valid
    return h[:, 0:2, 2], best_cost, active & torch.isfinite(best_cost)


def refine_features_matching(image, positions, pixel_tr_pattern,
                             pattern_samples, rendered, sample_valid,
                             window_half_size, num_iterations: int = 10,
                             search_radius_px: float = 3.0):
    """Batched matching refinement on the whole image: position (2) +
    affine intensity (2).

    rendered: (N, S) pattern intensities at ``pattern_samples``.  Optimizes
    ``I(pos + H·s) ≈ fac·rendered + bias`` over (dx, dy, fac, bias) after a
    coarse search over a 7×7 offset grid of ±``search_radius_px``.
    Returns (positions, cost, converged).
    """
    n = positions.shape[0]
    dtype = image.dtype
    img_shape = image.shape
    h_rel = pixel_tr_pattern / pixel_tr_pattern[:, 2:3, 2:3]
    h_rel[:, 0:2, 2] = 0.0
    disp = apply_h(h_rel, pattern_samples)  # (N, S, 2)

    def cost_of(pos, fac, bias):
        """Cost at positions (N, 2) or (N, K, 2) for K candidates each."""
        p = pos[..., None, :] + (disp[:, None] if pos.dim() == 3 else disp)
        return matching_cost(interp.bilinear(image, p),
                             interp.in_bounds(img_shape, p), rendered,
                             sample_valid, fac, bias)

    def jacobian(pos, fac, bias):
        p = pos[:, None, :] + disp
        val, grad = interp.bilinear_with_jacobian(image, p)
        return matching_jacobian(val, grad, interp.in_bounds(img_shape, p),
                                 rendered, sample_valid, fac, bias)

    return _matching_loop(positions, n, dtype, image.device, cost_of,
                          jacobian, window_half_size, num_iterations,
                          search_radius_px)


def matching_cost(val, ok, rendered, sample_valid, fac, bias):
    """The matching stage's cost of samples ``val``/``ok`` (N, S), or
    (N, K, S) for K candidate positions each: the sum of squared masked
    residuals against ``fac·rendered + bias``, inf where a valid sample
    is out of bounds."""
    pred = fac[:, None] * rendered + bias[:, None]
    svalid = sample_valid
    if val.dim() == 3:
        pred, svalid = pred[:, None], svalid[:, None]
    r = (val - pred) * (svalid.to(val.dtype) * ok.to(val.dtype))
    valid = torch.all(ok | ~svalid, dim=-1)
    return torch.where(valid, torch.sum(r * r, dim=-1), torch.inf)


def matching_jacobian(val, grad, ok, rendered, sample_valid, fac, bias):
    """The matching stage's masked residuals (N, S) and their Jacobian
    (N, S, 4) over (dx, dy, fac, bias)."""
    w = (sample_valid.to(val.dtype) * ok.to(val.dtype))[..., None]
    r = (val - (fac[:, None] * rendered + bias[:, None])) * w[..., 0]
    jac = torch.cat([grad * w, -rendered[..., None] * w,
                     -torch.ones_like(rendered)[..., None] * w], dim=-1)
    return jac, r


def _matching_loop(positions, n, dtype, device, cost_of, jacobian,
                   window_half_size, num_iterations, search_radius_px):
    """The matching stage's coarse search and LM loop over (position,
    fac, bias), shared by the whole-image and patch forms."""
    ones = torch.ones((n,), dtype=dtype, device=device)
    zeros = torch.zeros((n,), dtype=dtype, device=device)
    if search_radius_px > 0:
        offsets = coarse_offsets(search_radius_px, dtype, device)
        costs = cost_of(positions[:, None, :] + offsets, ones, zeros)
        # the first minimum, as the reference package's argmin
        pos = positions + offsets[torch.argmin(costs, dim=1)]
    else:
        pos = positions
    fac, bias = ones, zeros
    lam = torch.full((n,), -1.0, dtype=dtype, device=device)
    active = torch.ones((n,), dtype=torch.bool, device=device)
    for _ in range(num_iterations):
        jac, r = jacobian(pos, fac, bias)
        big_h = torch.einsum("nsj,nsk->njk", jac, jac)
        b = torch.einsum("nsj,ns->nj", jac, r)
        step, lam = lm_step(big_h, b, lam, 4)
        t_pos, t_fac, t_bias = pos - step[:, :2], fac - step[:, 2], \
            bias - step[:, 3]
        cost = cost_of(pos, fac, bias)
        test_cost = cost_of(t_pos, t_fac, t_bias)
        accept = (test_cost < cost) & active
        pos = torch.where(accept[:, None], t_pos, pos)
        fac = torch.where(accept, t_fac, fac)
        bias = torch.where(accept, t_bias, bias)
        lam = torch.where(accept, 0.5 * lam, 2.0 * lam)
        active = active & ~diverged(pos, positions, window_half_size)
    final_cost = cost_of(pos, fac, bias)
    return pos, final_cost, active & torch.isfinite(final_cost)

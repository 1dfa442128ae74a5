"""Patch-resident corner refinement: the detector's intensity-mode path.

The counterpart of the reference package's ``features/patch_refinement.py``.
A small square patch around every feature is cut from the image once per
stage, and the LM loops of ``refinement.py`` (the same residuals,
accept/reject and divergence checks) sample inside it.

The reference package samples a patch through linear B-spline ("hat")
weight matrices contracted against the patch rows, because gathers are the
one access pattern its TPU handles badly.  On the card a four-tap gather
from the patch is the idiom, at ~1/50 of the operations: :func:`sample_patches`
reads the taps at floor(x) and floor(x) + 1 (a tap outside the patch reads
0) with the hat form's weights and its piecewise-constant derivative, so
the two forms agree in exact arithmetic, at the patch edges too.  The
reference package runs its contraction at bf16×3 precision on its chip;
this port keeps full float32, so card results differ from that chip's by
~1e-5 px.
"""

from __future__ import annotations

import numpy as np
import torch

from camera_calibration_torch.features.refinement import (
    _matching_loop, _symmetry_loop, apply_h, initial_homography,
    matching_cost, matching_jacobian, position_wrt_homography)


def patch_size_for_window(window_half_size: int) -> int:
    """Patch edge covering the window samples (±whs), the LM drift (< whs)
    and the matching stage's coarse search (±3 px), rounded up to a
    multiple of 8."""
    p = 2 * (2 * window_half_size + 5) + 2
    return ((p + 7) // 8) * 8


def patch_origins(image_shape, centers: np.ndarray, patch: int):
    """Integer top-left origins of patches around float centers, clamped so
    every patch lies inside the image.  Returns (x0, y0) int64."""
    h, w = image_shape
    half = (patch - 2) // 2
    c = np.nan_to_num(np.asarray(centers), nan=0.0, posinf=0.0, neginf=0.0)
    x0 = np.clip(np.round(c[:, 0]).astype(np.int64) - half, 0, w - patch)
    y0 = np.clip(np.round(c[:, 1]).astype(np.int64) - half, 0, h - patch)
    return x0, y0


def extract_patches_host(image: np.ndarray, centers: np.ndarray, patch: int):
    """(N, P, P) patches around float centers from a host image, aligned
    so that patch-local coords are image coords minus the origin.
    Returns (patches (N, P, P), origins (N, 2) float64)."""
    x0, y0 = patch_origins(image.shape, centers, patch)
    windows = np.lib.stride_tricks.sliding_window_view(image, (patch, patch))
    patches = np.ascontiguousarray(windows[y0, x0])
    origins = np.stack([x0, y0], axis=-1).astype(np.float64)
    return patches, origins


def extract_patches_device(image, y0x0, patch: int, image_idx=None):
    """(N, P, P) patches of a (H, W) image, or of a stacked (B, H, W) batch
    with per-feature ``image_idx`` (N,), by one gather on the image's
    device.  y0x0: (N, 2) integer (row, col) origins inside
    [0, H−P]×[0, W−P] (see :func:`patch_origins`)."""
    r = torch.arange(patch, device=image.device)
    yy = y0x0[:, 0].long()[:, None, None] + r[:, None]
    xx = y0x0[:, 1].long()[:, None, None] + r[None, :]
    if image.dim() == 2:
        return image[yy, xx]
    return image[image_idx.long()[:, None, None], yy, xx]


def _taps(coord, p):
    """Taps floor(c) and floor(c) + 1 of coordinates clipped to
    [0, p−1], with the hat weights max(0, 1 − |c − j|) of both."""
    c = torch.clamp(coord, 0.0, p - 1.0)
    i0 = torch.floor(c)
    w0 = torch.clamp(1.0 - torch.abs(c - i0), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(c - (i0 + 1.0)), min=0.0)
    return i0.long(), w0, w1


def sample_patches(patches, xy, with_grad: bool = True):
    """Bilinear patch sampling by a four-tap gather.

    patches (N, P, P) [row = y, col = x]; xy (N, S, 2) patch-local
    pixel-center coords.  Returns (val (N, S), grad (N, S, 2) or None,
    valid (N, S)): ``valid`` is taken before the coordinates are clipped to
    the patch; taps past its last row or column read 0, and the gradient
    is the hat form's (−1 at the lower tap, +1 at the upper), so at
    x = P−1 exactly d/dx is −patch[y, P−1].
    """
    n, p, _ = patches.shape
    x = xy[..., 0]
    y = xy[..., 1]
    valid = (x >= 0.0) & (x <= p - 1.0) & (y >= 0.0) & (y <= p - 1.0)
    ix, wx0, wx1 = _taps(x, p)
    iy, wy0, wy1 = _taps(y, p)
    in_x = ix + 1 < p
    in_y = iy + 1 < p
    ix1 = torch.clamp(ix + 1, max=p - 1)
    iy1 = torch.clamp(iy + 1, max=p - 1)
    flat = patches.reshape(n, p * p)

    def at(row, col):
        return torch.gather(flat, 1, row * p + col)

    zero = torch.zeros((), dtype=patches.dtype, device=patches.device)
    p00 = at(iy, ix)
    p01 = torch.where(in_x, at(iy, ix1), zero)
    p10 = torch.where(in_y, at(iy1, ix), zero)
    p11 = torch.where(in_x & in_y, at(iy1, ix1), zero)
    row0 = wx0 * p00 + wx1 * p01
    row1 = wx0 * p10 + wx1 * p11
    val = wy0 * row0 + wy1 * row1
    if not with_grad:
        return val, None, valid
    gx = wy0 * (-p00 + p01) + wy1 * (-p10 + p11)
    gy = -row0 + row1
    return val, torch.stack([gx, gy], dim=-1), valid


def _apply_h_local(h, pts, origins):
    """``apply_h(h, pts) − origins``, computed as the homography
    T(−origin)·h applied to the points: the patch-local coordinates come
    out of sums of numbers the patch's size, not of image coordinates, so
    in float32 they keep ~1e-6 px where the difference form rounds to the
    6e-5 px of an image coordinate near 1000 — noise that the symmetry
    cost, with edge gradients near 0.5 a pixel, turns into ~1e-4 relative
    and that decides accept tests along its flat valleys."""
    rows = h[:, :2, :] - origins[:, :, None] * h[:, 2:3, :]
    return apply_h(torch.cat([rows, h[:, 2:3, :]], dim=1), pts)


def refine_symmetry_patches(patches, origins, positions, pixel_tr_pattern,
                            pattern_samples, sample_valid, window_half_size,
                            num_iterations: int = 30):
    """Batched 8-DoF symmetry refinement on per-feature patches.

    The optimization of ``refinement.refine_features_symmetry`` (single
    channel) with every image read a patch sample.  Positions and
    homographies stay in image space; ``origins`` (N, 2) map into patch
    space.  Returns (positions (N, 2), final_cost (N,), converged (N,)).
    """
    s = pattern_samples.shape[1]
    dtype = patches.dtype
    sm = sample_valid.to(dtype)
    # both mirror sides share one sample axis of 2S
    s_all = torch.cat([pattern_samples, -pattern_samples], dim=1)
    valid2 = torch.cat([sample_valid, sample_valid], dim=1)

    def sample_sides(h, with_grad):
        pos = _apply_h_local(h, s_all, origins)
        val, grad, ok = sample_patches(patches, pos, with_grad=with_grad)
        return val, grad, ok & valid2 | ~valid2

    def cost_of(h):
        val, _, ok = sample_sides(h, with_grad=False)
        ok_both = ok[:, :s] & ok[:, s:]
        r = val[:, :s] - val[:, s:]
        cost = torch.sum(r * r * (sm * ok_both.to(dtype)), dim=1)
        valid_all = torch.all(ok_both | ~sample_valid, dim=1)
        return torch.where(valid_all, cost, torch.inf)

    def h_and_b(h):
        val, grad, ok = sample_sides(h, with_grad=True)
        jac_all = torch.einsum("nsd,nsdk->nsk", grad,
                               position_wrt_homography(h, s_all))
        jac = jac_all[:, :s] - jac_all[:, s:]
        r = val[:, :s] - val[:, s:]
        ok_both = ok[:, :s] & ok[:, s:]
        w = sm * ok_both.to(dtype)
        big_h = torch.einsum("nsj,nsk,ns->njk", jac, jac, w)
        b = torch.einsum("nsj,ns->nj", jac, r * w)
        cost = torch.sum(r * r * w, dim=1)
        valid = torch.all(ok_both | ~sample_valid, dim=1)
        return big_h, b, torch.where(valid, cost, torch.inf), valid

    return _symmetry_loop(initial_homography(pixel_tr_pattern, positions),
                          positions, h_and_b, cost_of, window_half_size,
                          num_iterations)


def refine_matching_patches(patches, origins, positions, pixel_tr_pattern,
                            pattern_samples, rendered, sample_valid,
                            window_half_size, num_iterations: int = 10,
                            search_radius_px: float = 3.0):
    """Batched matching refinement (position + affine intensity) on
    patches: the optimization of ``refinement.refine_features_matching``
    with patch samples.  Returns (positions, cost, converged)."""
    n = positions.shape[0]
    dtype = patches.dtype
    h_rel = pixel_tr_pattern / pixel_tr_pattern[:, 2:3, 2:3]
    h_rel[:, 0:2, 2] = 0.0
    disp = apply_h(h_rel, pattern_samples)  # (N, S, 2) pixel offsets

    # patch-local coordinates: the position less the origin first (exact),
    # then the displacement, so float32 keeps the precision of patch-size
    # numbers (see _apply_h_local)
    def cost_of(pos, fac, bias):
        """Cost at positions (N, 2) or (N, K, 2) for K candidates each."""
        if pos.dim() == 3:
            k = pos.shape[1]
            p = ((pos - origins[:, None, :])[:, :, None, :]
                 + disp[:, None]).reshape(n, -1, 2)
            val, _, ok = sample_patches(patches, p, with_grad=False)
            val, ok = val.reshape(n, k, -1), ok.reshape(n, k, -1)
        else:
            val, _, ok = sample_patches(
                patches, (pos - origins)[:, None, :] + disp, with_grad=False)
        return matching_cost(val, ok, rendered, sample_valid, fac, bias)

    def jacobian(pos, fac, bias):
        val, grad, ok = sample_patches(patches,
                                       (pos - origins)[:, None, :] + disp)
        return matching_jacobian(val, grad, ok, rendered, sample_valid, fac,
                                 bias)

    return _matching_loop(positions, n, dtype, patches.device, cost_of,
                          jacobian, window_half_size, num_iterations,
                          search_radius_px)


def patch_origins_device(image_shape, centers, patch: int):
    """Patch origins of (N, 2) device centers (the tensor form of
    :func:`patch_origins`, with NaN read as 0 and ±inf as the largest
    finite values before rounding half to even).  Returns (x0, y0) int64."""
    h, w = image_shape
    half = (patch - 2) // 2
    c = torch.nan_to_num(centers).clamp(-2.0 ** 40, 2.0 ** 40)
    x0 = (torch.round(c[:, 0]).long() - half).clamp(0, w - patch)
    y0 = (torch.round(c[:, 1]).long() - half).clamp(0, h - patch)
    return x0, y0


def refine_two_stage_patches(image, positions, pixel_tr_pattern,
                             samples_match, rendered, sv_match, samples_sym,
                             sv_sym, window_half_size, patch: int,
                             image_idx=None):
    """Both refinement stages with their patch extraction: extract →
    matching (position + affine intensity) → re-extract around the matched
    position → 8-DoF symmetry.

    ``image`` is (H, W), or a stacked (B, H, W) batch with per-feature
    ``image_idx`` (N,), so the growth rings of many images share one call.
    Rows are independent: a feature refined alone or inside a batch gives
    the same result.  Returns (N, 4): x, y, cost, converged (1.0 or 0.0).
    """
    dtype = positions.dtype
    shape2d = image.shape[-2:]
    x0, y0 = patch_origins_device(shape2d, positions, patch)
    pd = extract_patches_device(image, torch.stack([y0, x0], -1), patch,
                                image_idx)
    pos1, _c1, ok1 = refine_matching_patches(
        pd, torch.stack([x0, y0], -1).to(dtype), positions, pixel_tr_pattern,
        samples_match, rendered, sv_match, window_half_size)
    x1, y1 = patch_origins_device(shape2d, pos1, patch)
    pd2 = extract_patches_device(image, torch.stack([y1, x1], -1), patch,
                                 image_idx)
    pos2, cost2, ok2 = refine_symmetry_patches(
        pd2, torch.stack([x1, y1], -1).to(dtype), pos1, pixel_tr_pattern,
        samples_sym, sv_sym, window_half_size)
    return torch.cat([pos2, cost2[:, None], (ok1 & ok2).to(dtype)[:, None]],
                     dim=1)

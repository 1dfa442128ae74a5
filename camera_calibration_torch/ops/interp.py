"""Image interpolation (bilinear and bicubic, with Jacobians), batched.

The counterpart of the reference package's ``ops/interp.py``.  Positions
use the pixel-center convention: (0, 0) is the center of the top-left
pixel, and the bilinear sample domain is [0, W−1]×[0, H−1].  Images are
(H, W) or (H, W, C) tensors; positions are (..., 2) as (x, y).
"""

from __future__ import annotations

import torch


def _corner(coord, size, lo=0):
    """The integer tap at or below ``coord`` (already clamped), held to
    [lo, size − 2 − lo]."""
    return torch.floor(coord).long().clamp(lo, size - 2 - lo)


def _bilinear_taps(image, xy):
    h, w = image.shape[:2]
    x = torch.clamp(xy[..., 0], 0.0, w - 1.000001)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.000001)
    x0 = _corner(x, w)
    y0 = _corner(y, h)
    tx = x - x0
    ty = y - y0
    if image.dim() == 3:
        tx = tx[..., None]
        ty = ty[..., None]
    v00 = image[y0, x0]
    v10 = image[y0, x0 + 1]
    v01 = image[y0 + 1, x0]
    v11 = image[y0 + 1, x0 + 1]
    return v00, v10, v01, v11, tx, ty


def bilinear(image, xy):
    """Sample ``image`` at positions (..., 2).  Out-of-bounds positions are
    clamped; use :func:`in_bounds` for validity."""
    v00, v10, v01, v11, tx, ty = _bilinear_taps(image, xy)
    top = v00 + tx * (v10 - v00)
    bot = v01 + tx * (v11 - v01)
    return top + ty * (bot - top)


def bilinear_with_jacobian(image, xy):
    """Sample + spatial gradient: (value, grad) with grad (..., 2) for a
    single-channel image or (..., C, 2) for (H, W, C); the columns are
    d/dx, d/dy."""
    v00, v10, v01, v11, tx, ty = _bilinear_taps(image, xy)
    top = v00 + tx * (v10 - v00)
    bot = v01 + tx * (v11 - v01)
    value = top + ty * (bot - top)
    dx = (v10 - v00) + ty * ((v11 - v01) - (v10 - v00))
    dy = bot - top
    return value, torch.stack([dx, dy], dim=-1)


def in_bounds(image_shape, xy, margin: float = 0.0):
    """Validity of pixel-center positions for bilinear sampling."""
    h, w = image_shape[:2]
    return ((xy[..., 0] >= margin) & (xy[..., 0] <= w - 1 - margin)
            & (xy[..., 1] >= margin) & (xy[..., 1] <= h - 1 - margin))


def _catmull_rom_w(t):
    """Catmull-Rom weights of the 4 taps around a sample at fraction t."""
    t2 = t * t
    t3 = t2 * t
    return torch.stack([
        0.5 * (-t3 + 2.0 * t2 - t),
        0.5 * (3.0 * t3 - 5.0 * t2 + 2.0),
        0.5 * (-3.0 * t3 + 4.0 * t2 + t),
        0.5 * (t3 - t2),
    ], dim=-1)


def _catmull_rom_dw(t):
    """d/dt of the Catmull-Rom weights."""
    t2 = t * t
    return torch.stack([
        0.5 * (-3.0 * t2 + 4.0 * t - 1.0),
        0.5 * (9.0 * t2 - 10.0 * t),
        0.5 * (-9.0 * t2 + 8.0 * t + 1.0),
        0.5 * (3.0 * t2 - 2.0 * t),
    ], dim=-1)


def _bicubic_taps(image, xy):
    """(v (..., 4, 4[, C]), tx, ty): the taps, rows dy = −1..2 and columns
    dx = −1..2, clamped to the image so out-of-domain lookups stay finite
    (validity is the caller's, through ``in_bounds(margin=1)``)."""
    h, w = image.shape[:2]
    x = torch.clamp(xy[..., 0], 1.0, w - 2.000001)
    y = torch.clamp(xy[..., 1], 1.0, h - 2.000001)
    x0 = _corner(x, w, 1)
    y0 = _corner(y, h, 1)
    tx = x - x0
    ty = y - y0
    off = torch.arange(-1, 3, device=xy.device)
    yy = y0[..., None, None] + off[:, None]
    xx = x0[..., None, None] + off[None, :]
    return image[yy, xx], tx, ty


def bicubic(image, xy):
    """Catmull-Rom bicubic sample of (H, W) or (H, W, C) at (..., 2); valid
    domain [1, W−2]×[1, H−2]."""
    v, tx, ty = _bicubic_taps(image, xy)
    wx, wy = _catmull_rom_w(tx), _catmull_rom_w(ty)
    if image.dim() == 3:
        rows = torch.einsum("...yxc,...x->...yc", v, wx)
        return torch.einsum("...yc,...y->...c", rows, wy)
    rows = torch.einsum("...yx,...x->...y", v, wx)
    return torch.einsum("...y,...y->...", rows, wy)


def bicubic_with_jacobian(image, xy):
    """Bicubic sample + spatial gradient (d/dx, d/dy): grad (..., 2) for a
    single channel or (..., C, 2) for (H, W, C)."""
    v, tx, ty = _bicubic_taps(image, xy)
    wx, wy = _catmull_rom_w(tx), _catmull_rom_w(ty)
    dwx, dwy = _catmull_rom_dw(tx), _catmull_rom_dw(ty)
    if image.dim() == 3:
        rows = torch.einsum("...yxc,...x->...yc", v, wx)
        rows_dx = torch.einsum("...yxc,...x->...yc", v, dwx)
        value = torch.einsum("...yc,...y->...c", rows, wy)
        gx = torch.einsum("...yc,...y->...c", rows_dx, wy)
        gy = torch.einsum("...yc,...y->...c", rows, dwy)
        return value, torch.stack([gx, gy], -1)
    rows = torch.einsum("...yx,...x->...y", v, wx)
    rows_dx = torch.einsum("...yx,...x->...y", v, dwx)
    value = torch.einsum("...y,...y->...", rows, wy)
    gx = torch.einsum("...y,...y->...", rows_dx, wy)
    gy = torch.einsum("...y,...y->...", rows, dwy)
    return value, torch.stack([gx, gy], -1)

"""The report images as rasters: colour maps, HSV, PNG files.

The reference package draws its report figures with matplotlib; the
port's images are rasters of the same arrays, colour-mapped with NumPy
and OpenCV (``cv2.applyColorMap``) and written by ``cv2.imwrite``, so a
report needs neither matplotlib nor a display.  Each image is scaled up
by nearest-neighbour sampling to at least :data:`MIN_WIDTH` pixels.
"""

from __future__ import annotations

import numpy as np

MIN_WIDTH = 400


def hsv_to_rgb(hsv):
    """HSV in [0, 1] → RGB in [0, 1], (..., 3), as
    ``matplotlib.colors.hsv_to_rgb`` computes it."""
    hsv = np.asarray(hsv, np.float64)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(int)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = [i % 6 == 0, i == 1, i == 2, i == 3, i == 4, i == 5]
    r = np.select(sector, [v, q, p, p, t, v])
    g = np.select(sector, [t, v, v, q, p, p])
    b = np.select(sector, [p, p, t, v, v, q])
    rgb = np.stack([r, g, b], -1)
    return np.where((s == 0)[..., None], v[..., None], rgb)


def _upscaled(img):
    import cv2

    h, w = img.shape[:2]
    f = max(1, -(-MIN_WIDTH // max(w, 1)))
    if f == 1:
        return img
    return cv2.resize(img, (w * f, h * f), interpolation=cv2.INTER_NEAREST)


def colormapped(values, vmin, vmax, colormap="inferno"):
    """A (h, w) array as a BGR uint8 image: ``values`` clipped to [vmin,
    vmax] through the OpenCV colour map of that name; NaN pixels black."""
    import cv2

    values = np.asarray(values, np.float64)
    span = max(vmax - vmin, 1e-30)
    finite = np.isfinite(values)
    level = np.clip((np.where(finite, values, vmin) - vmin) / span, 0, 1)
    img = cv2.applyColorMap(np.round(255 * level).astype(np.uint8),
                            getattr(cv2, f"COLORMAP_{colormap.upper()}"))
    img[~finite] = 0
    return img


def rgb_to_bgr8(rgb):
    """RGB in [0, 1], (h, w, 3) → BGR uint8."""
    rgb = np.clip(np.asarray(rgb, np.float64), 0, 1)
    return np.round(255 * rgb[..., ::-1]).astype(np.uint8)


def write_png(path, bgr8):
    """Write a BGR uint8 image, scaled up to the minimum width."""
    import cv2

    if not cv2.imwrite(path, _upscaled(np.ascontiguousarray(bgr8))):
        raise OSError(f"could not write {path}")


def scatter_image(points, box, extent, width=MIN_WIDTH):
    """A white canvas showing 2D ``points`` as dots and the rectangle
    ``box`` (x0, y0, x1, y1) in red, over ``extent`` (x0, y0, x1, y1) in
    the points' units; y grows downwards as in an image.  BGR uint8."""
    import cv2

    x0, y0, x1, y1 = extent
    scale = width / max(x1 - x0, 1e-30)
    height = max(1, int(round((y1 - y0) * scale)))
    img = np.full((height + 1, width + 1, 3), 255, np.uint8)

    def at(x, y):
        return (int(round((x - x0) * scale)), int(round((y - y0) * scale)))

    cv2.rectangle(img, at(box[0], box[1]), at(box[2], box[3]), (0, 0, 255), 1)
    for x, y in np.asarray(points, np.float64):
        cv2.circle(img, at(x, y), 2, (180, 119, 31), -1)
    return img

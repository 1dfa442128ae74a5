"""Synthetic image degradations for stress-testing the pipeline.

The reference validates its detector on renders with blur and noise
(test/feature_detection_test.cc:48); real captures additionally suffer
vignetting, defocus, compression artifacts, and exposure drift across a
recording.  These are the knobs `render-synthetic` exposes so E2E tests
can assert the full pipeline still beats the 0.1 px gate under them.

All functions take/return float images in [0, 1].
"""

from __future__ import annotations

import numpy as np


def apply_vignetting(img: np.ndarray, strength: float) -> np.ndarray:
    """Radial intensity falloff: 1 - strength * r^2 with r normalized to
    1 at the image corners' inscribed ellipse."""
    if strength <= 0:
        return img
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    r2 = ((xx - w / 2) / (w / 2)) ** 2 + ((yy - h / 2) / (h / 2)) ** 2
    return img * (1.0 - strength * r2 / 2.0)


def apply_defocus(img: np.ndarray, sigma: float) -> np.ndarray:
    """Gaussian defocus blur (approximates a lens PSF)."""
    if sigma <= 0:
        return img
    import cv2

    k = int(2 * round(3 * sigma) + 1)
    return cv2.GaussianBlur(img, (k, k), sigma)


def apply_jpeg(img: np.ndarray, quality: int) -> np.ndarray:
    """Round-trip through JPEG at the given quality (1-100; 0 = off)."""
    if quality <= 0 or quality >= 100:
        return img
    import cv2

    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    ok, buf = cv2.imencode(".jpg", u8, [cv2.IMWRITE_JPEG_QUALITY, int(quality)])
    if not ok:
        return img
    return cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE).astype(np.float64) / 255.0


def apply_exposure(img: np.ndarray, gain: float, offset: float) -> np.ndarray:
    """Linear exposure model: gain * img + offset (drifts per frame)."""
    return gain * img + offset


def degrade(
    img: np.ndarray,
    rng: np.random.Generator,
    *,
    vignetting: float = 0.0,
    defocus_sigma: float = 0.0,
    jpeg_quality: int = 0,
    exposure_drift: float = 0.0,
    noise: float = 0.0,
) -> np.ndarray:
    """Apply the degradation stack in physical order: optics (defocus,
    vignetting) -> exposure -> sensor noise -> compression.

    What it draws from ``rng`` depends on the image's shape and the
    options only, never on its pixels: ``render-synthetic`` relies on
    that to advance a view's generator by degrading a blank image while
    the view itself renders in another thread."""
    img = apply_defocus(img, defocus_sigma)
    img = apply_vignetting(img, vignetting)
    if exposure_drift > 0:
        gain = 1.0 + rng.uniform(-exposure_drift, exposure_drift)
        offset = rng.uniform(0, 0.5 * exposure_drift)
        img = apply_exposure(img, gain, offset)
    if noise > 0:
        img = img + rng.normal(0, noise, img.shape)
    img = np.clip(img, 0.0, 1.0)
    img = apply_jpeg(img, jpeg_quality)
    return np.clip(img, 0.0, 1.0)

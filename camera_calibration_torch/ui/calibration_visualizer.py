"""Per-stage calibration visualization: the CalibrationWindow analog.

The reference's live GUI exposes a per-stage update API that the pipeline
calls as it progresses (reference: applications/camera_calibration/src/
camera_calibration/ui/calibration_window.h:54-64 —
UpdateFeatureDetection / UpdateInitialization / UpdateObservationDirections /
UpdateErrorHistogram / UpdateReprojectionErrors / UpdateErrorDirections /
UpdateRemovedOutliers — consumed from Calibrate() after each BA iteration,
calibration.cc:256-290).  This headless equivalent writes the same
visualizations as PNG files into a live directory that an operator can
watch (feh/browser auto-refresh), updated in place per stage/iteration.

Each hook is split into an array function (the module-level functions
below: what the image shows) and a drawing step, an OpenCV raster written
through ``report/raster.py`` (no matplotlib, as the reports).  The arrays
that need a projection compute it on the state's device: on the card the
error hooks run the ``project`` kernel (30 warm-started iterations).

Every hook is cheap-by-default: iteration-dense stages (reprojection
errors) re-render at most every ``min_update_seconds``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from camera_calibration_torch.report import raster

# Width of the scatter canvases (image extent scaled to it).
CANVAS_WIDTH = 640


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


# ----------------------------- the arrays -----------------------------


def detection_points(features):
    """Detected features as pixel-centre coordinates (n, 2)."""
    if not features:
        return np.zeros((0, 2))
    return np.array([f.xy for f in features], np.float64) - 0.5


def direction_rgb(dirs, valid):
    """Directions as RGB 0.5·(d + 1), black where invalid, clipped to
    [0, 1]."""
    d = np.asarray(dirs, np.float64)
    rgb = np.where(np.asarray(valid)[..., None], 0.5 * (d + 1.0), 0.0)
    return np.clip(rgb, 0, 1)


def observation_direction_rgb(model):
    """The model's observation directions on a grid of at most 160×120
    pixel centres over the image, as :func:`direction_rgb`."""
    from camera_calibration_torch.models import protocol

    w, h = model.width, model.height
    xs = np.linspace(0.5, w - 0.5, min(w, 160))
    ys = np.linspace(0.5, h - 0.5, min(h, 120))
    xx, yy = np.meshgrid(xs, ys)
    ref = protocol.model_tensor(model)
    px = torch.as_tensor(np.stack([xx, yy], -1).reshape(-1, 2),
                         dtype=ref.dtype, device=ref.device)
    dirs, valid = protocol.unproject(model, px)
    return direction_rgb(_np(dirs).astype(np.float64).reshape(len(ys), len(xs), 3),
                         _np(valid).reshape(len(ys), len(xs)))


def error_data(state, data):
    """Per camera, (measured pixels, error magnitudes) of the observations
    with a finite reprojection error (``calibrate.observation_reprojection_
    errors``)."""
    from camera_calibration_torch.calibrate import (
        observation_reprojection_errors)

    out = []
    for seg, e in zip(data, observation_reprojection_errors(state, data)):
        e_np = _np(e)
        finite = np.isfinite(e_np)
        out.append((_np(seg.pixel)[finite], e_np[finite]))
    return out


def error_vectors(state, data):
    """Per camera, (measured pixels, error vectors projected − measured)
    of the valid observations with finite errors; the projection is
    warm-started at the measured pixels (30 iterations)."""
    from camera_calibration_torch.ba.state import transform_to_camera
    from camera_calibration_torch.models import protocol

    out = []
    for ci, seg in enumerate(data):
        x_cam, _ = transform_to_camera(
            state, seg.imageset, seg.camera, state.points[seg.point])
        px, _, pvalid = protocol.project_points(
            state.intrinsics[ci], x_cam, init_xy=seg.pixel, max_iterations=30)
        e = _np(px - seg.pixel)
        keep = _np(pvalid) & _np(seg.valid) & np.all(np.isfinite(e), -1)
        out.append((_np(seg.pixel)[keep], e[keep]))
    return out


def error_histogram_counts(err, half_extent_px=0.2, bins=64):
    """The 2-D error histogram's counts, indexed [x bin, y bin]."""
    from camera_calibration_torch.report.calibration_report import (
        error_histogram)

    return error_histogram(np.asarray(err, np.float64).reshape(-1, 2),
                           half_extent_px, bins)


def error_hue(err):
    """The error direction as a hue in [0, 1]."""
    err = np.asarray(err, np.float64)
    return (np.arctan2(err[:, 1], err[:, 0]) + np.pi) / (2 * np.pi)


def error_direction_rgb(err):
    """RGB of full-saturation, full-value colours at :func:`error_hue`."""
    hue = error_hue(err)
    return raster.hsv_to_rgb(
        np.stack([hue, np.ones_like(hue), np.ones_like(hue)], -1))


def outlier_masks(seg):
    """(measured pixels, kept mask, removed mask) of one camera's table."""
    valid = _np(seg.valid).astype(bool)
    return _np(seg.pixel), valid, ~valid


# ----------------------------- the drawing -----------------------------


def _canvas(w, h, width=CANVAS_WIDTH):
    scale = width / max(w, 1)
    height = max(1, int(round(h * scale)))
    return np.full((height, width, 3), 255, np.uint8), scale


def _dots(img, scale, pixels, colors_bgr, radius=1, marker=None):
    import cv2

    for (x, y), c in zip(np.asarray(pixels, np.float64), colors_bgr):
        at = (int(round(x * scale)), int(round(y * scale)))
        c = tuple(int(v) for v in c)
        if marker is None:
            cv2.circle(img, at, radius, c, -1)
        else:
            cv2.drawMarker(img, at, c, marker, 6, 1)


def _title(img, text):
    import cv2

    cv2.putText(img, text, (4, 14), cv2.FONT_HERSHEY_SIMPLEX, 0.4,
                (0, 0, 0), 1, cv2.LINE_AA)
    return img


def _bgr_of(colors_rgb):
    return raster.rgb_to_bgr8(np.asarray(colors_rgb)[None])[0]


class CalibrationVisualizer:
    """Writes per-stage PNGs into ``directory`` as calibration progresses."""

    def __init__(self, directory, min_update_seconds: float = 1.0):
        self.directory = directory
        self.min_update_seconds = min_update_seconds
        self._last = {}
        os.makedirs(directory, exist_ok=True)

    def _throttle(self, key) -> bool:
        now = time.monotonic()
        if now - self._last.get(key, -1e9) < self.min_update_seconds:
            return True
        self._last[key] = now
        return False

    def _path(self, name):
        return os.path.join(self.directory, name + ".png")

    # -- stage hooks (reference: calibration_window.h:54-64) ---------------

    def update_feature_detection(self, camera_index, image, features):
        """Detection overlay for one camera image
        (reference: UpdateFeatureDetection): lime crosses on the image."""
        import cv2

        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = np.round(255 * np.clip(img, 0, 1)).astype(np.uint8)
        bgr = (cv2.cvtColor(img, cv2.COLOR_GRAY2BGR) if img.ndim == 2
               else img.copy())
        pts = detection_points(features)
        _dots(bgr, 1.0, pts, [(0, 255, 0)] * len(pts),
              marker=cv2.MARKER_CROSS)
        raster.write_png(
            self._path(f"feature_detection_camera{camera_index}"),
            _title(bgr, f"camera {camera_index}: {len(pts)} features"))

    def update_initialization(self, camera_index, dense_directions, valid):
        """Dense-init direction image (reference: UpdateInitialization) —
        directions mapped to RGB as 0.5·(d+1)."""
        raster.write_png(
            self._path(f"initialization_camera{camera_index}"),
            raster.rgb_to_bgr8(direction_rgb(dense_directions, valid)))

    def update_observation_directions(self, camera_index, model):
        """Calibrated observation directions of the current model
        (reference: UpdateObservationDirections)."""
        raster.write_png(
            self._path(f"observation_directions_camera{camera_index}"),
            raster.rgb_to_bgr8(observation_direction_rgb(model)))

    def update_reprojection_errors(self, state, data, iteration=None):
        """Per-camera spatial error map, refreshed as BA iterates
        (reference: UpdateReprojectionErrors after every iteration):
        each observation coloured by min(|error|, 1 px) through inferno."""
        if self._throttle("reproj"):
            return
        for ci, (pix, mags) in enumerate(error_data(state, data)):
            model = state.intrinsics[ci]
            img, scale = _canvas(model.width, model.height)
            colors = raster.colormapped(np.minimum(mags, 1.0)[None], 0.0,
                                        1.0)[0] if mags.size else []
            _dots(img, scale, pix, colors)
            med = float(np.median(mags)) if mags.size else float("nan")
            t = f"camera {ci}: median {med:.4f} px"
            if iteration is not None:
                t += f" (iteration {iteration})"
            raster.write_png(self._path(f"reprojection_errors_camera{ci}"),
                             _title(img, t))

    def update_error_histogram(self, state, data, half_extent_px=0.2):
        """2-D error histogram (reference: UpdateErrorHistogram): 64×64
        bins over [−e, e]², x to the right, y down, through viridis."""
        for ci, (_, e) in enumerate(error_vectors(state, data)):
            counts = error_histogram_counts(e, half_extent_px)
            raster.write_png(
                self._path(f"error_histogram_camera{ci}"),
                raster.colormapped(counts.T, 0, max(counts.max(), 1),
                                   "viridis"))

    def update_error_directions(self, state, data):
        """Error direction as hue at each observation
        (reference: UpdateErrorDirections)."""
        for ci, (pix, e) in enumerate(error_vectors(state, data)):
            model = state.intrinsics[ci]
            img, scale = _canvas(model.width, model.height)
            if e.size:
                _dots(img, scale, pix, _bgr_of(error_direction_rgb(e)))
            raster.write_png(
                self._path(f"error_directions_camera{ci}"),
                _title(img, f"camera {ci}: error directions (hue)"))

    def update_removed_outliers(self, state, data, removed_count):
        """Remaining-observation map after outlier deletion
        (reference: UpdateRemovedOutliers): kept observations as blue
        dots, removed ones as red crosses."""
        import cv2

        for ci, seg in enumerate(data):
            pix, kept, removed = outlier_masks(seg)
            model = state.intrinsics[ci]
            img, scale = _canvas(model.width, model.height)
            _dots(img, scale, pix[kept], [(180, 119, 31)] * int(kept.sum()))
            _dots(img, scale, pix[removed], [(0, 0, 255)] * int(removed.sum()),
                  marker=cv2.MARKER_TILTED_CROSS)
            raster.write_png(
                self._path(f"removed_outliers_camera{ci}"),
                _title(img, f"camera {ci}: outliers ({removed_count} "
                            "removed total)"))

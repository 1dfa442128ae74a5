"""Calibration report: metrics text file and visualization images per
camera.

The port of the reference package's ``report/calibration_report.py``.  Per
camera it writes, under the same names:

- ``report_cameraX_info.txt``: resolution, imageset counts, reprojection
  error count, median, average and maximum, and the
  ``median_kl_divergence`` bias score, in the reference's format;
- ``report_cameraX_errors_histogram.png``: the 2D histogram of the
  reprojection error vectors (:func:`error_histogram`);
- ``report_cameraX_error_magnitudes.png``: the per-cell mean error
  magnitude over the image (:func:`cell_mean_magnitudes`);
- ``report_cameraX_error_directions.png``: the Voronoi diagram of the
  error directions (hue) and magnitudes (value) (:func:`voronoi_rgb`);
- ``report_cameraX_grid_point_locations.png`` for grid models: the knot
  pixel positions and the image box (:func:`knot_pixels`);
- ``report_cameraX_line_offsets.png`` and ``report_cameraX_lines.obj`` for
  NoncentralGeneric: each pixel's line offset from the best single center
  (:func:`line_offsets`) and a segment per sampled line;
- ``report_cameraX_observation_directions.png``: the observation
  directions as colours (:func:`direction_rgb`).

The images are rasters of the arrays the reference plots (``raster.py``),
not matplotlib figures.  The reprojection errors are computed on the
state's device: on the card, through the projection kernel (float32).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from camera_calibration_torch.ba.state import transform_to_camera
from camera_calibration_torch.models import central_generic as cg
from camera_calibration_torch.models import noncentral_generic as ncg
from camera_calibration_torch.models import protocol
from camera_calibration_torch.report import raster


def _np(t):
    return t.detach().cpu().numpy()


def _pixels(model, xy):
    """NumPy pixels (N, 2) as a tensor on the model's device and type."""
    ref = protocol.model_tensor(model)
    return torch.as_tensor(xy, dtype=ref.dtype, device=ref.device)


def _error_data(state, data, camera_index):
    """(error vectors (n, 2), measured pixels (n, 2), imagesets (n,)) of
    the valid observations of one camera, as NumPy arrays."""
    seg = data[camera_index]
    x_cam, _ = transform_to_camera(
        state, seg.imageset, seg.camera, state.points[seg.point])
    px, _, pvalid = protocol.project_points(
        state.intrinsics[camera_index], x_cam, init_xy=seg.pixel,
        max_iterations=30)
    valid = _np(pvalid & seg.valid)
    err = _np(px - seg.pixel)[valid]
    pix = _np(seg.pixel)[valid]
    ims = _np(seg.imageset)[valid]
    return err, pix, ims


def _kl_bias_score(err, pix, image_size, cell_px=50, n_bins=8):
    """Median KL divergence of per-cell error-direction histograms from
    the uniform one: the reference's biasedness score."""
    w, h = image_size
    angles = np.arctan2(err[:, 1], err[:, 0])
    bins = ((angles + np.pi) / (2 * np.pi) * n_bins).astype(int) % n_bins
    cx = np.clip((pix[:, 0] / cell_px).astype(int), 0, max(0, w // cell_px))
    cy = np.clip((pix[:, 1] / cell_px).astype(int), 0, max(0, h // cell_px))
    cells = cy * (w // cell_px + 1) + cx
    kls = []
    for c in np.unique(cells):
        m = cells == c
        if m.sum() < 2 * n_bins:
            continue
        p = np.bincount(bins[m], minlength=n_bins).astype(float)
        p /= p.sum()
        q = 1.0 / n_bins
        nz = p > 0
        kls.append(float(np.sum(p[nz] * np.log(p[nz] / q))))
    return float(np.median(kls)) if kls else 0.0


def error_histogram(err, half_extent, bins=64):
    """Counts of the error vectors over [−e, e]², (bins, bins), indexed
    [x bin, y bin] as ``np.histogram2d`` (and matplotlib's ``hist2d``)
    count them."""
    e = half_extent
    counts, _, _ = np.histogram2d(err[:, 0], err[:, 1], bins=bins,
                                  range=[[-e, e], [-e, e]])
    return counts


def _cell_size(w, h):
    return max(8, min(w, h) // 40)


def cell_mean_magnitudes(err, pix, w, h):
    """Mean error magnitude per image cell of ``max(8, min(w, h) // 40)``
    px, (h // cell + 1, w // cell + 1); NaN where a cell has no
    observation."""
    cell = _cell_size(w, h)
    gw_, gh_ = w // cell + 1, h // cell + 1
    mag_img = np.zeros((gh_, gw_))
    cnt_img = np.zeros((gh_, gw_))
    cx = np.clip((pix[:, 0] / cell).astype(int), 0, gw_ - 1)
    cy = np.clip((pix[:, 1] / cell).astype(int), 0, gh_ - 1)
    np.add.at(mag_img, (cy, cx), np.linalg.norm(err, axis=-1))
    np.add.at(cnt_img, (cy, cx), 1)
    with np.errstate(invalid="ignore"):
        return np.where(cnt_img > 0, mag_img / np.maximum(cnt_img, 1),
                        np.nan)


def voronoi_rgb(err, pix, w, h, max_error_px):
    """The Voronoi error-direction diagram, RGB (vh, vw, 3) at most 640
    wide: every raster pixel takes the error direction (hue) and magnitude
    (value, clipped to [0.15, 1] of ``max_error_px``) of its nearest
    observation."""
    from scipy.spatial import cKDTree

    vw = min(w, 640)
    vh = max(1, int(round(vw * h / w)))
    gxv, gyv = np.meshgrid((np.arange(vw) + 0.5) * w / vw,
                           (np.arange(vh) + 0.5) * h / vh)
    _, idx = cKDTree(pix).query(np.stack([gxv.ravel(), gyv.ravel()], -1),
                                k=1)
    ang = np.arctan2(err[idx, 1], err[idx, 0]).reshape(vh, vw)
    mag = np.linalg.norm(err, axis=-1)[idx].reshape(vh, vw)
    hue = (ang + np.pi) / (2 * np.pi)
    val = np.clip(mag / max(max_error_px, 1e-9), 0.15, 1.0)
    return raster.hsv_to_rgb(np.stack([hue, np.ones_like(hue), val], -1))


def knot_pixels(model):
    """Pixel positions (n, 2) of a grid model's knots (of the direction
    grid for NoncentralGeneric)."""
    if isinstance(model, ncg.NoncentralGenericModel):
        model = cg.CentralGenericModel(
            grid=model.direction_grid, width=model.width,
            height=model.height,
            calibration_min_x=model.calibration_min_x,
            calibration_min_y=model.calibration_min_y,
            calibration_max_x=model.calibration_max_x,
            calibration_max_y=model.calibration_max_y)
    return _np(cg.grid_point_pixels(model)).reshape(-1, 2)


def line_offsets(model):
    """NoncentralGeneric lines at 60×80 pixels over the image:
    (offset (60, 80) in m of each line from the least-squares center of
    all lines, that center (3,), directions (4800, 3), origins
    (4800, 3))."""
    w, h = model.width, model.height
    ys = np.linspace(1, h - 2, 60)
    xs = np.linspace(1, w - 2, 80)
    gx, gy = np.meshgrid(xs, ys)
    d_n, o_n, _ = ncg.unproject(
        model, _pixels(model, np.stack([gx, gy], -1).reshape(-1, 2)))
    d_n, o_n = _np(d_n).astype(np.float64), _np(o_n).astype(np.float64)
    proj = np.eye(3)[None] - d_n[:, :, None] * d_n[:, None, :]
    try:
        center = np.linalg.solve(proj.sum(0),
                                 np.einsum("nij,nj->i", proj, o_n))
    except np.linalg.LinAlgError:
        center = o_n.mean(0)
    rel = o_n - center
    off = np.linalg.norm(
        rel - np.einsum("nj,nj->n", rel, d_n)[:, None] * d_n, axis=1)
    return off.reshape(len(ys), len(xs)), center, d_n, o_n


def write_lines_obj(path, center, d_n, o_n, step=7, seg_half=0.05):
    """One 10 cm segment per ``step``-th sampled line, around its closest
    approach to ``center``."""
    with open(path, "w") as f:
        f.write("# noncentral camera line visualization\n")
        count = 0
        for i in range(0, d_n.shape[0], step):
            t0 = np.dot(center - o_n[i], d_n[i])
            p_mid = o_n[i] + t0 * d_n[i]
            f.write("v %.8g %.8g %.8g\n" % tuple(p_mid - seg_half * d_n[i]))
            f.write("v %.8g %.8g %.8g\n" % tuple(p_mid + seg_half * d_n[i]))
            count += 1
        for i in range(count):
            f.write(f"l {2 * i + 1} {2 * i + 2}\n")


def direction_rgb(model):
    """Observation directions at 120×160 pixels over the image as RGB
    ((d + 1) / 2, black where invalid), (120, 160, 3)."""
    w, h = model.width, model.height
    ys = np.linspace(1, h - 2, 120)
    xs = np.linspace(1, w - 2, 160)
    gx, gy = np.meshgrid(xs, ys)
    dirs, dvalid = protocol.unproject(
        model, _pixels(model, np.stack([gx, gy], -1).reshape(-1, 2)))
    dirs = _np(dirs).astype(np.float64).reshape(len(ys), len(xs), 3)
    rgb = 0.5 * (dirs + 1.0)
    rgb[~_np(dvalid).reshape(len(ys), len(xs))] = 0.0
    return np.clip(rgb, 0, 1)


def _write_info(path, metrics, histogram_half_extent_px, max_error_px):
    with open(path, "w") as f:
        f.write(f"resolution : {metrics['resolution']}\n\n")
        f.write("num_localized_imagesets : "
                f"{metrics['num_localized_imagesets']}\n")
        f.write(f"num_total_imagesets : {metrics['num_total_imagesets']}\n\n")
        f.write("reprojection_error_count : "
                f"{metrics['reprojection_error_count']}\n")
        for key in ("reprojection_error_median", "reprojection_error_average",
                    "reprojection_error_maximum"):
            f.write("%s : %.14g\n" % (key, metrics[key]))
        f.write("median_kl_divergence : %.14g\n\n"
                % metrics["median_kl_divergence"])
        f.write("reprojection_error_histogram_visualization_half_extent_in_"
                "pixels : %g\n" % histogram_half_extent_px)
        f.write("maximum_error_visualization_maximum_error_in_pixels : %g\n"
                % max_error_px)


def create_calibration_report(
    base_path,
    state,
    data,
    *,
    num_total_imagesets=None,
    histogram_half_extent_px=0.2,
    max_error_px=1.0,
):
    """Write report files for every camera.  Returns per-camera metrics."""
    os.makedirs(base_path, exist_ok=True)
    all_metrics = []
    for ci, model in enumerate(state.intrinsics):
        w, h = model.width, model.height
        err, pix, ims = _error_data(state, data, ci)
        err = err.astype(np.float64)
        pix = pix.astype(np.float64)
        mags = np.linalg.norm(err, axis=-1)
        n_localized = len(np.unique(ims))
        nan = float("nan")
        metrics = {
            "resolution": f"{w} x {h}",
            "num_localized_imagesets": int(n_localized),
            "num_total_imagesets": int(num_total_imagesets or n_localized),
            "reprojection_error_count": int(mags.size),
            "reprojection_error_median":
                float(np.median(mags)) if mags.size else nan,
            "reprojection_error_average":
                float(np.mean(mags)) if mags.size else nan,
            "reprojection_error_maximum":
                float(np.max(mags)) if mags.size else nan,
            "median_kl_divergence": _kl_bias_score(err, pix, (w, h)),
        }
        prefix = os.path.join(base_path, f"report_camera{ci}")
        _write_info(prefix + "_info.txt", metrics, histogram_half_extent_px,
                    max_error_px)

        if mags.size:
            counts = error_histogram(err, histogram_half_extent_px)
            raster.write_png(prefix + "_errors_histogram.png",
                             raster.colormapped(counts.T, 0, counts.max(),
                                                "viridis"))
            raster.write_png(prefix + "_error_magnitudes.png",
                             raster.colormapped(
                                 cell_mean_magnitudes(err, pix, w, h), 0,
                                 max_error_px, "inferno"))
            raster.write_png(prefix + "_error_directions.png",
                             raster.rgb_to_bgr8(voronoi_rgb(
                                 err, pix, w, h, max_error_px)))

        if protocol.is_grid_model(model):
            knots = knot_pixels(model)
            extent = (min(0, knots[:, 0].min()), min(0, knots[:, 1].min()),
                      max(w, knots[:, 0].max()), max(h, knots[:, 1].max()))
            raster.write_png(prefix + "_grid_point_locations.png",
                             raster.scatter_image(knots, (0, 0, w, h),
                                                  extent))

        if isinstance(model, ncg.NoncentralGenericModel):
            off, center, d_n, o_n = line_offsets(model)
            mm = off * 1000.0
            raster.write_png(prefix + "_line_offsets.png",
                             raster.colormapped(mm, mm.min(), mm.max(),
                                                "viridis"))
            write_lines_obj(prefix + "_lines.obj", center, d_n, o_n)

        raster.write_png(prefix + "_observation_directions.png",
                         raster.rgb_to_bgr8(direction_rgb(model)))
        all_metrics.append(metrics)
    return all_metrics

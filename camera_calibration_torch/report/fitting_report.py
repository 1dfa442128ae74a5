"""Fitting report: fit parametric models to a generic calibration.

The port of the reference package's ``report/fitting_report.py``: each
requested parametric model is fitted to a generic model's dense
unprojection field, and the residual reprojection field (where, and by how
much, a 12-parameter model deviates from the generic calibration) is
reported in ``fitting_<name>_info.txt`` and drawn as
``fitting_<name>_residual_field.png`` (:func:`residual_field`, a raster of
the array the reference plots; see ``raster.py``).  The fits run on the
generic model's device in float64.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from camera_calibration_torch.models import parametric as pm
from camera_calibration_torch.models import protocol
from camera_calibration_torch.ops import se3
from camera_calibration_torch.report import raster


def _templates(w, h, device):
    def zeros(n):
        return torch.zeros(n, dtype=torch.float64, device=device)

    return {
        "central_thin_prism_fisheye": pm.CentralThinPrismFisheyeModel(
            params=zeros(12), width=w, height=h,
            use_equidistant_projection=True),
        "central_opencv": pm.CentralOpenCVModel(params=zeros(12), width=w,
                                                height=h),
        "central_radial": pm.CentralRadialModel(params=zeros(8 + 50),
                                                width=w, height=h),
    }


def residual_field(fitted, dense, vmask, px, q_rot=None):
    """|projection of the generic directions by the fitted model − their
    source pixels| per sample, (h, w) with NaN where invalid, and the mask
    of valid samples (flat)."""
    ref = fitted.params
    dirs = torch.as_tensor(dense.reshape(-1, 3), dtype=ref.dtype,
                           device=ref.device)
    if q_rot is not None:
        dirs = se3.quat_rotate(q_rot.to(ref.dtype), dirs)
    pred, _, pvalid = pm.project_points(fitted, dirs)
    m = pvalid.cpu().numpy() & vmask.reshape(-1)
    err = np.linalg.norm(pred.cpu().numpy() - px, axis=-1)
    field = np.full(vmask.shape, np.nan)
    field.reshape(-1)[m] = err[m]
    return field, m


def fit_and_report(
    generic_model,
    base_path,
    model_names=("central_thin_prism_fisheye", "central_opencv",
                 "central_radial"),
    subsample: int = 4,
    log=print,
    co_estimate_rotation: bool = False,
):
    """Fit parametric models to ``generic_model``; write report files.

    With ``co_estimate_rotation`` each fit also estimates a global rotation
    of the calibration, reported as ``rotation_quaternion`` (the caller
    folds it into camera_tr_rig).  Returns {name: metrics dict}.
    """
    os.makedirs(base_path, exist_ok=True)
    ref = protocol.model_tensor(generic_model)
    w, h = generic_model.width, generic_model.height
    xs = np.arange(0, w, subsample) + 0.5
    ys = np.arange(0, h, subsample) + 0.5
    gx, gy = np.meshgrid(xs, ys)
    pixel_coords = np.stack([gx, gy], -1)
    px = pixel_coords.reshape(-1, 2)
    dirs, valid = protocol.unproject(
        generic_model, torch.as_tensor(px, dtype=ref.dtype,
                                       device=ref.device))
    dense = dirs.cpu().numpy().astype(np.float64).reshape(len(ys), len(xs), 3)
    vmask = valid.cpu().numpy().reshape(len(ys), len(xs))

    templates = _templates(w, h, ref.device)
    out = {}
    for name in model_names:
        res = pm.fit_parametric_to_dense(
            templates[name], dense, vmask, max_iterations=60,
            pixel_coords=pixel_coords,
            co_estimate_rotation=co_estimate_rotation, device=ref.device)
        fitted, q_rot = res if co_estimate_rotation else (res, None)
        field, m = residual_field(fitted, dense, vmask, px, q_rot)
        err = field.reshape(-1)[m]
        metrics = {
            "fitting_error_median_px": float(np.median(err)),
            "fitting_error_average_px": float(np.mean(err)),
            "fitting_error_maximum_px": float(np.max(err)),
        }
        if q_rot is not None:
            metrics["rotation_quaternion"] = [
                float(v) for v in q_rot.cpu().numpy()]
        out[name] = metrics
        log(f"[fitting] {name}: {metrics}")

        prefix = os.path.join(base_path, f"fitting_{name}")
        with open(prefix + "_info.txt", "w") as f:
            for k, v in metrics.items():
                if isinstance(v, list):
                    f.write(f"{k} : " + " ".join(f"{x:.14g}" for x in v)
                            + "\n")
                else:
                    f.write(f"{k} : {v:.14g}\n")
        raster.write_png(prefix + "_residual_field.png",
                         raster.colormapped(field, 0, np.nanmax(field),
                                            "inferno"))
    return out

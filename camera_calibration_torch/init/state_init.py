"""BA-state construction from dense initialization.

The reference's InitializeBAStateFromDenseInitialization (reference:
applications/camera_calibration/src/camera_calibration/
calibration.cc:779-916): fit the chosen camera model to each camera's
dense observation-direction image, set rig poses from the per-camera
image poses (camera_tr_rig by SE(3) averaging for rigs,
calibration.cc:885-911), and seed pattern points at their known-geometry
global positions.

The fits run on ``config.host_device()``; the state and the observation
tables are then built on the device the caller names (default: the card).
"""

from __future__ import annotations

import numpy as np
import torch

from camera_calibration_torch.ba.dataset import (
    Dataset, build_per_camera_tables,
)
from camera_calibration_torch.ba.state import BAState
from camera_calibration_torch.config import default_device, host_device
from camera_calibration_torch.models import central_generic as cg
from camera_calibration_torch.models import parametric as pm
from camera_calibration_torch.models.base import cast_floating, replace
from camera_calibration_torch.models.fit import (
    fit_central_generic_to_dense, fit_noncentral_to_lines,
)
from camera_calibration_torch.ops import se3


def fit_initial_model(result, grid_resolution, dtype=torch.float64,
                      device=None):
    """Fit a CentralGenericModel to a DenseInitResult's direction image.

    The fit runs in the dense buffer's raster on ``device`` (default:
    ``config.host_device()``); the model is then rewrapped with the
    full-image bounds (the buffer is a uniform downsample).
    """
    dirs, valid = result.observation_directions()
    w, h = result.image_size
    model = fit_central_generic_to_dense(
        dirs,
        valid,
        grid_resolution,
        width=result.buffer_size[0],
        height=result.buffer_size[1],
        max_iterations=25,
        dtype=dtype,
        device=device,
    )
    return cg.CentralGenericModel(
        grid=model.grid,
        width=w,
        height=h,
        calibration_min_x=0,
        calibration_min_y=0,
        calibration_max_x=w - 1,
        calibration_max_y=h - 1,
    )


def fit_initial_model_noncentral(result, grid_resolution, device=None):
    """Fit a NoncentralGenericModel to a noncentral init result's line
    field (``result.line_field()`` -> dirs, anchors, valid, centroid)."""
    dirs, anchors, valid, _c = result.line_field()
    w, h = result.image_size
    return fit_noncentral_to_lines(
        dirs, anchors, valid, grid_resolution, width=w, height=h,
        device=device)


_PARAMETRIC_KINDS = (
    "central_thin_prism_fisheye", "central_opencv", "central_radial",
)


def fit_initial_model_parametric(result, kind, dtype=torch.float64,
                                 device=None):
    """Fit a parametric model to a DenseInitResult's direction image.

    The fit runs in the dense buffer's raster on ``device`` (default:
    ``config.host_device()``); the pinhole block is then rescaled to image
    pixels (distortion parameters live in normalized camera coordinates and
    are scale-invariant)."""
    device = host_device() if device is None else torch.device(device)
    dirs, valid = result.observation_directions()
    w, h = result.image_size
    bw, bh = result.buffer_size
    if kind == "central_thin_prism_fisheye":
        template = pm.CentralThinPrismFisheyeModel(
            params=torch.zeros(12, dtype=dtype, device=device), width=bw,
            height=bh)
    elif kind == "central_opencv":
        template = pm.CentralOpenCVModel(
            params=torch.zeros(12, dtype=dtype, device=device), width=bw,
            height=bh)
    elif kind == "central_radial":
        # 8 base params + 50-knot radial spline (the reference uses 250,
        # calibration.cc:60; 50 is plenty at init — BA refines)
        template = pm.CentralRadialModel(
            params=torch.zeros(8 + 50, dtype=dtype, device=device),
            width=bw, height=bh)
    else:
        raise ValueError(f"unknown parametric kind {kind}")
    fitted = pm.fit_parametric_to_dense(template, dirs, valid, dtype=dtype,
                                        device=device)
    sx = w / bw
    sy = h / bh
    params = fitted.params.clone()
    params[0] *= sx  # fx
    params[1] *= sy  # fy
    params[2] *= sx  # cx
    params[3] *= sy  # cy
    return replace(fitted, params=params, width=w, height=h)


def feature_id_to_point_index(dataset: Dataset):
    """Compacting map over feature ids present in known geometries.

    (reference: ba_state.cc ComputeFeatureIdToPointsIndex)
    """
    ids = set()
    for g in dataset.known_geometries:
        ids.update(g.feature_id_to_position.keys())
    return {fid: i for i, fid in enumerate(sorted(ids))}


def initial_points(dataset: Dataset, fid_to_idx, geometry_poses):
    """Global 3D seed positions of all pattern points (NumPy)."""
    pts = np.zeros((len(fid_to_idx), 3))
    for gi, g in enumerate(dataset.known_geometries):
        pose = geometry_poses[gi]
        if pose is None:
            pose = (np.eye(3), np.zeros(3))
        r, t = pose
        for fid, pos in g.feature_id_to_position.items():
            p = np.array(
                [pos[0] * g.cell_length_in_meters,
                 pos[1] * g.cell_length_in_meters, 0.0]
            )
            pts[fid_to_idx[fid]] = r @ p + t
    return pts


def build_ba_state(
    dataset: Dataset,
    dense_results,
    grid_resolution,
    dtype=torch.float64,
    model_kind: str = "central_generic",
    device=None,
):
    """(BAState, per-camera data tuple, fid_to_idx, image_used) from dense
    init results, on ``device`` (default: the card).

    dense_results: one DenseInitResult per camera (camera 0's frame anchors
    the rig).  image_used[i] is True iff imageset i was localized by every
    camera; never-localized imagesets keep identity rig poses and must be
    excluded when saving or resuming a BA state.  The model fits run on
    ``config.host_device()`` in ``dtype``.
    """
    device = default_device(device)
    host = host_device()
    n_cameras = dataset.num_cameras
    n_sets = len(dataset.imagesets)
    fid_to_idx = feature_id_to_point_index(dataset)

    # Rig poses: rig frame = camera 0. rig_tr_global[i] = image_tr_global[0][i].
    used = [
        all(
            dense_results[c].image_tr_global[i] is not None
            for c in range(n_cameras)
        )
        for i in range(n_sets)
    ]
    rig_q = np.tile(np.array([1.0, 0, 0, 0]), (n_sets, 1))
    rig_t = np.zeros((n_sets, 3))
    for i in range(n_sets):
        if not used[i]:
            continue
        r, t = dense_results[0].image_tr_global[i]
        rig_q[i] = se3.matrix_to_quat_np(r)
        rig_t[i] = t

    # camera_tr_rig via SE(3) averaging (reference: calibration.cc:885-911).
    cam_q = np.tile(np.array([1.0, 0, 0, 0]), (n_cameras, 1))
    cam_t = np.zeros((n_cameras, 3))
    for c in range(1, n_cameras):
        qs, ts = [], []
        for i in range(n_sets):
            if not used[i]:
                continue
            r_c, t_c = dense_results[c].image_tr_global[i]
            r_0, t_0 = dense_results[0].image_tr_global[i]
            # camera_tr_rig = image_tr_global[c] ∘ (image_tr_global[0])⁻¹
            r_rel = r_c @ r_0.T
            t_rel = t_c - r_rel @ t_0
            qs.append(se3.matrix_to_quat_np(r_rel))
            ts.append(t_rel)
        if qs:
            qa, ta = se3.average_se3(
                torch.as_tensor(np.stack(qs), device=host),
                torch.as_tensor(np.stack(ts), device=host))
            cam_q[c] = qa.numpy()
            cam_t[c] = ta.numpy()

    pts = initial_points(
        dataset, fid_to_idx, dense_results[0].global_tr_known_geometry
    )

    if model_kind == "central_generic":
        intrinsics = tuple(
            fit_initial_model(dense_results[c], grid_resolution, dtype=dtype,
                              device=host)
            for c in range(n_cameras)
        )
    elif model_kind == "noncentral_generic":
        intrinsics = tuple(
            fit_initial_model_noncentral(dense_results[c], grid_resolution,
                                         device=host)
            for c in range(n_cameras)
        )
    elif model_kind in _PARAMETRIC_KINDS:
        intrinsics = tuple(
            fit_initial_model_parametric(dense_results[c], model_kind,
                                         dtype=dtype, device=host)
            for c in range(n_cameras)
        )
    else:
        raise ValueError(f"unknown model kind {model_kind}")

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    state = BAState(
        rig_q_global=t(rig_q),
        rig_t_global=t(rig_t),
        cam_q_rig=t(cam_q),
        cam_t_rig=t(cam_t),
        points=t(pts),
        intrinsics=cast_floating(intrinsics, dtype, device),
    )

    # Observation tables: only used imagesets, one table per camera.
    data = build_per_camera_tables(
        dataset, fid_to_idx, image_used=used, dtype=dtype, device=device
    )
    return state, data, fid_to_idx, used

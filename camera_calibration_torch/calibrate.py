"""Calibration pipeline orchestration: pyramid BA, outliers, metric scale.

The reference's Calibrate() flow (reference:
applications/camera_calibration/src/camera_calibration/calibration.cc:918-1140):

1. pyramid loop over grid resolutions (factor 1.333 per level,
   calibration.cc:565-568): BA 10 iters @ threshold 1e-4 then 50 @ 1,
   then upsample the grid model by resampling (calibration.cc:373-…);
2. outlier phase: BA, then per-camera IQR-based outlier deletion
   (Q3 + factor·IQR, calibration.cc:104-107);
3. final BA (100 iters @ 1e-4);
4. an optional float64 polish on the CPU (calibration.cc:1127-1133);
5. metric scaling from known pattern-cell lengths via the log-mean
   neighbor-distance ratio (calibration.cc:307-370).

Bundle adjustment and the reprojection errors run on the device of the
state (the card in float32, through the CUDA kernels); the polish moves the
state to the CPU in float64.  The grid resample is a host NumPy solve.

The reference package also has a thread that prepares the finer pyramid
levels' executables while the coarse ones run, and a scope that flips
JAX's global 64-bit flag around the polish; both serve its TPU runtime and
JAX's global configuration, and have no counterpart here: a pyramid level
needs no compilation, and float64 tensors need no global switch.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from camera_calibration_torch.ba import lm_pcg
from camera_calibration_torch.ba.state import (
    BAState, scale_state, transform_to_camera,
)
from camera_calibration_torch.config import host_device
from camera_calibration_torch.models import central_generic as cg
from camera_calibration_torch.models import noncentral_generic as ncg
from camera_calibration_torch.models import parametric as pm
from camera_calibration_torch.models import protocol
from camera_calibration_torch.models.base import cast_floating


def _np(a):
    """float64 NumPy copy of an array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


@dataclasses.dataclass
class CalibrateOptions:
    num_pyramid_levels: int = 3
    approx_pixels_per_cell: int = 25
    outlier_removal_factor: float = 8.0  # reference CLI default
    final_iterations: int = 100
    pyramid_iterations: tuple = (10, 50)
    max_pcg_iterations: int = 50
    huber_px: float = 1.0
    # freeze groups ("points", "intrinsics", ...): the reference's
    # --localize_only is freeze=("points", "intrinsics")
    freeze: tuple = ()
    # LM iterations per cached-blocks call. 1 = the two-pass step, with a
    # checkpoint/callback per iteration; >1 coarsens checkpoints to every
    # k-th accepted iteration.
    lm_steps_per_call: int = 1
    # Warm-start each PCG solve from the previous accepted LM step
    # (effective with lm_steps_per_call > 1).  Measured on the 262k-obs
    # bench: same iteration rate, ~9x lower cost after 30 iterations —
    # the capped CG solves keep refining the same Krylov direction
    # across LM iterations.  Off by default for reference-trajectory
    # parity in the early (pyramid) iterations.
    cg_warm_start: bool = False
    # Per-sweep projection LM iteration cap.  Projections are warm-started
    # from the previous iteration's pixels, so 4 matches the converged
    # trajectory of 10 on calibration-shaped problems while cutting the
    # dominant blocks-pass cost (measured: identical cost trajectory
    # through 30 iterations on the 262k-obs bench).
    proj_iterations: int = 4
    # Solver mode — the user surface for the reference's --schur_mode
    # family (Readme.md:330-352).  See BAOptions.solver for the five
    # modes; "schur_direct" (exact reduced Newton step) wins
    # time-to-convergence on small/medium problems, the Schur-PCG
    # default wins at scale.
    solver: str = "auto"
    # Memory-bounded streaming: evaluate residual/Jacobian blocks in
    # chunks of this many observations — the analog of the reference's
    # on-the-fly SchurModes (lm_optimizer.h:297-307).
    block_chunk: int | None = None
    # Mixed-precision polish: after the float32 pipeline on the card, run
    # this many LM iterations in float64 on the CPU to secure the final
    # RMSE — the reference follows its f32 CUDA BA with 10 CPU f64
    # iterations (calibration.cc:1127-1133).  0 disables; no-op when the
    # state is already float64.
    polish_iterations: int = 0


def compute_grid_resolution(calib_w, calib_h, approx_pixels_per_cell,
                            exterior_cells_per_side=1):
    """(reference: calibration.cc:531-541 ComputeGridResolution)"""
    rx = int(calib_w / approx_pixels_per_cell + 0.5) + 2 * exterior_cells_per_side
    ry = int(calib_h / approx_pixels_per_cell + 0.5) + 2 * exterior_cells_per_side
    return rx, ry


def grid_resolution_for_level(level, full_x, full_y):
    """(reference: calibration.cc:565-568 CalcGridResolutionForLevel)"""
    return (
        int(full_x * math.pow(1.333, -level) + 0.5),
        int(full_y * math.pow(1.333, -level) + 0.5),
    )


def _bspline_axis_weights_np(g, size):
    """(N, size) cubic uniform B-spline weight rows, host NumPy.

    NumPy mirror of ops/bspline.dense_axis_weights for the host-side
    resample solves.
    """
    g = np.asarray(g, np.float64)
    base = np.clip(np.floor(g).astype(int) - 1, 0, size - 4)
    t = g - (base + 1)
    t2, t3 = t * t, t * t * t
    w0 = (1 - 3 * t + 3 * t2 - t3) / 6.0
    w1 = (4 - 6 * t2 + 3 * t3) / 6.0
    w2 = (1 + 3 * t + 3 * t2 - 3 * t3) / 6.0
    w3 = t3 / 6.0
    weights = np.zeros((g.size, size))
    idx = np.arange(g.size)
    for k, wk in enumerate((w0, w1, w2, w3)):
        weights[idx, base + k] = wk
    return weights


def _linear_grid_resample(grid_old, new_hw, *, normalize_samples,
                          normalize_knots, samples_per_cell=3):
    """Solve new spline knots reproducing an old spline surface, exactly.

    Model→model grid resampling is LINEAR in the new knots: sample the
    old surface on a product grid covering the shared calibrated area,
    then solve the separable least-squares system
    ``G = (WyᵀWy)⁻¹ Wyᵀ D Wx (WxᵀWx)⁻¹`` per channel.  This replaces the
    iterative dense-model refit the reference reuses here (the refit
    exists for fitting noisy *data*; for resampling, the target IS a
    spline surface, so the LSQ solution is essentially exact) — measured
    ~15 ms and 3e-6 deg median direction error vs the old model, against
    ~13 s and 7e-2 deg for the 20-iteration LM refit it replaces.
    (reference: calibration.cc:373-472 ResampleModel)

    grid_old: (gh, gw, C) array or tensor; new_hw: (ry, rx).
    normalize_samples: normalize sampled rows to unit length (direction
    surfaces — matches what the model's unproject emits);
    normalize_knots: renormalize the solved knots (direction grids keep
    unit knots for the manifold parametrization).
    """
    ry, rx = new_hw
    grid_old = _np(grid_old)
    gh_o, gw_o = grid_old.shape[:2]
    channels = grid_old.shape[2]
    nx = max(samples_per_cell * rx, rx + 4)
    ny = max(samples_per_cell * ry, ry + 4)
    # normalized sample coordinates u ∈ (0, 1) over the calibrated
    # extent; both grids map pixel→grid affinely over the same extent
    # (central_grid.h:148-154), so only u matters.
    ux = (np.arange(nx) + 0.5) / nx
    uy = (np.arange(ny) + 0.5) / ny
    wx_o = _bspline_axis_weights_np(1.0 + (gw_o - 3.0) * ux, gw_o)
    wy_o = _bspline_axis_weights_np(1.0 + (gh_o - 3.0) * uy, gh_o)
    dense = np.einsum("yk,kjc,xj->yxc", wy_o, grid_old, wx_o)
    if normalize_samples:
        dense /= np.maximum(
            np.linalg.norm(dense, axis=-1, keepdims=True), 1e-12
        )
    wx = _bspline_axis_weights_np(1.0 + (rx - 3.0) * ux, rx)
    wy = _bspline_axis_weights_np(1.0 + (ry - 3.0) * uy, ry)
    ay = wy.T @ wy + 1e-9 * np.eye(ry)
    ax = wx.T @ wx + 1e-9 * np.eye(rx)
    g = np.linalg.solve(
        ay, np.einsum("yk,yxc->kxc", wy, dense).reshape(ry, -1)
    ).reshape(ry, nx, channels)
    g = np.linalg.solve(
        ax, np.einsum("xj,kxc->jkc", wx, g).reshape(rx, -1)
    ).reshape(rx, ry, channels).transpose(1, 0, 2)
    if normalize_knots:
        g /= np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)
    # row-major, as the kernels take the grid
    return np.ascontiguousarray(g)


def resample_central_generic(model: cg.CentralGenericModel, new_resolution,
                             samples_per_cell: int = 3):
    """Resample a CentralGeneric grid model to a new resolution.

    (reference: calibration.cc:429-472 ResampleModel CentralGeneric path;
    see _linear_grid_resample for why this is a direct linear solve here
    rather than the reference's iterative FitToDenseModel.)
    """
    grid = _linear_grid_resample(
        model.grid, (new_resolution[1], new_resolution[0]),
        normalize_samples=True, normalize_knots=True,
        samples_per_cell=samples_per_cell,
    )
    return dataclasses.replace(model, grid=torch.as_tensor(
        grid, dtype=model.grid.dtype, device=model.grid.device))


def resample_noncentral_generic(model, new_resolution,
                                samples_per_cell: int = 3):
    """Resample a NoncentralGeneric model to a new resolution.

    Both grids go through the exact linear spline resample of the central
    path (the reference bilinearly interpolates them, calibration.cc:
    385-421): the direction grid from the normalized direction surface
    (unit knots for the 2-DoF manifold), the point grid from the raw point
    surface.
    """
    hw = (new_resolution[1], new_resolution[0])
    dir_grid = _linear_grid_resample(
        model.direction_grid, hw,
        normalize_samples=True, normalize_knots=True,
        samples_per_cell=samples_per_cell,
    )
    point_grid = _linear_grid_resample(
        model.point_grid, hw,
        normalize_samples=False, normalize_knots=False,
        samples_per_cell=samples_per_cell,
    )
    like = model.direction_grid
    return dataclasses.replace(
        model,
        direction_grid=torch.as_tensor(dir_grid, dtype=like.dtype,
                                       device=like.device),
        point_grid=torch.as_tensor(point_grid, dtype=like.dtype,
                                   device=like.device))


def resample_grid_model(model, new_resolution, **kw):
    """Resolution resample for any grid model (central or noncentral)."""
    if isinstance(model, ncg.NoncentralGenericModel):
        return resample_noncentral_generic(model, new_resolution, **kw)
    return resample_central_generic(model, new_resolution, **kw)


def model_kind_of(model) -> str:
    """CLI model-kind string for a model instance."""
    if isinstance(model, ncg.NoncentralGenericModel):
        return "noncentral_generic"
    if isinstance(model, cg.CentralGenericModel):
        return "central_generic"
    if isinstance(model, pm.CentralThinPrismFisheyeModel):
        return "central_thin_prism_fisheye"
    if isinstance(model, pm.CentralOpenCVModel):
        return "central_opencv"
    if isinstance(model, pm.CentralRadialModel):
        return "central_radial"
    return type(model).__name__


def convert_model(model, target_kind, target_resolution, dtype=None):
    """Convert a camera model to a different kind (and/or resolution).

    The general arm of the reference's ResampleModel
    (calibration.cc:424-525): unproject the source model densely over
    its calibrated area, then fit the target model to the dense
    direction image.  Noncentral sources convert only to noncentral
    targets (same reference restriction, calibration.cc:424-427).
    Returns (new_model, rotation_quat_or_None) on the source model's
    device — parametric fits co-estimate a rotation that the caller must
    fold into cam_T_rig (calibration.cc:497-503); grid targets return
    None.  The fits run on ``config.host_device()``.
    """
    from camera_calibration_torch.models.fit import (
        fit_central_generic_to_dense,
    )

    fit_device = host_device()
    source_kind = model_kind_of(model)
    like = protocol.model_tensor(model)
    dtype = dtype or like.dtype
    if source_kind == target_kind and source_kind in (
        "central_generic", "noncentral_generic",
    ):
        return resample_grid_model(model, target_resolution), None
    if source_kind == "noncentral_generic":
        raise ValueError(
            "a NoncentralGeneric model can only be resampled to "
            "NoncentralGeneric (reference calibration.cc:424-427)"
        )

    # dense direction image over the calibrated area (≤300 samples/axis,
    # reference kMaxXSamplesForFitting)
    min_x = getattr(model, "calibration_min_x", 0)
    min_y = getattr(model, "calibration_min_y", 0)
    max_x = getattr(model, "calibration_max_x", model.width - 1)
    max_y = getattr(model, "calibration_max_y", model.height - 1)
    w = max_x + 1 - min_x
    h = max_y + 1 - min_y
    step = max(1, int(round(min(w / 300.0, h / 300.0))))
    xs = np.arange(min_x, max_x + 1, step) + 0.5
    ys = np.arange(min_y, max_y + 1, step) + 0.5
    gx, gy = np.meshgrid(xs, ys)
    pixel_coords = np.stack([gx, gy], -1)
    px = torch.as_tensor(pixel_coords.reshape(-1, 2), dtype=dtype,
                         device=like.device)
    dirs, valid = protocol.unproject(model, px)
    dense = _np(dirs).reshape(len(ys), len(xs), 3)
    vmask = valid.cpu().numpy().reshape(len(ys), len(xs))

    if target_kind in ("central_generic", "noncentral_generic"):
        rx, ry = target_resolution
        fitted = fit_central_generic_to_dense(
            dense, vmask, (ry, rx),
            width=len(xs), height=len(ys),
            calibration_min_x=0, calibration_min_y=0,
            calibration_max_x=len(xs) - 1, calibration_max_y=len(ys) - 1,
            dtype=dtype, device=fit_device,
        )
        central = cg.CentralGenericModel(
            grid=fitted.grid.to(like.device),
            width=model.width, height=model.height,
            calibration_min_x=min_x, calibration_min_y=min_y,
            calibration_max_x=max_x, calibration_max_y=max_y,
        )
        if target_kind == "noncentral_generic":
            # zero point grid = the reference's
            # InitializeFromCentralGenericModel (calibration.cc:459-466)
            return ncg.from_central(central), None
        return central, None

    # parametric targets: fit in the subsampled raster with the true
    # pixel coordinates, co-estimating the alignment rotation
    zeros = {"central_thin_prism_fisheye": 12, "central_opencv": 12,
             "central_radial": 8 + 50}
    if target_kind not in zeros:
        raise ValueError(f"unknown target model kind {target_kind}")
    params = torch.zeros(zeros[target_kind], dtype=dtype, device=fit_device)
    if target_kind == "central_thin_prism_fisheye":
        template = pm.CentralThinPrismFisheyeModel(
            params=params, width=model.width, height=model.height,
            use_equidistant_projection=True)
    elif target_kind == "central_opencv":
        template = pm.CentralOpenCVModel(
            params=params, width=model.width, height=model.height)
    else:
        template = pm.CentralRadialModel(
            params=params, width=model.width, height=model.height)
    fitted, quat = pm.fit_parametric_to_dense(
        template, dense, vmask, dtype=dtype, co_estimate_rotation=True,
        pixel_coords=pixel_coords, device=fit_device,
    )
    return (cast_floating(fitted, device=like.device),
            quat.to(like.device))


def resample_models_if_necessary(state: BAState, model_kind: str,
                                 approx_pixels_per_cell: int,
                                 pyramid_level: int, log=print):
    """Resample/convert loaded models when the request differs.

    The reference's resume-time policy (calibration.cc:571-612
    ResampleModelsIfNecessary, called from Calibrate() at :999): for
    each camera, compute the desired grid resolution at the coarsest
    requested pyramid level; when the loaded grid resolution or the
    loaded model type differs from the request, resample/convert.
    Returns the (possibly updated) state.
    """
    from camera_calibration_torch.ops import se3

    new_intr = list(state.intrinsics)
    cam_q = state.cam_q_rig.clone()
    changed = False
    for ci, model in enumerate(state.intrinsics):
        min_x = getattr(model, "calibration_min_x", 0)
        min_y = getattr(model, "calibration_min_y", 0)
        max_x = getattr(model, "calibration_max_x", model.width - 1)
        max_y = getattr(model, "calibration_max_y", model.height - 1)
        full = compute_grid_resolution(
            max_x + 1 - min_x, max_y + 1 - min_y, approx_pixels_per_cell
        )
        rx, ry = grid_resolution_for_level(pyramid_level, *full)
        rx, ry = max(4, rx), max(4, ry)
        cur_kind = model_kind_of(model)
        cur_res = None
        if protocol.is_grid_model(model):
            g = protocol.model_tensor(model)
            cur_res = (g.shape[1], g.shape[0])
        if cur_kind == model_kind and (
            cur_res is None or cur_res == (rx, ry)
        ):
            continue
        log(
            f"[calibrate] resampling camera {ci}: {cur_kind}"
            f"{cur_res or ''} -> {model_kind} ({rx}x{ry})"
        )
        new_model, quat = convert_model(model, model_kind, (rx, ry))
        new_intr[ci] = new_model
        if quat is not None:
            # parametric_tr_dense rotation folds into cam_T_rig
            # (calibration.cc:497-503)
            cam_q[ci] = se3.quat_mul(quat.to(cam_q.dtype), cam_q[ci])
        changed = True
    if not changed:
        return state
    return dataclasses.replace(state, cam_q_rig=cam_q,
                               intrinsics=tuple(new_intr))


def observation_reprojection_errors(state: BAState, data):
    """Per-camera tensors of reprojection error magnitudes (inf = invalid),
    on the device of the state: on the card, the projection is the
    ``project`` kernel (30 LM iterations, warm-started at the measured
    pixels)."""
    errs = []
    for ci, seg in enumerate(data):
        x_cam, _ = transform_to_camera(
            state, seg.imageset, seg.camera, state.points[seg.point])
        px, _, pvalid = protocol.project_points(
            state.intrinsics[ci], x_cam, init_xy=seg.pixel, max_iterations=30)
        e = torch.linalg.vector_norm(px - seg.pixel, dim=-1)
        errs.append(torch.where(pvalid & seg.valid, e,
                                torch.full_like(e, math.inf)))
    return errs


def delete_outlier_features(state: BAState, data, factor: float):
    """Invalidate observations beyond Q3 + factor·IQR, per camera.

    (reference: calibration.cc:62-120 DeleteOutlierFeatures)
    Returns (new data, number removed).
    """
    errs = observation_reprojection_errors(state, data)
    new_data = []
    removed = 0
    for seg, e in zip(data, errs):
        e_np = _np(e)
        finite = np.isfinite(e_np) & seg.valid.cpu().numpy()
        if finite.sum() < 8:  # reference's arbitrary minimum
            new_data.append(seg)
            continue
        vals = np.sort(e_np[finite])
        q1 = vals[min(len(vals) - 1, int(0.25 * len(vals) + 0.5))]
        q3 = vals[min(len(vals) - 1, int(0.75 * len(vals) + 0.5))]
        thresh = q3 + factor * (q3 - q1)
        keep = finite & (e_np <= thresh)
        removed += int(finite.sum() - keep.sum())
        new_data.append(dataclasses.replace(
            seg, valid=torch.as_tensor(keep, device=seg.valid.device)))
    return tuple(new_data), removed


def scale_to_metric(state: BAState, known_geometries, feature_id_to_point_index):
    """Metric scale from known pattern-cell lengths.

    (reference: calibration.cc:307-370 ScaleToMetric) — log-mean of
    ideal/actual distances of axis-aligned neighbor corners.  The state
    keeps its device and dtype.
    """
    pts = _np(state.points)
    log_sum = 0.0
    count = 0
    for geom in known_geometries:
        pos_to_index = {}
        for fid, pos in geom.feature_id_to_position.items():
            if fid in feature_id_to_point_index:
                pos_to_index[tuple(pos)] = feature_id_to_point_index[fid]
        for pos, idx in pos_to_index.items():
            for dx, dy in ((1, 0), (0, 1)):
                nb = (pos[0] + dx, pos[1] + dy)
                if nb not in pos_to_index:
                    continue
                actual = np.linalg.norm(pts[idx] - pts[pos_to_index[nb]])
                if actual <= 0:
                    continue
                log_sum += math.log(geom.cell_length_in_meters / actual)
                count += 1
    if count == 0:
        return state, 1.0
    factor = math.exp(log_sum / count)
    return scale_state(state, factor), factor


def polish_float64(state, data, options: CalibrateOptions,
                   callback=None, state_saver=None, log=print):
    """Float64 polish of a float32 calibration, on the CPU.

    The BA on the card runs in float32 (the CUDA kernels take float32
    only, and their wrappers raise on a float64 CUDA tensor); like the
    reference's f32 CUDA BA, it is followed by a few float64 LM iterations
    on the CPU to secure the final RMSE (reference: calibration.cc:1127-1133
    runs 10 CPU iterations at threshold 1e-4 after the CUDA pass).  So the
    state and the tables move explicitly to the CPU (``device="cpu"``) in
    float64 here, and the polish runs the plain versions there.
    Returns (state64, data64, info): float64 CPU state and tables (valid
    masks untouched) for the report and for saving.
    """
    cpu = torch.device("cpu")
    state64 = cast_floating(state, torch.float64, cpu)
    data64 = cast_floating(data, torch.float64, cpu)
    state64, info = run_ba(
        state64, data64, options.polish_iterations, 1e-4, options,
        callback=callback, state_saver=state_saver,
    )
    return state64, data64, info


def _ba_options(options, max_iterations, cost_reduction_threshold):
    return lm_pcg.BAOptions(
        max_lm_iterations=max_iterations,
        max_pcg_iterations=options.max_pcg_iterations,
        huber_px=options.huber_px,
        cost_reduction_threshold=cost_reduction_threshold,
        freeze=tuple(options.freeze),
        lm_steps_per_call=max(1, int(options.lm_steps_per_call)),
        cg_warm_start=options.cg_warm_start,
        proj_iterations=options.proj_iterations,
        solver=options.solver,
        block_chunk=options.block_chunk,
    )


def run_ba(state, data, max_iterations, cost_reduction_threshold, options,
           callback=None, state_saver=None):
    """One ``lm_pcg.optimize`` run with the pipeline's options; the state
    is checkpointed through ``state_saver`` after every accepted
    iteration."""
    ba_opts = _ba_options(options, max_iterations, cost_reduction_threshold)

    def cb(entry, st):
        if callback is not None:
            callback(entry, st)
        # checkpoint after every accepted iteration (the reference saves
        # the BA state each iteration, calibration.cc:242-245)
        if state_saver is not None and entry["accepted"]:
            state_saver(st)

    return lm_pcg.optimize(state, None, None, ba_opts, data=data, callback=cb)


def calibrate(
    state: BAState,
    data,
    options: CalibrateOptions = CalibrateOptions(),
    *,
    known_geometries=None,
    feature_id_to_point_index=None,
    log=print,
    state_output_path=None,
    image_used=None,
    visualizer=None,
):
    """Full calibration from an initialized state.

    state.intrinsics must already be at the *coarsest* pyramid resolution
    (``build_ba_state`` at ``grid_resolution_for_level(levels - 1, ...)``);
    data = per-camera observation tables, on the state's device.
    Returns (state, data, report dict).

    state_output_path: if set, the BA state is checkpointed there after
    every accepted LM iteration (reference: calibration.cc:242-245) so a
    crashed run can resume.

    visualizer: optional ui.calibration_visualizer.CalibrationVisualizer;
    its per-stage hooks are invoked as the pipeline progresses, mirroring
    how the reference's Calibrate() drives its CalibrationWindow after
    each BA iteration (calibration.cc:256-290).  The hooks only read the
    state and the tables: the result is the same with or without one.
    """
    report = {"pyramid": [], "outliers_removed": 0, "scale_factor": 1.0}

    vis_callback = None
    if visualizer is not None:
        # closes over ``data``, which is rebound after outlier removal;
        # during the float64 CPU polish the tables are read in the
        # polish's type on its device
        def vis_callback(entry, st):
            if entry["accepted"]:
                visualizer.update_reprojection_errors(
                    st, cast_floating(data, st.points.dtype, st.points.device),
                    iteration=entry["iteration"])

    state_saver = None
    if state_output_path is not None and feature_id_to_point_index is not None:
        from camera_calibration_torch.io import state_io

        def state_saver(st):
            # Persist the real image_used set: never-localized imagesets
            # still carry identity rig poses, and recording them as used
            # would inject gross outliers on resume.
            used = (
                list(image_used) if image_used is not None
                else [True] * st.rig_q_global.shape[0]
            )
            state_io.save_ba_state(
                state_output_path, st, used, feature_id_to_point_index
            )

    grid_cameras = [
        ci for ci, m in enumerate(state.intrinsics) if protocol.is_grid_model(m)
    ]
    full_res = {}
    for ci in grid_cameras:
        m = state.intrinsics[ci]
        full_res[ci] = compute_grid_resolution(
            m.calibration_max_x + 1 - m.calibration_min_x,
            m.calibration_max_y + 1 - m.calibration_min_y,
            options.approx_pixels_per_cell,
        )

    # reference: pyramid loop only runs when intrinsics are optimized
    # (calibration.cc:1050 "pyramid_level > 0 && !localize_only")
    pyramid_levels = (
        0 if "intrinsics" in options.freeze else options.num_pyramid_levels
    )
    for level in range(pyramid_levels - 1, 0, -1):
        log(f"[calibrate] pyramid level {level}")
        state, info1 = run_ba(
            state, data, options.pyramid_iterations[0], 1e-4, options,
            callback=vis_callback, state_saver=state_saver,
        )
        state, info2 = run_ba(
            state, data, options.pyramid_iterations[1], 1.0, options,
            callback=vis_callback, state_saver=state_saver,
        )
        report["pyramid"].append(
            {"level": level, "cost": info2["final_cost"] or info1["final_cost"]}
        )
        # Upsample grid models (central AND noncentral, reference:
        # calibration.cc:1050-1094) to the next level's resolution.
        new_intr = list(state.intrinsics)
        for ci in grid_cameras:
            rx, ry = grid_resolution_for_level(level - 1, *full_res[ci])
            new_intr[ci] = resample_grid_model(state.intrinsics[ci], (rx, ry))
        state = dataclasses.replace(state, intrinsics=tuple(new_intr))

    if options.outlier_removal_factor > 0:
        iters = (
            options.final_iterations
            if options.num_pyramid_levels == 1
            else options.pyramid_iterations[0]
        )
        state, _ = run_ba(state, data, iters, 1e-4, options,
                          callback=vis_callback, state_saver=state_saver)
        data, removed = delete_outlier_features(
            state, data, options.outlier_removal_factor
        )
        report["outliers_removed"] = removed
        log(f"[calibrate] removed {removed} outlier observations")
        if visualizer is not None:
            visualizer.update_removed_outliers(state, data, removed)

    state, info = run_ba(state, data, options.final_iterations, 1e-4, options,
                         callback=vis_callback, state_saver=state_saver)
    report["final_cost"] = info["final_cost"]
    solver_report = info.get("report")
    if solver_report is not None:
        report["solver"] = solver_report.as_dict()
        log(
            "[calibrate] final BA: "
            f"{solver_report.iterations} iters "
            f"({solver_report.accepted} accepted), "
            f"cost {solver_report.initial_cost:.4g} -> "
            f"{solver_report.final_cost:.4g}, "
            f"{solver_report.step_seconds:.2f}s steps "
            f"+ {solver_report.first_call_seconds:.2f}s first call"
        )

    # mixed-precision mode: the float64 CPU polish after the float32 BA
    # (reference: calibration.cc:1127-1133).  The metric scale and the
    # report's errors then run on the float64 CPU state.
    if options.polish_iterations > 0 and state.points.dtype == torch.float32:
        state, data, pinfo = polish_float64(
            state, data, options, callback=vis_callback,
            state_saver=state_saver, log=log)
        if pinfo["final_cost"] is not None:
            report["final_cost_f32"] = report["final_cost"]
            report["polish_cost"] = pinfo["final_cost"]
            pre = report["final_cost"]
            log(
                f"[calibrate] f64 polish "
                f"({options.polish_iterations} iters): cost "
                f"{pre if pre is None else format(pre, '.6g')} -> "
                f"{pinfo['final_cost']:.6g}"
            )
            report["final_cost"] = pinfo["final_cost"]

    # reference skips metric scaling in localize-only mode
    # (calibration.cc:1136-1139)
    if (known_geometries and feature_id_to_point_index
            and "points" not in options.freeze):
        state, factor = scale_to_metric(
            state, known_geometries, feature_id_to_point_index
        )
        report["scale_factor"] = factor
        log(f"[calibrate] metric scale factor {factor:.6f}")

    if visualizer is not None:
        visualizer.update_error_histogram(state, data)
        visualizer.update_error_directions(state, data)
        for ci, m in enumerate(state.intrinsics):
            visualizer.update_observation_directions(ci, m)

    errs = observation_reprojection_errors(state, data)
    all_err = np.concatenate([_np(e) for e in errs])
    all_err = all_err[np.isfinite(all_err)]
    if all_err.size:
        report["reprojection_error_median"] = float(np.median(all_err))
        report["reprojection_error_average"] = float(np.mean(all_err))
        report["reprojection_error_maximum"] = float(np.max(all_err))
    return state, data, report

"""The synthetic bundle-adjustment problems of the benchmark.

A CentralGeneric mono problem sized like a real calibration run: 256 poses
of a 1024-point board seen by a 640×480 camera with a 16×16 direction grid,
in (poses × points) grid layout (262,144 rows).  The random draws come from
numpy in the same order as the reference package's ``bench.py``, so the
state is the same; the observations come from this package's projection.

Its NoncentralGeneric twin takes the same draws, adds a smooth line-origin
field and projects through the noncentral model (the recipe of the
reference package's ``tests/test_ba.py:138-210`` at the bench's size).
Its parametric twins take the same draws and project through a
ThinPrismFisheye, OpenCV or Radial camera.

``make_calibration_dataset`` is a feature dataset for the whole pipeline
(dense initialization, initial state, calibration): a pinhole camera's
views of a square board, with the draws of the reference package's
``tests/test_dense_init.py:_make_synthetic_dataset``.
``make_noncentral_calibration_dataset`` is its NoncentralGeneric
counterpart, for the noncentral initialization from scratch: the
cross-slit camera and the draws of the reference package's
``tests/test_noncentral_init.py:_make_dataset``, at any image size and
board.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from camera_calibration_torch.ba.dataset import (
    Dataset, Imageset, KnownGeometry, ObservationTable, PointFeature,
)
from camera_calibration_torch.ba.state import (
    BAState, broadcast_rows, transform_to_camera,
)
from camera_calibration_torch.config import default_device, host_device
from camera_calibration_torch.models import central_generic as cg
from camera_calibration_torch.models import noncentral_generic as ncg
from camera_calibration_torch.models import noncentral_generic_cuda as ncgc
from camera_calibration_torch.models import parametric as pm
from camera_calibration_torch.models import pinhole
from camera_calibration_torch.models.base import replace
from camera_calibration_torch.ops import manifolds, se3


def pinhole_model(w, h, gw, gh, device=None, dtype=torch.float32):
    """A CentralGeneric model whose (gh, gw) direction grid samples a
    pinhole camera (focal length 0.85·w) over the whole w×h image."""
    f = 0.85 * w
    yy, xx = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    px = (xx - 1.0) / (gw - 3.0) * w
    py = (yy - 1.0) / (gh - 3.0) * h
    dirs = np.stack([(px - w / 2) / f, (py - h / 2) / f,
                     np.ones_like(px, float)], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return cg.CentralGenericModel(
        grid=torch.as_tensor(dirs, dtype=dtype,
                             device=default_device(device)),
        width=w, height=h,
        calibration_min_x=0, calibration_min_y=0,
        calibration_max_x=w - 1, calibration_max_y=h - 1,
    )


def _bench_draws(w, h, gres, n_points, n_poses, seed, device, dtype):
    """The bench problem's unperturbed state (from ``bench.py``'s numpy
    draws) and every (pose, point) pair's camera-space point, float64 on
    the CPU, (M·P, 3) pose-major."""
    rng = np.random.default_rng(seed)
    model = pinhole_model(w, h, gres, gres, device, dtype)

    pts = np.stack(
        [rng.uniform(-0.7, 0.7, n_points), rng.uniform(-0.5, 0.5, n_points),
         rng.uniform(-0.02, 0.02, n_points)], -1)
    # float64 on the CPU, then cast: the pose math of bench.py
    rig_q = torch.stack([se3.quat_exp(torch.as_tensor(rng.normal(0, 0.08, 3)))
                         for _ in range(n_poses)])
    rig_t = np.stack([
        [rng.uniform(-0.25, 0.25), rng.uniform(-0.25, 0.25),
         rng.uniform(1.6, 2.4)]
        for _ in range(n_poses)
    ])

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    state = BAState(
        rig_q_global=t(rig_q), rig_t_global=t(rig_t),
        cam_q_rig=t([[1.0, 0.0, 0.0, 0.0]]), cam_t_rig=t(np.zeros((1, 3))),
        points=t(pts), intrinsics=(model,),
    )
    x_cam = (se3.quat_rotate(rig_q[:, None, :], torch.as_tensor(pts)[None])
             + torch.as_tensor(rig_t)[:, None, :])
    return state, x_cam.reshape(-1, 3)


def _grid_table(pxs, valid, w, h, m, p):
    """The (M, P) grid-layout table of projected pixels: rows valid where
    the projection is and lies 1 px inside the image."""
    device = pxs.device
    inside = (valid & (pxs[:, 0] > 1) & (pxs[:, 0] < w - 1)
              & (pxs[:, 1] > 1) & (pxs[:, 1] < h - 1))
    return ObservationTable(
        imageset=torch.arange(m, device=device).repeat_interleave(p),
        camera=torch.zeros(m * p, dtype=torch.int64, device=device),
        point=torch.arange(p, device=device).repeat(m),
        pixel=torch.where(inside[:, None], pxs, 0.0),
        valid=inside,
        grid_shape=(m, p),
    )


def make_bench_problem(w=640, h=480, gres=16, n_points=1024, n_poses=256,
                       seed=0, device=None, dtype=torch.float32):
    """(state, data tuple, meta) of the benchmark problem on ``device``."""
    device = default_device(device)
    state, x_cam = _bench_draws(w, h, gres, n_points, n_poses, seed, device,
                                dtype)
    # Exact observations of every (pose, point) pair, in one batch.
    pxs, _, valid = cg.project_points(
        state.intrinsics[0], x_cam.to(dtype=dtype, device=device),
        max_iterations=40)
    table = _grid_table(pxs, valid, w, h, n_poses, n_points)
    state = perturb_bench_state(state, seed=seed + 1)
    return state, (table,), {"n_obs": int(table.valid.sum()), "gres": gres}


def make_noncentral_bench_problem(w=640, h=480, gres=16, n_points=1024,
                                  n_poses=256, seed=0, device=None,
                                  dtype=torch.float32):
    """(state, data tuple, meta) of the bench problem with a
    NoncentralGeneric camera: the bench's draws and direction grid, the
    line-origin field (0.002·sin(x/2), 0.002·cos(y/2), 0) over the knots,
    observations projected through that model (80 LM iterations), and the
    state perturbed by :func:`perturb_noncentral_state`."""
    device = default_device(device)
    state, x_cam = _bench_draws(w, h, gres, n_points, n_poses, seed, device,
                                dtype)
    central = state.intrinsics[0]
    yy, xx = np.meshgrid(np.arange(gres), np.arange(gres), indexing="ij")
    origins = np.stack([0.002 * np.sin(xx / 2.0), 0.002 * np.cos(yy / 2.0),
                        np.zeros_like(xx, float)], -1)
    model = replace(ncg.from_central(central),
                    point_grid=torch.as_tensor(origins, dtype=dtype,
                                               device=device))
    pxs, _, valid = ncgc.project_points(
        model, x_cam.to(dtype=dtype, device=device).contiguous(),
        max_iterations=80)
    table = _grid_table(pxs, valid, w, h, n_poses, n_points)
    state = dataclasses.replace(state, intrinsics=(model,))
    state = perturb_noncentral_state(state, seed=seed + 7)
    return state, (table,), {"n_obs": int(table.valid.sum()), "gres": gres}


def parametric_bench_model(kind, w=640, h=480, device=None,
                           dtype=torch.float32):
    """The bench's parametric cameras at w×h: ``"thin_prism_fisheye"``
    (equidistant, the parameters of the reference package's
    ``tests/ba_harness.py:51-53``), ``"opencv"`` (the same focal length and
    principal point, small k1..k6, p1, p2) or ``"radial"`` (30 knots of a
    smooth profile, as ``tests/test_parametric.py``'s Radial model)."""
    device = default_device(device)
    if kind == "thin_prism_fisheye":
        params = [0.75 * w, 0.75 * w, 0.5 * w, 0.5 * h,
                  0.1, -0.2, 0.1, -0.02, 1e-4, -5e-5, 3e-5, -4e-5]
        cls, extra = pm.CentralThinPrismFisheyeModel, dict(
            use_equidistant_projection=True)
    elif kind == "opencv":
        params = [0.75 * w, 0.75 * w, 0.5 * w, 0.5 * h,
                  0.05, -0.02, 0.004, 0.01, -0.005, 0.001, 1e-4, -5e-5]
        cls, extra = pm.CentralOpenCVModel, {}
    elif kind == "radial":
        t = np.linspace(0, 1, 30)
        params = np.concatenate([
            [0.65 * w, 0.65 * w, 0.5 * w, 0.5 * h, 1e-4, -8e-5, 4e-5, -6e-5],
            0.12 * t * t - 0.05 * t])
        cls, extra = pm.CentralRadialModel, {}
    else:
        raise ValueError(f"unknown parametric kind {kind!r}")
    return cls(params=torch.as_tensor(params, dtype=dtype, device=device),
               width=w, height=h, **extra)


def make_parametric_bench_problem(kind, w=640, h=480, n_points=1024,
                                  n_poses=256, seed=0, device=None,
                                  dtype=torch.float32):
    """(state, data tuple, meta) of the bench problem with a parametric
    camera (:func:`parametric_bench_model`): the bench's draws,
    observations projected through the model in float64, and the state
    perturbed by :func:`perturb_parametric_state`."""
    device = default_device(device)
    state, x_cam = _bench_draws(w, h, 16, n_points, n_poses, seed, device,
                                dtype)
    model = parametric_bench_model(kind, w, h, device, dtype)
    model64 = replace(model, params=model.params.double().cpu())
    pxs, _, valid = pm.project_points(model64, x_cam)
    table = _grid_table(pxs.to(dtype=dtype, device=device), valid.to(device),
                        w, h, n_poses, n_points)
    state = dataclasses.replace(state, intrinsics=(model,))
    state = perturb_parametric_state(state, seed=seed + 1)
    return state, (table,), {"n_obs": int(table.valid.sum()), "kind": kind}


def perturb_parametric_state(state: BAState, seed,
                             param_sigma=1e-3) -> BAState:
    """:func:`perturb_bench_state`, and each parameter p moved by normal
    noise of ``param_sigma``·max(|p|, 1) (the recipe of the reference
    package's ``tests/ba_harness.py:170-171``), from ``seed + 1``."""
    state = perturb_bench_state(state, seed)
    rng = np.random.default_rng(seed + 1)
    intr = []
    for model in state.intrinsics:
        p = model.params
        scale = torch.clamp_min(p.abs(), 1.0)
        noise = torch.as_tensor(rng.normal(0, param_sigma, tuple(p.shape)),
                                dtype=p.dtype, device=p.device)
        intr.append(replace(model, params=p + noise * scale))
    return dataclasses.replace(state, intrinsics=tuple(intr))


def perturb_noncentral_state(state: BAState, seed) -> BAState:
    """Noise on every group of a noncentral problem (the recipe of the
    reference package's ``tests/test_ba.py:190-210``): rig and camera poses
    by 0.005 (rotation and translation, the first camera kept), points by
    0.002, then, from ``seed + 1``, knot directions by 5e-4 in their
    tangent planes and knot origins by 5e-4."""
    rng = np.random.default_rng(seed)
    m = state.rig_q_global.shape[0]
    c = state.cam_q_rig.shape[0]

    def draw(sigma, shape, like):
        return torch.as_tensor(rng.normal(0, sigma, shape), dtype=like.dtype,
                               device=like.device)

    rig = torch.cat([draw(0.005, (m, 3), state.rig_t_global),
                     draw(0.005, (m, 3), state.rig_t_global)], -1)
    rig_q, rig_t = se3.retract_pose(state.rig_q_global, state.rig_t_global,
                                    rig)
    cam = torch.cat([draw(0.005, (c, 3), state.cam_t_rig),
                     draw(0.005, (c, 3), state.cam_t_rig)], -1)
    cam[0] = 0.0  # gauge anchor
    cam_q, cam_t = se3.retract_pose(state.cam_q_rig, state.cam_t_rig, cam)
    points = state.points + draw(0.002, tuple(state.points.shape),
                                 state.points)
    rng2 = np.random.default_rng(seed + 1)
    intr = []
    for model in state.intrinsics:
        gh, gw = model.grid_height, model.grid_width
        dg = model.direction_grid
        intr.append(replace(
            model,
            direction_grid=manifolds.retract_direction(
                dg, torch.as_tensor(rng2.normal(0, 5e-4, (gh, gw, 2)),
                                    dtype=dg.dtype, device=dg.device)),
            point_grid=model.point_grid + torch.as_tensor(
                rng2.normal(0, 5e-4, (gh, gw, 3)), dtype=dg.dtype,
                device=dg.device)))
    return BAState(rig_q_global=rig_q, rig_t_global=rig_t, cam_q_rig=cam_q,
                   cam_t_rig=cam_t, points=points, intrinsics=tuple(intr))


def perturb_bench_state(state: BAState, seed) -> BAState:
    """Fresh noise on poses and points so a run optimizes for real."""
    rng = np.random.default_rng(seed)

    def noise(like):
        return torch.as_tensor(rng.normal(0, 0.003, tuple(like.shape)),
                               dtype=like.dtype, device=like.device)

    rig_t = state.rig_t_global + noise(state.rig_t_global)
    points = state.points + noise(state.points)
    return BAState(
        rig_q_global=state.rig_q_global, rig_t_global=rig_t,
        cam_q_rig=state.cam_q_rig, cam_t_rig=state.cam_t_rig,
        points=points, intrinsics=state.intrinsics,
    )


def bench_projection_inputs(state: BAState, table):
    """The projection inputs of the bench problem's main path: unit camera
    directions (N, 3) of every observation row and the warm starts (N, 2)
    in grid coords (the observed pixels)."""
    model = state.intrinsics[0]
    x = broadcast_rows(state.points, table.point, table.grid_shape, 1)
    x_cam, _ = transform_to_camera(state, table.imageset, table.camera, x,
                                   grid_shape=table.grid_shape)
    norm = torch.linalg.vector_norm(x_cam, dim=-1, keepdim=True)
    dirs = (x_cam / torch.clamp_min(norm, 1e-18)).contiguous()
    return dirs, cg.pixel_to_grid(model, table.pixel).contiguous()


def pinhole_projection_inputs(model, n, rng):
    """Projection inputs of N uniform random pixels of a
    :func:`pinhole_model` (2 px from its edges): their unit directions
    (N, 3) and warm starts (N, 2) in grid coords, the pixels moved by
    normal noise of 2 px (numpy ``rng``)."""
    dev = model.grid.device
    w, h = model.width, model.height
    pix = torch.as_tensor(rng.uniform([2, 2], [w - 2, h - 2], (n, 2)),
                          dtype=torch.float32, device=dev)
    dirs, _ = cg.unproject(model, pix)
    warm = pix + torch.as_tensor(rng.normal(0, 2.0, (n, 2)),
                                 dtype=torch.float32, device=dev)
    return dirs.contiguous(), cg.pixel_to_grid(model, warm).contiguous()


def make_calibration_dataset(seed=0, n_imagesets=8, k=12, w=320, h=240,
                             cell=0.03):
    """A single-camera feature dataset: a w×h pinhole camera (f = 0.9·w,
    principal point at the center) and ``n_imagesets`` views of a k×k board
    of ``cell``-meter squares, each from a random rotation (0.12 rad per
    axis) about 0.45–0.7 m in front of the board.  The features are the
    exact projections of the corners inside the image.

    Returns (Dataset, camera, ground-truth image_tr_global poses).  The
    numbers are computed in float64 on ``config.host_device()``.
    """
    dev = host_device()
    rng = np.random.default_rng(seed)
    cam = pinhole.make_pinhole(0.9 * w, 0.9 * w, 0.5 * w, 0.5 * h, w, h,
                               device=dev)
    geometry = KnownGeometry(
        cell_length_in_meters=cell,
        feature_id_to_position={
            r * k + c: (c, r) for r in range(k) for c in range(k)},
    )
    pattern_pts = np.array(
        [[c * cell, r * cell, 0.0] for r in range(k) for c in range(k)])
    center_off = (k - 1) * cell / 2

    imagesets = []
    gt_poses = []
    for _ in range(n_imagesets):
        # the camera looks at the pattern from negative z
        q = se3.quat_exp(torch.as_tensor(rng.normal(0, 0.12, 3), device=dev))
        r = se3.quat_to_matrix(q).numpy()
        # image_tr_global: x_cam = R x_g + t, the pattern in front (z > 0)
        t = np.array([
            -center_off + rng.normal(0, 0.05),
            -center_off + rng.normal(0, 0.05),
            rng.uniform(0.45, 0.7),
        ])
        x_cam = pattern_pts @ r.T + t
        px, valid = pinhole.project(cam, torch.as_tensor(x_cam, device=dev))
        px, valid = px.numpy(), valid.numpy()
        feats = [PointFeature(xy=px[j], feature_id=j)
                 for j in range(k * k) if valid[j]]
        imagesets.append(Imageset(features=[feats]))
        gt_poses.append((r, t))
    ds = Dataset(num_cameras=1, image_sizes=[(w, h)], imagesets=imagesets,
                 known_geometries=[geometry])
    return ds, cam, gt_poses


def noncentral_calibration_model(w=320, h=240, gres=8, device=None,
                                 dtype=torch.float64):
    """A strongly noncentral w×h camera on a (gres, gres) grid: nearly
    parallel rays (directions (0.8(u − ½), 0.8(v − ½), 1) over the image's
    normalized coordinates u, v) and line origins (0.15(v − ½),
    −0.12(u − ½), 0) m, a cross-slit field whose lines meet in no single
    point."""
    yy, xx = np.meshgrid(np.arange(gres), np.arange(gres), indexing="ij")
    u = (xx - 1.0) / (gres - 3.0)  # 0..1 across the image
    v = (yy - 1.0) / (gres - 3.0)
    dirs = np.stack([0.8 * (u - 0.5), 0.8 * (v - 0.5), np.ones_like(u)], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.stack([0.15 * (v - 0.5), -0.12 * (u - 0.5),
                        np.zeros_like(u)], -1)
    dev = default_device(device)
    return ncg.NoncentralGenericModel(
        direction_grid=torch.as_tensor(dirs, dtype=dtype, device=dev),
        point_grid=torch.as_tensor(origins, dtype=dtype, device=dev),
        width=w, height=h,
        calibration_min_x=0, calibration_min_y=0,
        calibration_max_x=w - 1, calibration_max_y=h - 1,
    )


def make_noncentral_calibration_dataset(seed=0, n_imagesets=12, w=320,
                                        h=240, nx=13, ny=10, cell=0.03):
    """A single-camera feature dataset of the noncentral camera of
    :func:`noncentral_calibration_model`: ``n_imagesets`` views of a board
    of nx×ny corners ``cell`` m apart, each from a random rotation (0.25
    rad per axis) with the board centered ± N(0, 0.02) m at a depth
    uniform in [0.42, 0.6] m.  The features are the exact projections
    (50 LM iterations) of the corners more than 1 px inside the image.

    The defaults are the reference package's test dataset; one seed draws
    the same poses at any image size and board.  Returns (Dataset, camera,
    ground-truth image_tr_global poses), computed in float64 on
    ``config.host_device()``.
    """
    dev = host_device()
    rng = np.random.default_rng(seed)
    model = noncentral_calibration_model(w, h, device=dev)
    geometry = KnownGeometry(
        cell_length_in_meters=cell,
        feature_id_to_position={
            y * nx + x: (x, y) for y in range(ny) for x in range(nx)},
    )
    pts_pat = np.array(
        [[x * cell, y * cell, 0.0] for y in range(ny) for x in range(nx)])
    off = np.array([(nx - 1) / 2 * cell, (ny - 1) / 2 * cell, 0.0])

    imagesets = []
    poses = []
    for _ in range(n_imagesets):
        a = rng.normal(0, 0.25, 3)
        th = np.linalg.norm(a)
        k = a / max(th, 1e-12)
        kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        r = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
        t = -r @ off + np.array(
            [rng.normal(0, 0.02), rng.normal(0, 0.02),
             rng.uniform(0.42, 0.6)])
        x_cam = torch.as_tensor(pts_pat @ r.T + t, device=dev)
        px, _, valid = ncg.project_points(model, x_cam, max_iterations=50)
        px, valid = px.numpy(), valid.numpy()
        valid = valid & (px[:, 0] > 1) & (px[:, 0] < w - 2) \
            & (px[:, 1] > 1) & (px[:, 1] < h - 2)
        feats = [PointFeature(xy=px[j], feature_id=j)
                 for j in range(len(pts_pat)) if valid[j]]
        imagesets.append(Imageset(features=[feats]))
        poses.append((r, t))
    ds = Dataset(num_cameras=1, image_sizes=[(w, h)], imagesets=imagesets,
                 known_geometries=[geometry])
    return ds, model, poses

"""The synthetic bundle-adjustment problem of the benchmark.

A CentralGeneric mono problem sized like a real calibration run: 256 poses
of a 1024-point board seen by a 640×480 camera with a 16×16 direction grid,
in (poses × points) grid layout (262,144 rows).  The random draws come from
numpy in the same order as the reference package's ``bench.py``, so the
state is the same; the observations come from this package's projection.
"""

from __future__ import annotations

import numpy as np
import torch

from camera_calibration_torch.ba.dataset import ObservationTable
from camera_calibration_torch.ba.state import BAState
from camera_calibration_torch.config import default_device
from camera_calibration_torch.models import central_generic as cg
from camera_calibration_torch.ops import se3


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


def make_bench_problem(w=640, h=480, gres=16, n_points=1024, n_poses=256,
                       seed=0, device=None, dtype=torch.float32):
    """(state, data tuple, meta) of the benchmark problem on ``device``."""
    device = default_device(device)
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

    # Exact observations of every (pose, point) pair, in one batch.
    x_cam = (se3.quat_rotate(rig_q[:, None, :], torch.as_tensor(pts)[None])
             + torch.as_tensor(rig_t)[:, None, :])
    pxs, _, valid = cg.project_points(model, t(x_cam.reshape(-1, 3)),
                                      max_iterations=40)
    inside = (valid & (pxs[:, 0] > 1) & (pxs[:, 0] < w - 1)
              & (pxs[:, 1] > 1) & (pxs[:, 1] < h - 1))
    m, p = n_poses, n_points
    table = ObservationTable(
        imageset=torch.arange(m, device=device).repeat_interleave(p),
        camera=torch.zeros(m * p, dtype=torch.int64, device=device),
        point=torch.arange(p, device=device).repeat(m),
        pixel=torch.where(inside[:, None], pxs, 0.0),
        valid=inside,
        grid_shape=(m, p),
    )
    state = perturb_bench_state(state, seed=seed + 1)
    return state, (table,), {"n_obs": int(inside.sum()), "gres": gres}


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

"""Port parity on two-camera rigs.

Two rigs, in float64 on the CPU, each given to the JAX package (its XLA
path) and to the port with the same state, warm starts, λ and tables:

- ``__graft_entry__._make_problem(n_cameras=2)``: two CentralGeneric
  cameras (a stereo baseline with toe-in), the second camera's
  translation in the rig perturbed by 3 mm;
- a mixed rig: one CentralGeneric camera (the bench's analytic pinhole
  grid at 64×48, 7×7 knots) and one ThinPrismFisheye camera, on
  ``tests/ba_harness``'s pose and point draws, the state perturbed by
  ``ba_harness.perturb_state`` (knots, parameters, poses, points).

Each runs one two-pass LM step in every solver mode: ``accept`` and the CG
iteration counts identical, costs, λ and state to 1e-9 relative.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import ba_harness
from camera_calibration_torch import convert, problems
from camera_calibration_torch.ba import lm_pcg as T
from camera_calibration_tpu.ba import lm_pcg as J
from camera_calibration_tpu.ba.dataset import ObservationTable, to_grid_layout
from camera_calibration_tpu.ba.state import BAState, transform_to_camera
from camera_calibration_tpu.models import central_generic as jcg
from camera_calibration_tpu.models import protocol as jproto
from torch_threads import one_torch_thread  # noqa: F401

REL = dict(rtol=1e-9, atol=1e-12)
STATE_TOL = dict(rtol=1e-9, atol=1e-10)
SOLVERS = ["schur", "schur_poses", "pcg", "schur_direct",
           "schur_direct_points"]


def _grid_rig():
    state, data = graft._make_problem(dtype=jnp.float64, n_cameras=2)
    rng = np.random.default_rng(8)
    cam_t = np.asarray(state.cam_t_rig).copy()
    cam_t[1] += rng.normal(0, 0.003, 3)
    return dataclasses.replace(state, cam_t_rig=jnp.asarray(cam_t)), data


def _mixed_rig(n_points=64, n_poses=12, w=64, h=48):
    """A CentralGeneric camera 0 and a ThinPrismFisheye camera 1 on the
    harness's draws; exact observations 1 px inside the image, in grid
    layout per camera."""
    gt, _, _ = ba_harness.make_problem(model_kind="tpf", n_points=n_points,
                                       n_poses=n_poses, n_cameras=2, w=w,
                                       h=h)
    grid = problems.pinhole_model(w, h, 7, 7, device="cpu",
                                  dtype=torch.float64).grid
    cam0 = jcg.CentralGenericModel(
        grid=jnp.asarray(grid.numpy()), width=w, height=h,
        calibration_max_x=w - 1, calibration_max_y=h - 1)
    gt = BAState(rig_q_global=gt.rig_q_global, rig_t_global=gt.rig_t_global,
                 cam_q_rig=gt.cam_q_rig, cam_t_rig=gt.cam_t_rig,
                 points=gt.points, intrinsics=(cam0, gt.intrinsics[1]))
    m, p = n_poses, n_points
    ims = jnp.repeat(jnp.arange(m, dtype=jnp.int32), p)
    pts = jnp.tile(jnp.arange(p, dtype=jnp.int32), m)
    data = []
    for ci, model in enumerate(gt.intrinsics):
        cams = jnp.full(m * p, ci, jnp.int32)
        x_cam, _ = transform_to_camera(gt, ims, cams, gt.points[pts])
        px, _, valid = jproto.project_points(model, x_cam, max_iterations=80)
        px = np.asarray(px)
        inside = np.asarray(valid) & (px[:, 0] > 1) & (px[:, 0] < w - 1) \
            & (px[:, 1] > 1) & (px[:, 1] < h - 1)
        data.append(to_grid_layout(ObservationTable(
            imageset=ims, camera=cams, point=pts,
            pixel=jnp.asarray(np.where(inside[:, None], px, 0.0)),
            valid=jnp.asarray(inside)), m, p))
    return ba_harness.perturb_state(gt, seed=1), tuple(data)


@pytest.fixture(scope="module", params=["grid_rig", "mixed_rig"])
def rig(request):
    state, data = _grid_rig() if request.param == "grid_rig" else _mixed_rig()
    for seg in data:
        assert int(np.asarray(seg.valid).sum()) > 0.5 * seg.imageset.shape[0]
    ts = convert.ba_state(state, device="cpu")
    td = tuple(convert.observation_table(s, device="cpu") for s in data)
    return state, data, ts, td


def _close(got, ref, tol=REL, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **tol,
                               err_msg=err_msg)


@pytest.mark.parametrize("solver", SOLVERS)
def test_rig_step_matches_reference(rig, solver):
    state, data, ts, td = rig
    kw = dict(max_pcg_iterations=20, proj_iterations=8, solver=solver)
    ref = J.make_lm_step(J.BAOptions(**kw))(
        state, tuple(s.pixel for s in data), jnp.asarray(-1.0), data)
    got = T.make_lm_step(T.BAOptions(**kw))(
        ts, tuple(s.pixel for s in td), torch.tensor(-1.0,
                                                     dtype=torch.float64), td)
    assert got[3] == bool(ref[3]) and got[3]
    assert got[6] == int(ref[6])
    for i in (2, 4, 5, 7, 8):
        _close(float(got[i]), float(ref[i]))
    for name in ("rig_q_global", "rig_t_global", "cam_q_rig", "cam_t_rig",
                 "points"):
        _close(getattr(got[0], name), getattr(ref[0], name), STATE_TOL, name)
    for tm, jm in zip(got[0].intrinsics, ref[0].intrinsics):
        _close(tm.params if hasattr(jm, "params") else tm.grid,
               jm.params if hasattr(jm, "params") else jm.grid, STATE_TOL)
    # the second camera's extrinsics move; the first's are the gauge
    assert torch.equal(got[0].cam_t_rig[0], ts.cam_t_rig[0])
    assert not torch.equal(got[0].cam_t_rig[1], ts.cam_t_rig[1])

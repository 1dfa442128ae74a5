"""Port parity: relative pose, P3P, densification, dense initialization, the
dense fit and the initial BA state.

The reference package (its XLA path on the CPU) and the port on the CPU get
the same inputs in float64:

- the five relative-pose solvers on the problems of
  ``tests/test_relative_pose.py``: poses and optical centers to 1e-9;
- ``p3p_grunert`` and ``ransac_p3p`` (the same seed, so the same minimal
  sets): every candidate pose to 1e-9, the same inlier mask;
- the native densification against its NumPy version and the reference
  package's (the same valid pixels, points to 1e-9 m);
- ``DenseInitializer.run`` on the dataset of ``tests/test_e2e.py`` (shared
  with ``tests/test_torch_calibrate.py`` through ``torch_e2e_init``): the
  same localized imagesets and direction counts, poses to 1e-8 and
  direction sums to 1e-9;
- ``fit_central_generic_to_dense`` and ``build_ba_state``
  (ThinPrismFisheye; the CentralGeneric state is held in the pipeline test
  of ``tests/test_torch_calibrate.py``) from the same dense-initialization
  result: poses, points and the parametric model to 1e-9 relative, the
  observation tables identical.  The grid fit is compared after one LM
  iteration, to twice the spread of the reference's own knots when its
  input directions change by ±1e-14 relative: the capped-CG LM on a grid
  with weakly supported border knots is so ill-conditioned that this
  spread is about 9e-9 after one iteration (and 1e-4 after the full fit),
  and the test asserts that it is over 1e-9;
- ``fit_noncentral_to_lines`` after one LM iteration of each of its fits
  to 1e-7, and the native ``pattern_intensity`` exactly.

The module runs with one intra-op thread (``tests/torch_threads.py``).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from camera_calibration_torch import native, problems
from camera_calibration_torch.ba import dataset as tds
from camera_calibration_torch.init import dense_init as tdi
from camera_calibration_torch.init import p3p as tp3
from camera_calibration_torch.init import relative_pose as trp
from camera_calibration_torch.init import state_init as tsi
from camera_calibration_torch.models import fit as tfit
from camera_calibration_tpu.init import dense_init as jdi
from camera_calibration_tpu.init import p3p as jp3
from camera_calibration_tpu.init import relative_pose as jrp
from camera_calibration_tpu.init import state_init as jsi
from camera_calibration_tpu.models import fit as jfit
import test_dense_init as ref_tdi
import test_relative_pose as ref_trp
import torch_e2e_init
from torch_threads import one_torch_thread  # noqa: F401

POSE = dict(rtol=0, atol=1e-9)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol=POSE, err_msg=""):
    np.testing.assert_allclose(_np(got), _np(ref), **tol, err_msg=err_msg)


@functools.cache
def _ref_jit(name):
    """A reference solver jitted: one compile per shape instead of an
    eager dispatch per small op."""
    return jax.jit(getattr(jrp, name))


# ------------------------------------------------------------ relative pose

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_central_planar_relative_pose(seed):
    _, _, clouds = ref_trp._random_problem(seed)
    got = trp.central_planar_relative_pose(torch.as_tensor(clouds))
    ref = _ref_jit("central_planar_relative_pose")(clouds)
    assert bool(got["ok"]) and bool(ref["ok"])
    for key in ("r0", "t0", "r1", "t1", "optical_center"):
        _close(got[key], ref[key], err_msg=key)


def test_central_planar_relative_pose_masked_rows():
    o_gt, _, clouds = ref_trp._random_problem(7, n=30)
    clouds = np.concatenate([clouds, np.ones((3, 6, 2)) * 99.0], axis=1)
    w = np.concatenate([np.ones(30), np.zeros(6)])
    got = trp.central_planar_relative_pose(torch.as_tensor(clouds),
                                           torch.as_tensor(w))
    ref = _ref_jit("central_planar_relative_pose")(clouds, w)
    assert bool(got["ok"])
    for key in ("r0", "t0", "r1", "t1", "optical_center"):
        _close(got[key], ref[key], err_msg=key)
    _close(got["optical_center"], o_gt, dict(rtol=0, atol=1e-6))


def _central_3d_problem(seed):
    rng = np.random.default_rng(100 + seed)
    o = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3),
                  rng.uniform(-1.6, -0.9)])
    r_gt = jrp_rotation(rng.normal(0, 0.2, 3))
    t_gt = rng.normal(0, 0.2, 3)
    clouds = np.zeros((2, 40, 3))
    for i in range(40):
        d = rng.normal(0, 1, 3)
        d /= np.linalg.norm(d)
        if d[2] < 0:
            d = -d
        clouds[1, i] = o + rng.uniform(0.8, 2.0) * d
        clouds[0, i] = r_gt.T @ (o + rng.uniform(0.8, 2.0) * d - t_gt)
    return clouds, r_gt, t_gt


def jrp_rotation(w):
    """Rotation matrix of the axis-angle vector w (Rodrigues)."""
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_central_3d_relative_pose(seed):
    clouds, r_gt, t_gt = _central_3d_problem(seed)
    got = trp.central_3d_relative_pose(torch.as_tensor(clouds))
    ref = _ref_jit("central_3d_relative_pose")(clouds)
    assert bool(got["ok"]) and bool(ref["ok"])
    for key in ("r", "t", "optical_center"):
        _close(got[key], ref[key], err_msg=key)
    _close(got["r"], r_gt, dict(rtol=0, atol=1e-6))


def _noncentral_clouds(seed, n, planar, noise=0.0):
    rng = np.random.default_rng(seed)
    o, d = ref_trp._noncentral_lines(rng, n)
    rs = [ref_trp._rand_rot_np(rng) for _ in range(3)]
    ts = [rng.uniform(-0.3, 0.3, 3) + np.array([0, 0, 1.5]) for _ in range(3)]
    clouds = []
    for k in range(3):
        if planar:
            nrm = rs[k][:, 2]
            s = (nrm @ ts[k] - o @ nrm) / (d @ nrm)
            p = ((o + s[:, None] * d) - ts[k]) @ rs[k]
            clouds.append(p[:, :2] + rng.normal(0, noise, (n, 2))
                          if noise else p[:, :2])
        else:
            s = rng.uniform(1.0, 2.0, n)
            clouds.append((o + s[:, None] * d - ts[k]) @ rs[k])
    return np.stack(clouds)


def test_noncentral_3d_relative_pose():
    clouds = _noncentral_clouds(7, 40, planar=False)
    got = trp.noncentral_3d_relative_pose(clouds)
    ref = jrp.noncentral_3d_relative_pose(clouds)
    assert got["ok"] and ref["ok"]
    for key in ("r0", "t0", "r1", "t1"):
        _close(got[key], ref[key], err_msg=key)


@pytest.mark.parametrize("seed,n,noise", [(8, 60, 0.0), (9, 120, 1e-4)])
def test_noncentral_planar_relative_pose(seed, n, noise):
    clouds = _noncentral_clouds(seed, n, planar=True, noise=noise)
    got = trp.noncentral_planar_relative_pose(clouds)
    ref = jrp.noncentral_planar_relative_pose(clouds)
    assert got["ok"] and ref["ok"]
    for cg_, cr in zip(got["candidates"], ref["candidates"]):
        for key in ("r0", "t0", "r1", "t1"):
            _close(cg_[key], cr[key], err_msg=key)


# ---------------------------------------------------------------------- P3P

def _p3p_problem(seed, n):
    rng = np.random.default_rng(seed)
    r_gt = jrp_rotation(rng.normal(0, 0.4, 3))
    t_gt = rng.normal(0, 1.0, 3)
    x_cam = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                      rng.uniform(2, 5, n)], -1)
    bearings = x_cam / np.linalg.norm(x_cam, axis=-1, keepdims=True)
    return bearings, x_cam @ r_gt.T + t_gt, rng


@pytest.mark.parametrize("seed", range(4))
def test_p3p_grunert(seed):
    bearings, points, _ = _p3p_problem(seed, 3)
    got = tp3.p3p_grunert(bearings, points)
    ref = jp3.p3p_grunert(bearings, points)
    assert got and len(got) == len(ref)
    for (rg, tg), (rr, tr) in zip(got, ref):
        _close(rg, rr)
        _close(tg, tr)


def test_ransac_p3p_same_minimal_sets():
    bearings, points, rng = _p3p_problem(3, 60)
    # 20% outliers, and noisy inliers, so the polish moves the pose
    bearings[:12] = rng.normal(0, 1, (12, 3))
    bearings += rng.normal(0, 1e-4, bearings.shape)
    bearings /= np.linalg.norm(bearings, axis=-1, keepdims=True)
    got = tp3.ransac_p3p(bearings, points, max_iterations=20, seed=1)
    ref = jp3.ransac_p3p(bearings, points, max_iterations=20, seed=1)
    np.testing.assert_array_equal(got[2], ref[2])
    assert got[2].sum() >= 46
    _close(got[0], ref[0])
    _close(got[1], ref[1])


# ------------------------------------------------------------- densification

@pytest.fixture(scope="module")
def ref_dataset():
    """The reference package's synthetic dataset (seed 0)."""
    return ref_tdi._make_synthetic_dataset(seed=0)


@pytest.fixture(scope="module")
def port_dataset():
    return problems.make_calibration_dataset(seed=0)


def test_make_calibration_dataset_matches_the_reference(ref_dataset,
                                                        port_dataset):
    (ref, _, ref_gt), (got, _, gt) = ref_dataset, port_dataset
    for a, b in zip(got.imagesets, ref.imagesets):
        assert [f.feature_id for f in a.features[0]] == [
            f.feature_id for f in b.features[0]]
        np.testing.assert_allclose(
            np.stack([f.xy for f in a.features[0]]),
            np.stack([np.asarray(f.xy) for f in b.features[0]]),
            rtol=0, atol=1e-12)
    for (r, t), (rr, tr) in zip(gt, ref_gt):
        _close(r, rr, dict(rtol=0, atol=1e-15))
        _close(t, tr, dict(rtol=0, atol=0))


@pytest.mark.parametrize("pose", ["identity", "moved"])
def test_native_densify_matches_numpy(port_dataset, pose):
    ds = port_dataset[0]
    feats = ds.imagesets[3].features[0]
    geoms = ds.known_geometries
    rot = jrp_rotation(np.array([0.1, -0.2, 0.05]))
    poses = [(np.eye(3), np.zeros(3)) if pose == "identity"
             else (rot, np.array([0.1, 0.2, -0.3]))]
    native.reset_calls()
    pts, valid = tdi.densify_matches(feats, geoms, poses, (320, 240),
                                     (320, 240))
    assert native.calls["densify_matches"] == 1
    pts_p, valid_p = tdi.densify_matches_plain(feats, geoms, poses,
                                               (320, 240), (320, 240))
    # the two interior tests agree except where a buffer pixel center lies
    # on a square edge to rounding; such pixels are written by the square
    # on either side
    assert (valid != valid_p).sum() <= 2, (valid != valid_p).sum()
    assert valid.sum() > 0.3 * valid.size
    both = valid & valid_p
    np.testing.assert_allclose(pts[both], pts_p[both], rtol=0, atol=1e-9)
    ref_pts, ref_valid = jdi.densify_matches(
        _ref_features(feats), geoms, poses, (320, 240), (320, 240))
    np.testing.assert_array_equal(valid, ref_valid)
    np.testing.assert_allclose(pts[valid], ref_pts[ref_valid], rtol=0,
                               atol=1e-12)


def _ref_features(feats):
    from camera_calibration_tpu.ba.dataset import PointFeature
    return [PointFeature(xy=np.asarray(f.xy), feature_id=f.feature_id)
            for f in feats]


# ------------------------------------------------------ dense initialization

@pytest.fixture(scope="module")
def dense_results():
    """The port's and the reference's dense initialization of the e2e
    dataset (320×240 buffer)."""
    return torch_e2e_init.port()[1], torch_e2e_init.reference()[1]


def test_dense_initializer_matches_the_reference(dense_results):
    got, ref = dense_results
    assert got is not None and ref is not None
    assert got.image_used == ref.image_used
    assert sum(got.image_used) >= 6
    assert got.buffer_size == ref.buffer_size
    np.testing.assert_array_equal(got.direction_count, ref.direction_count)
    _close(got.direction_sum, ref.direction_sum, dict(rtol=0, atol=1e-9))
    for pg, pr in zip(got.image_tr_global, ref.image_tr_global):
        assert (pg is None) == (pr is None)
        if pg is not None:
            _close(pg[0], pr[0], dict(rtol=0, atol=1e-8))
            _close(pg[1], pr[1], dict(rtol=0, atol=1e-8))


def test_dense_init_save_load_round_trip(dense_results, tmp_path):
    got, _ = dense_results
    tdi.save_dense_init(tmp_path / "init", [got, None])
    back = tdi.load_dense_init(tmp_path / "init")
    assert back[1] is None
    b = back[0]
    np.testing.assert_array_equal(b.direction_sum, got.direction_sum)
    np.testing.assert_array_equal(b.direction_count, got.direction_count)
    assert list(b.image_used) == list(got.image_used)
    assert b.buffer_size == got.buffer_size
    ref = jdi.load_dense_init(tmp_path / "init")[0]
    for pb, pr in zip(b.image_tr_global, ref.image_tr_global):
        np.testing.assert_array_equal(pb[0], pr[0])


def _port_result(ref):
    """The reference package's DenseInitResult as the port's."""
    return tdi.DenseInitResult(
        direction_sum=ref.direction_sum, direction_count=ref.direction_count,
        image_used=list(ref.image_used),
        image_tr_global=list(ref.image_tr_global),
        global_tr_known_geometry=list(ref.global_tr_known_geometry),
        buffer_size=ref.buffer_size, image_size=ref.image_size)


def test_fit_central_generic_to_dense(dense_results):
    """One LM iteration, held to twice the spread of the reference's own
    knots under a ±1e-14 relative change of the input directions (the
    full fit is held by the pipeline test of
    ``tests/test_torch_calibrate.py``)."""
    _, ref = dense_results
    dirs, valid = ref.observation_directions()
    kw = dict(width=320, height=240, max_iterations=1)
    got = tfit.fit_central_generic_to_dense(dirs, valid, (5, 7), **kw)
    exp = jfit.fit_central_generic_to_dense(dirs, valid, (5, 7), **kw)
    assert got.grid.device.type == "cpu"
    for name in ("width", "height", "calibration_max_x", "calibration_max_y"):
        assert getattr(got, name) == getattr(exp, name)
    spread = max(np.abs(_np(jfit.fit_central_generic_to_dense(
        dirs * (1.0 + eps), valid, (5, 7), **kw).grid) - _np(exp.grid)).max()
        for eps in (1e-14, -1e-14))
    assert spread > 1e-9, spread
    gap = np.abs(_np(got.grid) - _np(exp.grid)).max()
    assert gap <= 2.0 * spread, (gap, spread)


@pytest.mark.parametrize("kind", ["central_thin_prism_fisheye"])
def test_build_ba_state_matches_the_reference(dense_results, kind):
    """A parametric kind; the CentralGeneric state is held in
    ``tests/test_torch_calibrate.py``'s pipeline run."""
    _, ref = dense_results
    got = tsi.build_ba_state(torch_e2e_init.port()[0], [_port_result(ref)],
                             (6, 8), model_kind=kind, device="cpu")
    exp = jsi.build_ba_state(torch_e2e_init.reference()[0], [ref], (6, 8),
                             model_kind=kind)
    (state, data, fid, used), (jstate, jdata, jfid, jused) = got, exp
    assert fid == jfid and used == jused
    for name in ("rig_q_global", "rig_t_global", "cam_q_rig", "cam_t_rig",
                 "points"):
        a, b = getattr(state, name), np.asarray(getattr(jstate, name))
        _close(a, b, dict(rtol=0, atol=1e-9 * max(1.0, np.abs(b).max())),
               err_msg=name)
    tm, jm = state.intrinsics[0], jstate.intrinsics[0]
    assert type(tm).__name__ == type(jm).__name__
    assert (tm.width, tm.height) == (jm.width, jm.height)
    # parameters from ~300 (focal lengths) to ~1e-4: 1e-9 of max(|p|, 1)
    _close(tm.params, jm.params, dict(rtol=1e-9, atol=1e-9))
    for name in ("imageset", "camera", "point", "pixel", "valid"):
        np.testing.assert_array_equal(_np(getattr(data[0], name)),
                                      np.asarray(getattr(jdata[0], name)))
    assert isinstance(data[0], tds.ObservationTable)
    # the kernels take row-major tensors
    assert all(t.is_contiguous() for t in (
        state.rig_q_global, state.points, tm.params))


def test_fit_noncentral_to_lines():
    """One LM iteration of each of the two grid fits (directions from the
    ring seed, then line origins), on the line field of a pinhole camera
    with a smooth origin offset."""
    from camera_calibration_tpu.models import pinhole as jph

    dirs = np.asarray(jph.direction_image(jph.make_pinhole(70, 70, 40, 30,
                                                           80, 60)))
    yy, xx = np.meshgrid(np.linspace(-1, 1, 60), np.linspace(-1, 1, 80),
                         indexing="ij")
    anchors = np.stack([0.01 * xx, -0.02 * yy, 0.005 * xx * yy], -1)
    valid = np.ones((60, 80), bool)
    valid[:8, :10] = False
    kw = dict(width=160, height=120, max_iterations=1)
    got = tfit.fit_noncentral_to_lines(dirs, anchors, valid, (5, 6), **kw)
    exp = jfit.fit_noncentral_to_lines(dirs, anchors, valid, (5, 6), **kw)
    _close(got.direction_grid, exp.direction_grid, dict(rtol=0, atol=1e-7))
    _close(got.point_grid, exp.point_grid, dict(rtol=0, atol=1e-7))
    assert (got.width, got.height, got.calibration_max_x) == (160, 120, 159)


def test_pattern_intensity_native_matches_the_reference():
    from camera_calibration_tpu import native as jnative

    pos = np.random.default_rng(2).uniform(-3, 3, (50, 7, 2))
    pos[0, 0] = (1.0, -2.0)  # a center
    got = native.pattern_intensity_native(pos, 16)
    assert got.shape == (50, 7) and got[0, 0] == 0.5
    np.testing.assert_array_equal(got, jnative.pattern_intensity_native(pos,
                                                                         16))

"""Port parity: the calibration report and the fitting report.

Both packages' ``create_calibration_report`` run on the same small states
(float64, the port on the CPU): the CentralGeneric problem of
``tests/ba_harness.py`` (64×48, 7×7 grid, 6 poses of 40 points, 0.05 px
pixel noise) and the NoncentralGeneric state of
``tests/test_calibrate.py::test_calibration_report_noncentral_extras``
(its directions with random origins).  Held:

- the returned metrics to 1e-9 relative (the bias score exactly);
- ``_info.txt`` line for line, numbers to 1e-9 relative;
- ``_lines.obj``: the same lines, vertices to 1e-8;
- the port's raster arrays (``error_histogram``, ``cell_mean_magnitudes``,
  ``voronoi_rgb``, ``knot_pixels``, ``line_offsets``, ``direction_rgb``)
  against the same arrays built from the reference's ``_error_data``
  output and models as the reference builds them (histogram counts
  identical, the rest to 1e-9), and the port's HSV conversion against
  matplotlib's;
- every image the reference writes is written and readable by OpenCV.

``fit-parametric`` (``fit_and_report``) runs from both command lines on a
saved state holding the 128×96 pinhole-like grid model of
``tests/test_parametric.py::test_fit_and_report``, fitting OpenCV: the
printed and written metrics within 1e-3 px (observed 4.5e-5 px: the
60-iteration OpenCV fit amplifies last-bit differences, as
``tests/test_torch_parametric.py`` found), both under that test's 0.05 px.

The module runs with one intra-op thread (``tests/torch_threads.py``).
"""

import os

import cv2
import jax.numpy as jnp
import matplotlib.colors
import numpy as np
import pytest
import torch

import ba_harness
from camera_calibration_torch import convert
from camera_calibration_torch import cli as tcli
from camera_calibration_torch.report import calibration_report as trep
from camera_calibration_torch.report import raster
from camera_calibration_tpu import cli as jcli
from camera_calibration_tpu.ba.dataset import split_by_camera
from camera_calibration_tpu.models import central_generic as jcg
from camera_calibration_tpu.models import noncentral_generic as jncg
from camera_calibration_tpu.models import protocol as jprotocol
from camera_calibration_tpu.report import calibration_report as jrep
from test_torch_cli import NUMBER, _assert_same_text
from torch_threads import one_torch_thread  # noqa: F401

PNGS = ("_errors_histogram", "_error_magnitudes", "_error_directions",
        "_grid_point_locations", "_observation_directions")


def _noncentral(state):
    central = state.intrinsics[0]
    model = jncg.NoncentralGenericModel(
        direction_grid=central.grid,
        point_grid=jnp.asarray(0.01 * np.random.default_rng(0).normal(
            0, 1, central.grid.shape)),
        width=central.width, height=central.height,
        calibration_min_x=central.calibration_min_x,
        calibration_min_y=central.calibration_min_y,
        calibration_max_x=central.calibration_max_x,
        calibration_max_y=central.calibration_max_y)
    return type(state)(**{**state.__dict__, "intrinsics": (model,)})


@pytest.fixture(scope="module", params=["central", "noncentral"])
def reports(request, tmp_path_factory):
    """Both packages' reports of one state: (kind, reference state and
    tables, port state and tables, reference metrics, port metrics,
    reference directory, port directory)."""
    state, obs, segments = ba_harness.make_problem(
        seed=6, n_points=40, n_poses=6, noise_px=0.05)
    if request.param == "noncentral":
        state = _noncentral(state)
    data = split_by_camera(obs, segments)
    tstate = convert.ba_state(state, device="cpu")
    tdata = tuple(convert.observation_table(t, device="cpu") for t in data)
    root = tmp_path_factory.mktemp(f"report_{request.param}")
    mj = jrep.create_calibration_report(str(root / "ref"), state, data,
                                        num_total_imagesets=7)
    mt = trep.create_calibration_report(str(root / "port"), tstate, tdata,
                                        num_total_imagesets=7)
    return (request.param, (state, data), (tstate, tdata), mj, mt,
            root / "ref", root / "port")


def test_metrics_and_info_match_reference(reports):
    _, _, _, mj, mt, ref, port = reports
    assert len(mj) == len(mt) == 1
    for key, val in mj[0].items():
        if isinstance(val, str):
            assert mt[0][key] == val
        else:
            assert mt[0][key] == pytest.approx(val, rel=1e-9, abs=1e-15), key
    info_r = (ref / "report_camera0_info.txt").read_text()
    info_p = (port / "report_camera0_info.txt").read_text()
    _assert_same_text(info_r, info_p, 1e-9)
    assert len(NUMBER.findall(info_p)) == 11


def test_images_written(reports):
    kind, _, _, _, _, ref, port = reports
    names = PNGS + (("_line_offsets",) if kind == "noncentral" else ())
    for suffix in names:
        assert (ref / f"report_camera0{suffix}.png").exists(), suffix
        img = cv2.imread(str(port / f"report_camera0{suffix}.png"))
        assert img is not None and img.shape[1] >= raster.MIN_WIDTH, suffix
    assert (port / "report_camera0_lines.obj").exists() == (
        kind == "noncentral")


def test_raster_arrays_match_reference(reports):
    """The arrays each image shows, built by the port from the reference's
    error data, against the port's own data and the reference's way."""
    _, (state, data), (tstate, tdata), _, _, _, _ = reports
    err_j, pix_j, ims_j = jrep._error_data(state, data, 0)
    err_t, pix_t, ims_t = trep._error_data(tstate, tdata, 0)
    err_j, pix_j = np.asarray(err_j), np.asarray(pix_j)
    assert np.array_equal(np.asarray(ims_j), ims_t)
    np.testing.assert_allclose(err_t, err_j, rtol=0, atol=1e-12)
    model = tstate.intrinsics[0]
    w, h = model.width, model.height
    assert np.array_equal(trep.error_histogram(err_t, 0.2),
                          trep.error_histogram(err_j, 0.2))
    np.testing.assert_allclose(trep.cell_mean_magnitudes(err_t, pix_t, w, h),
                               trep.cell_mean_magnitudes(err_j, pix_j, w, h),
                               rtol=1e-9, atol=1e-15)
    rgb_t = trep.voronoi_rgb(err_t, pix_t, w, h, 1.0)
    rgb_j = trep.voronoi_rgb(err_j, pix_j, w, h, 1.0)
    np.testing.assert_allclose(rgb_t, rgb_j, rtol=0, atol=1e-9)
    # the reference's own construction of the Voronoi colours
    from scipy.spatial import cKDTree
    vw, vh = min(w, 640), max(1, int(round(min(w, 640) * h / w)))
    gx, gy = np.meshgrid((np.arange(vw) + 0.5) * w / vw,
                         (np.arange(vh) + 0.5) * h / vh)
    _, idx = cKDTree(pix_j).query(np.stack([gx.ravel(), gy.ravel()], -1))
    hue = ((np.arctan2(err_j[idx, 1], err_j[idx, 0]) + np.pi)
           / (2 * np.pi)).reshape(vh, vw)
    val = np.clip(np.linalg.norm(err_j, axis=-1)[idx], 0.15, 1).reshape(vh, vw)
    hsv = np.stack([hue, np.ones_like(hue), val], -1)
    np.testing.assert_allclose(rgb_j, matplotlib.colors.hsv_to_rgb(hsv),
                               rtol=0, atol=1e-12)

    jmodel = state.intrinsics[0]
    probe = jmodel if hasattr(jmodel, "grid") else jcg.CentralGenericModel(
        grid=jmodel.direction_grid, width=w, height=h,
        calibration_min_x=0, calibration_min_y=0,
        calibration_max_x=w - 1, calibration_max_y=h - 1)
    np.testing.assert_allclose(
        trep.knot_pixels(model),
        np.asarray(jcg.grid_point_pixels(probe)).reshape(-1, 2),
        rtol=0, atol=1e-9)
    ys, xs = np.linspace(1, h - 2, 120), np.linspace(1, w - 2, 160)
    px = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    dirs, valid = jprotocol.unproject(jmodel, jnp.asarray(px))
    ref_rgb = 0.5 * (np.asarray(dirs).reshape(120, 160, 3) + 1.0)
    ref_rgb[~np.asarray(valid).reshape(120, 160)] = 0.0
    np.testing.assert_allclose(trep.direction_rgb(model),
                               np.clip(ref_rgb, 0, 1), rtol=0, atol=1e-9)


@pytest.mark.parametrize("reports", ["noncentral"], indirect=True)
def test_line_offsets_and_obj_match_reference(reports):
    _, (state, _), _, _, _, ref, port = reports
    tmodel = convert.camera_model(state.intrinsics[0], device="cpu")
    off, center, d_n, o_n = trep.line_offsets(tmodel)
    jmodel = state.intrinsics[0]
    w, h = jmodel.width, jmodel.height
    px = np.stack(np.meshgrid(np.linspace(1, w - 2, 80),
                              np.linspace(1, h - 2, 60)), -1).reshape(-1, 2)
    dj, oj, _ = jncg.unproject(jmodel, jnp.asarray(px))
    np.testing.assert_allclose(d_n, np.asarray(dj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(o_n, np.asarray(oj), rtol=0, atol=1e-9)
    assert off.shape == (60, 80) and np.isfinite(off).all()
    obj_r = (ref / "report_camera0_lines.obj").read_text().splitlines()
    obj_p = (port / "report_camera0_lines.obj").read_text().splitlines()
    assert len(obj_r) == len(obj_p)
    vr = np.array([[float(v) for v in ln.split()[1:]] for ln in obj_r
                   if ln.startswith("v ")])
    vp = np.array([[float(v) for v in ln.split()[1:]] for ln in obj_p
                   if ln.startswith("v ")])
    np.testing.assert_allclose(vp, vr, rtol=0, atol=1e-8)
    assert [ln for ln in obj_r if not ln.startswith("v ")] \
        == [ln for ln in obj_p if not ln.startswith("v ")]


def test_hsv_to_rgb_matches_matplotlib():
    rng = np.random.default_rng(3)
    hsv = rng.uniform(0, 1, (50, 40, 3))
    hsv[::7, :, 1] = 0.0
    hsv[:, ::5, 0] = np.linspace(0, 1, 50)[:, None]
    np.testing.assert_allclose(raster.hsv_to_rgb(hsv),
                               matplotlib.colors.hsv_to_rgb(hsv), rtol=0,
                               atol=1e-15)


def test_fit_parametric_matches_reference(tmp_path, capsys):
    """``fit-parametric --models central_opencv`` from both command lines
    on a saved state holding the 128×96 grid model."""
    from camera_calibration_torch.ba.state import BAState
    from camera_calibration_torch.io import state_io
    from camera_calibration_torch.models import central_generic as tcg

    w, h, gres = 128, 96, 7
    f = 0.9 * w
    yy, xx = np.meshgrid(np.arange(gres), np.arange(gres), indexing="ij")
    px_g = (xx - 1.0) / (gres - 3.0) * w
    py_g = (yy - 1.0) / (gres - 3.0) * h
    dirs = np.stack([(px_g - w / 2) / f, (py_g - h / 2) / f,
                     np.ones_like(px_g)], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    model = tcg.CentralGenericModel(
        grid=torch.as_tensor(dirs), width=w, height=h, calibration_min_x=0,
        calibration_min_y=0, calibration_max_x=w - 1,
        calibration_max_y=h - 1)
    one = torch.tensor([[1.0, 0, 0, 0]], dtype=torch.float64)
    zero = torch.zeros((1, 3), dtype=torch.float64)
    state = BAState(rig_q_global=one, rig_t_global=zero, cam_q_rig=one,
                    cam_t_rig=zero, points=zero, intrinsics=(model,))
    state_io.save_ba_state(tmp_path / "state", state, [True], {0: 0})
    argv = ["fit-parametric", "--state_directory", str(tmp_path / "state"),
            "--models", "central_opencv"]
    assert jcli.main(argv + ["--output_directory", str(tmp_path / "r")]) == 0
    ref = capsys.readouterr().out
    assert tcli.main(argv + ["--output_directory", str(tmp_path / "p"),
                             "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    _assert_same_text(ref, got, 1e-3)
    name = "fitting_central_opencv"
    info_r = (tmp_path / "r" / f"{name}_info.txt").read_text()
    info_p = (tmp_path / "p" / f"{name}_info.txt").read_text()
    _assert_same_text(info_r, info_p, 1e-3)
    assert float(NUMBER.findall(info_p)[0]) < 0.05
    assert cv2.imread(str(tmp_path / "p" / f"{name}_residual_field.png")) \
        is not None
    assert os.path.exists(tmp_path / "r" / f"{name}_residual_field.png")

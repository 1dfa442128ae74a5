"""Port parity: the per-stage calibration visualizer and the pipeline's
hooks (``calibrate(..., visualizer=...)``, ``calibrate --live_directory``).

- Each hook's arrays against the same arrays built from the reference
  package's on ``ba_harness.make_problem(seed=5, n_points=24, n_poses=6)``
  (built through ``tests/torch_problems.py``)
  with 0.05 px pixel noise and every seventh observation invalid (float64,
  the port on the CPU): the error pixels and magnitudes (the reference
  visualizer's ``_error_data``), the error vectors of the histogram and
  direction hooks, the 64×64 histogram counts (matplotlib's ``hist2d``,
  identical), the error hue and its RGB (matplotlib's ``hsv_to_rgb``), the
  direction RGB of an initialization and of the model's observation
  directions, and the kept and removed masks: all within 1e-9.
- Every hook writes its PNG, readable by OpenCV.
- ``calibrate`` with a visualizer on the port's small e2e problem (the
  dense initialization shared through ``tests/torch_e2e_init.py``) gives
  the same state, bit for bit, as without one, and writes the five
  pipeline PNGs; ``cli.main calibrate --live_directory`` on that dataset
  (the initialization loaded from a cache) writes the initialization's
  and the pipeline's PNGs, through a float64 polish.

The module runs with one intra-op thread (``tests/torch_threads.py``).
"""

import dataclasses
import os

import cv2
import jax.numpy as jnp
import matplotlib

matplotlib.use("Agg")
import matplotlib.colors  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import torch_e2e_init  # noqa: E402
import torch_problems  # noqa: E402
from camera_calibration_torch import calibrate as tcal  # noqa: E402
from camera_calibration_torch import cli as tcli  # noqa: E402
from camera_calibration_torch import convert  # noqa: E402
from camera_calibration_torch.init.dense_init import save_dense_init  # noqa: E402
from camera_calibration_torch.init.state_init import build_ba_state  # noqa: E402
from camera_calibration_torch.io import dataset_bin  # noqa: E402
from camera_calibration_torch.ui import calibration_visualizer as tvis  # noqa: E402
from camera_calibration_tpu.ba.dataset import split_by_camera  # noqa: E402
from camera_calibration_tpu.ba.state import transform_to_camera  # noqa: E402
from camera_calibration_tpu.models import protocol as jprotocol  # noqa: E402
from camera_calibration_tpu.ui import calibration_visualizer as jvis  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401,E402

HOOKS = ("feature_detection", "initialization", "observation_directions",
         "reprojection_errors", "error_histogram", "error_directions",
         "removed_outliers")
PIPELINE_PNGS = ("reprojection_errors", "removed_outliers", "error_histogram",
                 "error_directions", "observation_directions")


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """(reference state and tables, port state and tables)."""
    state, obs, segments = torch_problems.make_problem(
        seed=5, n_points=24, n_poses=6, noise_px=0.05)
    data = split_by_camera(obs, segments)
    keep = np.arange(data[0].valid.shape[0]) % 7 != 3
    data = (dataclasses.replace(data[0], valid=jnp.asarray(keep)),)
    tstate = convert.ba_state(state, device="cpu")
    tdata = tuple(convert.observation_table(t, device="cpu") for t in data)
    return (state, data), (tstate, tdata)


def _reference_errors(state, data):
    """The reference hooks' error vectors, as they compute them (the
    projection compiled)."""
    seg = data[0]
    x_cam, _ = transform_to_camera(state, seg.imageset, seg.camera,
                                   state.points[seg.point])
    with torch_problems.jitted_projection():
        px, _, pvalid = jprotocol.project_points(
            state.intrinsics[0], x_cam, init_xy=seg.pixel, max_iterations=30)
    e = np.asarray(px - seg.pixel)
    keep = np.asarray(pvalid) & np.asarray(seg.valid)
    keep &= np.all(np.isfinite(e), -1)
    return np.asarray(seg.pixel)[keep], e[keep]


def test_hook_arrays_match_reference(problem, tmp_path):
    (state, data), (tstate, tdata) = problem
    # reprojection-error hook: the reference visualizer's own _error_data
    (pix_j, mag_j), = jvis.CalibrationVisualizer(str(tmp_path))._error_data(
        state, data)
    (pix_t, mag_t), = tvis.error_data(tstate, tdata)
    assert pix_t.shape == pix_j.shape and mag_t.size > 0
    np.testing.assert_allclose(pix_t, pix_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(mag_t, mag_j, rtol=0, atol=1e-9)

    # histogram and direction hooks
    pix_j, e_j = _reference_errors(state, data)
    (pix_t, e_t), = tvis.error_vectors(tstate, tdata)
    np.testing.assert_array_equal(pix_t, pix_j)
    np.testing.assert_allclose(e_t, e_j, rtol=0, atol=1e-9)
    fig, ax = plt.subplots()
    counts_j = ax.hist2d(e_j[:, 0], e_j[:, 1], bins=64,
                         range=[[-0.2, 0.2], [-0.2, 0.2]])[0]
    plt.close(fig)
    counts_t = tvis.error_histogram_counts(e_t, 0.2)
    assert counts_t.shape == (64, 64) and counts_t.sum() > 0.9 * len(e_t)
    assert np.array_equal(counts_t, counts_j)
    hue_j = (np.arctan2(e_j[:, 1], e_j[:, 0]) + np.pi) / (2 * np.pi)
    np.testing.assert_allclose(tvis.error_hue(e_t), hue_j, rtol=0, atol=1e-9)
    rgb_j = matplotlib.colors.hsv_to_rgb(
        np.stack([hue_j, np.ones_like(hue_j), np.ones_like(hue_j)], -1))
    np.testing.assert_allclose(tvis.error_direction_rgb(e_t), rgb_j, rtol=0,
                               atol=1e-9)

    # the initialization's and the model's direction images
    rng = np.random.default_rng(0)
    dirs = rng.normal(0, 1, (8, 10, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    valid = rng.uniform(size=(8, 10)) > 0.3
    want = np.clip(np.where(valid[..., None], 0.5 * (dirs + 1.0), 0.0), 0, 1)
    assert np.array_equal(tvis.direction_rgb(dirs, valid), want)
    model = state.intrinsics[0]
    w, h = model.width, model.height
    xs = np.linspace(0.5, w - 0.5, min(w, 160))
    ys = np.linspace(0.5, h - 0.5, min(h, 120))
    xx, yy = np.meshgrid(xs, ys)
    d, v = jprotocol.unproject(model, np.stack([xx, yy], -1).reshape(-1, 2))
    d = np.asarray(d).reshape(len(ys), len(xs), 3)
    v = np.asarray(v).reshape(len(ys), len(xs))
    want = np.clip(np.where(v[..., None], 0.5 * (d + 1.0), 0.0), 0, 1)
    got = tvis.observation_direction_rgb(tstate.intrinsics[0])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)

    # removed-outliers hook: the kept and removed observations
    pix, kept, removed = tvis.outlier_masks(tdata[0])
    valid = np.asarray(data[0].valid)
    assert np.array_equal(kept, valid) and np.array_equal(removed, ~valid)
    assert removed.sum() > 0
    np.testing.assert_array_equal(pix[kept], np.asarray(data[0].pixel)[valid])


def test_every_hook_writes_its_png(problem, tmp_path):
    _, (tstate, tdata) = problem
    vis = tvis.CalibrationVisualizer(str(tmp_path), min_update_seconds=0.0)
    from camera_calibration_torch.ba.dataset import PointFeature

    image = np.random.default_rng(1).uniform(0, 1, (24, 32))
    vis.update_feature_detection(0, image, [PointFeature(np.array([5.0, 6.0]),
                                                         3)])
    dirs = np.zeros((8, 8, 3))
    dirs[..., 2] = 1.0
    vis.update_initialization(0, dirs, np.ones((8, 8), bool))
    vis.update_observation_directions(0, tstate.intrinsics[0])
    vis.update_reprojection_errors(tstate, tdata, iteration=0)
    vis.update_error_histogram(tstate, tdata)
    vis.update_error_directions(tstate, tdata)
    vis.update_removed_outliers(tstate, tdata, removed_count=3)
    for name in HOOKS:
        img = cv2.imread(str(tmp_path / f"{name}_camera0.png"))
        assert img is not None and img.size > 0, name
    # the throttle: a second update within min_update_seconds is skipped
    slow = tvis.CalibrationVisualizer(str(tmp_path / "slow"),
                                      min_update_seconds=3600.0)
    slow.update_reprojection_errors(tstate, tdata)
    os.remove(tmp_path / "slow" / "reprojection_errors_camera0.png")
    slow.update_reprojection_errors(tstate, tdata)
    assert not (tmp_path / "slow" / "reprojection_errors_camera0.png").exists()


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The port's e2e dataset, its dense initialization and its initial
    state at a 6×6 grid, float64 on the CPU."""
    ds, res = torch_e2e_init.port()
    state, data, fid, used = build_ba_state(ds, [res], (6, 6),
                                            dtype=torch.float64, device="cpu")
    return ds, res, state, data, fid


def _assert_same_bits(a, b):
    """Every tensor of two states (or tables) bit for bit equal."""
    if torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_bits(x, y)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_same_bits(getattr(a, f.name), getattr(b, f.name))
    else:
        assert a == b


def test_calibrate_with_visualizer_changes_nothing(e2e, tmp_path):
    ds, _, state, data, fid = e2e
    options = tcal.CalibrateOptions(
        num_pyramid_levels=1, approx_pixels_per_cell=40,
        outlier_removal_factor=8.0, final_iterations=6)
    kw = dict(known_geometries=ds.known_geometries,
              feature_id_to_point_index=fid, log=lambda *a: None)
    plain = tcal.calibrate(state, data, options, **kw)
    vis = tvis.CalibrationVisualizer(str(tmp_path), min_update_seconds=0.0)
    seen = tcal.calibrate(state, data, options, visualizer=vis, **kw)
    _assert_same_bits(plain[0], seen[0])
    _assert_same_bits(plain[1], seen[1])
    untimed = [{k: v for k, v in (rep["solver"] | rep).items()
                if not k.endswith("seconds") and k != "solver"}
               for rep in (plain[2], seen[2])]
    assert untimed[0] == untimed[1]
    assert plain[2]["reprojection_error_median"] < 0.05
    for name in PIPELINE_PNGS:
        assert cv2.imread(str(tmp_path / f"{name}_camera0.png")) is not None


def test_calibrate_live_directory_command(e2e, tmp_path, capsys):
    ds, res, _, _, _ = e2e
    dataset_bin.save_dataset(str(tmp_path / "dataset.bin"), ds)
    save_dense_init(str(tmp_path / "init.npz"), [res])
    live = tmp_path / "live"
    assert tcli.main([
        "calibrate", "--dataset_files", str(tmp_path / "dataset.bin"),
        "--output_directory", str(tmp_path / "out"), "--live_directory",
        str(live), "--dense_initialization_base_path",
        str(tmp_path / "init.npz"), "--num_pyramid_levels", "1",
        "--approx_pixels_per_cell", "40", "--final_iterations", "6",
        "--polish_iterations", "3", "--device", "cpu"]) == 0
    assert "loaded dense initialization" in capsys.readouterr().out
    for name in ("initialization",) + PIPELINE_PNGS:
        assert cv2.imread(str(live / f"{name}_camera0.png")) is not None, name

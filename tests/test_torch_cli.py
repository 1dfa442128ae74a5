"""Port parity: the calibration commands of the command line.

Both packages' ``cli.main`` run on the same ``dataset.bin`` (the 320×240
dataset of ``tests/test_cli_calibrate.py``: 10 views of a 12×12 board) and
resume from the same saved coarse state (the reference's dense
initialization, ``build_ba_state`` at 6×6), the port with ``--device cpu``:

- ``calibrate --state_directory … --num_pyramid_levels 1
  --final_iterations 5 --dtype float64``: with ``--solver schur_direct``
  the saved states to 1e-8 relative (observed ~1e-13); with ``schur`` the
  same LM and CG counts and the states to 1e-3 (observed 2.5e-4: capped
  PCG on a nearly singular reduced system amplifies the rounding of the
  two packages' summation orders, see the test);
- ``report`` (float64 on the CPU): ``_info.txt`` line for line, numbers to
  1e-9 relative, and the printed metrics;
- ``compare``, ``compare-reconstructions`` and ``localization-accuracy``
  (the same seed): the printed numbers to 1e-6 relative (they print 5–8
  digits);
- ``convert-dataset``: the JSON identical, and the JSON converted back to
  the same ``dataset.bin`` bytes; ``intersect-datasets``: the same kept
  features (the output files identical);
- ``create-legends`` writes its three images; a fresh ``calibrate`` on
  the CPU runs, and with ``--dense_initialization_base_path`` a second run
  loads the cache and saves the same state;
- without ``--device``, ``calibrate`` raises where there is no card.

``calibrate --state_directory … --model central_thin_prism_fisheye``,
the resume into another model kind (``resample_models_if_necessary`` fits
the parametric model to the saved grid, then the BA runs): the same LM
counts and outliers, the saved states within 1e-3 relative (observed
2.5e-4) and the final costs within 1e-2: a 6×6 grid determines the fit's
distortion terms poorly, so the reference's own fit moves by ~1e-5
relative under ±1e-14 changes of its input.  ``calibrate --image_directories`` (detection on rendered views) is left
to ``chip_smoke.py`` [8]–[9a] on the card: rendering and detecting views on
the CPU does not fit this file's time.

The module runs with one intra-op thread (``tests/torch_threads.py``).
"""

import ast
import json
import re

import numpy as np
import pytest
import torch

from camera_calibration_torch import cli as tcli
from camera_calibration_torch.io import state_io as tstate_io
from camera_calibration_tpu import cli as jcli
from camera_calibration_tpu.io import dataset_bin as jdataset_bin
from torch_threads import one_torch_thread  # noqa: F401

NUMBER = re.compile(r"-?\d+\.?\d*(?:[eE][-+]?\d+)?")


def _grid_model(w, h, f, gres=6):
    """A CentralGeneric model on a (gres, gres) grid sampling a pinhole
    camera of focal length f over the w×h image."""
    from camera_calibration_torch.models import central_generic as tcg

    yy, xx = np.meshgrid(np.arange(gres), np.arange(gres), indexing="ij")
    px = (xx - 1.0) / (gres - 3.0) * w
    py = (yy - 1.0) / (gres - 3.0) * h
    dirs = np.stack([(px - w / 2) / f, (py - h / 2) / f,
                     np.ones_like(px, float)], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return tcg.CentralGenericModel(
        grid=torch.as_tensor(dirs), width=w, height=h, calibration_min_x=0,
        calibration_min_y=0, calibration_max_x=w - 1,
        calibration_max_y=h - 1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """dataset.bin and a saved coarse state to resume from: the dataset's
    true poses and board, rotated by 0.01 rad and moved by 5 mm at random,
    and a 6×6 grid of a pinhole camera with a 2% longer focal length."""
    from camera_calibration_torch import problems
    from camera_calibration_torch.ba.state import BAState
    from camera_calibration_torch.init.state_init import (
        feature_id_to_point_index, initial_points)
    from camera_calibration_torch.io import dataset_bin as tdataset_bin
    from camera_calibration_torch.ops import se3

    root = tmp_path_factory.mktemp("torch_cli")
    w, h = 320, 240
    ds, _, poses = problems.make_calibration_dataset(seed=2, n_imagesets=10,
                                                     k=12, w=w, h=h)
    ds_path = root / "dataset.bin"
    tdataset_bin.save_dataset(ds_path, ds)
    rng = np.random.default_rng(7)
    qs = np.stack([se3.matrix_to_quat_np(r) for r, _ in poses])
    dq = se3.quat_exp(torch.as_tensor(rng.normal(0, 0.01, (len(poses), 3))))
    fid = feature_id_to_point_index(ds)
    state = BAState(
        rig_q_global=se3.quat_mul(dq, torch.as_tensor(qs)),
        rig_t_global=torch.as_tensor(np.stack([t for _, t in poses])
                                     + rng.normal(0, 0.005, (len(poses), 3))),
        cam_q_rig=torch.tensor([[1.0, 0, 0, 0]], dtype=torch.float64),
        cam_t_rig=torch.zeros((1, 3), dtype=torch.float64),
        points=torch.as_tensor(initial_points(ds, fid, [None])),
        intrinsics=(_grid_model(w, h, 1.02 * 0.9 * w),),
    )
    state_dir = root / "state0"
    tstate_io.save_ba_state(state_dir, state, [True] * len(poses), fid)
    return root, str(ds_path), str(state_dir)


def _run_both(capsys, argv, port_extra=("--device", "cpu")):
    """(reference output, port output) of one command line."""
    assert jcli.main(list(argv)) == 0
    ref = capsys.readouterr().out
    assert tcli.main(list(argv) + list(port_extra)) == 0
    return ref, capsys.readouterr().out


def _numbers(text):
    return np.array([float(v) for v in NUMBER.findall(text)])


def _assert_same_text(ref, got, rel):
    """The same words, and numbers within ``rel`` relative (of the larger
    magnitude, or absolute below 1)."""
    assert NUMBER.sub("#", ref) == NUMBER.sub("#", got)
    a, b = _numbers(ref), _numbers(got)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=rel, atol=rel)


def _state_arrays(path):
    state, used, fid = tstate_io.load_ba_state(path, device="cpu")
    arrays = [state.rig_q_global, state.rig_t_global, state.cam_q_rig,
              state.cam_t_rig, state.points]
    for m in state.intrinsics:
        arrays += [getattr(m, f) for f in ("grid", "direction_grid",
                                           "point_grid", "params")
                   if hasattr(m, f)]
    return [a.numpy() for a in arrays], used, fid


def _state_gap(path_a, path_b):
    """The largest difference of two saved states' arrays, relative to
    each array's largest magnitude (or absolute below 1)."""
    a, used_a, fid_a = _state_arrays(path_a)
    b, used_b, fid_b = _state_arrays(path_b)
    assert used_a == used_b and fid_a == fid_b
    assert [x.shape for x in a] == [y.shape for y in b]
    return max(float(np.abs(x - y).max() / max(np.abs(x).max(), 1.0))
               for x, y in zip(a, b))


REPORT_LINE = re.compile(r"^\[calibrate\] report: (.*)$", re.M)


def _resume_runs(setup, root, extra):
    """(reference state, port state, reference report, port report) of one
    resumed float64 calibration; the reports are the printed
    ``[calibrate] report`` dicts."""
    import contextlib
    import io

    _, ds_path, state_dir = setup
    argv = ["calibrate", "--dataset_files", ds_path, "--state_directory",
            state_dir, "--num_pyramid_levels", "1", "--final_iterations",
            "5", "--dtype", "float64"] + extra
    reports = []
    for tag, main, more in (("ref", jcli.main, []),
                            ("port", tcli.main, ["--device", "cpu"])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(argv + ["--output_directory", str(root / tag)]
                        + more) == 0
        reports.append(ast.literal_eval(
            REPORT_LINE.search(out.getvalue()).group(1)))
    return (str(root / "ref" / "state"), str(root / "port" / "state"),
            *reports)


@pytest.fixture(scope="module")
def calibrated(setup, tmp_path_factory):
    """Both packages' resumed float64 calibrations, per solver."""
    return {solver: _resume_runs(setup,
                                 tmp_path_factory.mktemp(f"cal_{solver}"),
                                 ["--solver", solver])
            for solver in ("schur", "schur_direct")}


def _assert_same_run(ref_rep, port_rep, cost_rel):
    """The same LM and CG counts and outliers; final costs within
    ``cost_rel`` relative and medians within ``cost_rel`` px."""
    for key in ("iterations", "accepted", "rejected", "pcg_iterations_total"):
        assert ref_rep["solver"][key] == port_rep["solver"][key], key
    assert ref_rep["outliers_removed"] == port_rep["outliers_removed"]
    assert abs(port_rep["final_cost"] - ref_rep["final_cost"]) \
        <= cost_rel * ref_rep["final_cost"]
    assert abs(port_rep["reprojection_error_median"]
               - ref_rep["reprojection_error_median"]) <= cost_rel


@pytest.mark.parametrize("solver", ["schur", "schur_direct"])
def test_calibrate_resume_matches_reference(calibrated, solver):
    """schur_direct (an exact Newton step per LM iteration): the states to
    1e-8.  schur: PCG, capped at 50 iterations, on the reduced system of a
    6×6 grid, which is nearly singular along the grid's gauge directions;
    the two packages' CG iterates agree to 1e-13 for 20 iterations, then
    the rounding of their different summation orders grows by ~10⁸ per 10
    iterations (measured on one step from the same inputs), so the states
    are held to 1e-3 (observed 2.5e-4) with the same LM and CG counts."""
    ref, port, ref_rep, port_rep = calibrated[solver]
    if solver == "schur_direct":
        assert _state_gap(ref, port) <= 1e-8
        _assert_same_run(ref_rep, port_rep, 1e-9)
    else:
        assert _state_gap(ref, port) <= 1e-3
        _assert_same_run(ref_rep, port_rep, 1e-3)


def test_report_matches_reference(setup, calibrated, tmp_path, capsys):
    _, ds_path, _ = setup
    state = calibrated["schur"][0]
    argv = ["report", "--state_directory", state, "--dataset_files",
            ds_path]
    assert jcli.main(argv + ["--output_directory", str(tmp_path / "r")]) == 0
    ref = capsys.readouterr().out
    assert tcli.main(argv + ["--output_directory", str(tmp_path / "p"),
                             "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    _assert_same_text(ref, got, 1e-9)
    info_r = (tmp_path / "r" / "report_camera0_info.txt").read_text()
    info_p = (tmp_path / "p" / "report_camera0_info.txt").read_text()
    _assert_same_text(info_r, info_p, 1e-9)
    assert info_r.splitlines()[0] == info_p.splitlines()[0]


def test_compare_commands_match_reference(setup, calibrated, capsys):
    _, _, state_dir = setup
    state = calibrated["schur"][0]
    for cmd in ("compare", "compare-reconstructions"):
        ref, got = _run_both(capsys, [cmd, state_dir, state])
        _assert_same_text(ref, got, 1e-6)
    assert "reconstructions_aligned_at_start.mlp" in got


def test_localization_accuracy_matches_reference(setup, calibrated, capsys):
    _, _, state_dir = setup
    ref, got = _run_both(capsys, [
        "localization-accuracy", "--gt_state", state_dir,
        "--compared_state", calibrated["schur"][0], "--trials", "6",
        "--seed", "5"])
    _assert_same_text(ref, got, 1e-6)


def test_convert_dataset_matches_reference(setup, tmp_path, capsys):
    _, ds_path, _ = setup
    for tag, main in (("ref", jcli.main), ("port", tcli.main)):
        assert main(["convert-dataset", ds_path,
                     str(tmp_path / f"{tag}.json")]) == 0
        assert main(["convert-dataset", str(tmp_path / f"{tag}.json"),
                     str(tmp_path / f"{tag}.bin")]) == 0
    ref_json = (tmp_path / "ref.json").read_text()
    assert (tmp_path / "port.json").read_text() == ref_json
    assert json.loads(ref_json)["num_cameras"] == 1
    assert (tmp_path / "port.bin").read_bytes() \
        == (tmp_path / "ref.bin").read_bytes()


def test_intersect_datasets_matches_reference(setup, tmp_path):
    """A second dataset with some features moved past the threshold and
    some dropped: both packages keep the same features."""
    _, ds_path, _ = setup
    other = jdataset_bin.load_dataset(ds_path)
    rng = np.random.default_rng(4)
    for s in other.imagesets:
        feats = s.features[0]
        for f in feats:
            f.xy = np.asarray(f.xy) + rng.normal(0, 0.8, 2)
        s.features[0] = [f for f in feats if rng.uniform() > 0.1]
    other_path = tmp_path / "other.bin"
    jdataset_bin.save_dataset(other_path, other)
    for tag, main in (("ref", jcli.main), ("port", tcli.main)):
        assert main(["intersect-datasets", ds_path, str(other_path),
                     "--output", str(tmp_path / f"{tag}.bin"),
                     "--threshold", "1.0"]) == 0
    ref = (tmp_path / "ref.bin").read_bytes()
    assert (tmp_path / "port.bin").read_bytes() == ref
    assert len(ref) < (tmp_path / "other.bin").stat().st_size + 64


def test_create_legends_writes_its_images(tmp_path):
    import cv2

    assert tcli.main(["create-legends", "--output_directory",
                      str(tmp_path)]) == 0
    for name in ("legend_error_directions.png", "legend_error_magnitudes.png",
                 "legend_observation_directions.png"):
        img = cv2.imread(str(tmp_path / name))
        assert img is not None and img.shape[1] >= 400, name


def test_calibrate_from_scratch_and_the_init_cache(setup, tmp_path, capsys):
    """A fresh calibration (dense initialization, the initial state, the
    BA) on the CPU, twice with ``--dense_initialization_base_path``: the
    second run loads the cache and saves the same state."""
    _, ds_path, _ = setup
    argv = ["calibrate", "--dataset_files", ds_path, "--device", "cpu",
            "--dtype", "float64", "--num_pyramid_levels", "1",
            "--final_iterations", "3", "--seed", "3",
            "--dense_initialization_base_path", str(tmp_path / "init")]
    for run in ("a", "b"):
        assert tcli.main(argv + ["--output_directory",
                                 str(tmp_path / run)]) == 0
        out = capsys.readouterr().out
        assert ("[init] loaded dense initialization" in out) == (run == "b")
    assert _state_gap(tmp_path / "a" / "state", tmp_path / "b" / "state") == 0
    report = ast.literal_eval(REPORT_LINE.search(out).group(1))
    assert report["reprojection_error_median"] < 0.05


def test_calibrate_needs_the_card_unless_asked_for_the_cpu(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, ds_path, state_dir = setup
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["calibrate", "--dataset_files", ds_path,
                   "--state_directory", state_dir, "--output_directory",
                   str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["report", "--dataset_files", ds_path, "--state_directory",
                   state_dir, "--output_directory", str(tmp_path)])


def test_calibrate_resume_to_another_model(setup, tmp_path):
    ref, port, ref_rep, port_rep = _resume_runs(
        setup, tmp_path, ["--model", "central_thin_prism_fisheye"])
    state, _, _ = tstate_io.load_ba_state(port, device="cpu")
    assert type(state.intrinsics[0]).__name__ == "CentralThinPrismFisheyeModel"
    assert _state_gap(ref, port) <= 1e-3
    _assert_same_run(ref_rep, port_rep, 1e-2)

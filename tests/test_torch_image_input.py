"""Port parity: image input, the live consumer, ``record`` and the
on-screen pattern.

- Directory and video inputs and the spec factory on the frames of
  ``tests/test_image_input.py``: the port's imagesets equal the reference
  module's on the same files, array for array; a missing source and mixed
  directory/capture specs are refused.
- ``LiveImageConsumer`` against the reference's, both fed one stub
  detector that returns fixed features (so no detector runs): the same
  kept/dropped decisions, dataset imagesets, recorded files and coverage
  maps, on a two-camera rig of directory inputs.
- One consumer run with the port's real detector on the CPU, on the
  tagged board of ``tests/test_detector.py`` (two views and a blank one),
  and ``record`` through ``cli.main`` in this process, read back with the
  port's ``dataset_bin``: the same features as ``detect`` on the board.
- ``PatternDisplay.image`` at 640×480 equal to the reference's, bit for
  bit; ``available()`` answers a bool without raising.
- ``render-synthetic`` in two threads writes the bytes of one thread.

The module runs with one intra-op thread (``tests/torch_threads.py``).
"""

import os

import cv2
import numpy as np
import pytest

from camera_calibration_torch import cli as tcli
from camera_calibration_torch.ba import dataset as tds
from camera_calibration_torch.features import detector as tdet
from camera_calibration_torch.features import pattern as tpat
from camera_calibration_torch.io import dataset_bin
from camera_calibration_torch.io import image_input as tin
from camera_calibration_torch.ui import live_capture as tlive
from camera_calibration_torch.ui.pattern_display import PatternDisplay
from camera_calibration_tpu.ba import dataset as jds
from camera_calibration_tpu.features import pattern as jpat
from camera_calibration_tpu.io import image_input as jin
from camera_calibration_tpu.ui import live_capture as jlive
from camera_calibration_tpu.ui.pattern_display import (
    PatternDisplay as JPatternDisplay)
from test_torch_detector import _board_image
from torch_threads import one_torch_thread  # noqa: F401


def _write_frames(root, name, frames):
    d = root / name
    d.mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(d / f"img{i:03d}.png"), f)
    return str(d)


def _both(spec):
    """Every imageset of the spec through both modules."""
    with tin.create_image_input(spec) as a, jin.create_image_input(spec) as b:
        assert a.num_cameras == b.num_cameras
        return list(a), list(b)


def _assert_same_sets(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_directory_input_and_factory(tmp_path):
    rng = np.random.default_rng(0)
    frames0 = [rng.integers(0, 255, (24, 32, 3), np.uint8) for _ in range(3)]
    frames1 = [rng.integers(0, 255, (24, 32, 3), np.uint8) for _ in range(4)]
    d0 = _write_frames(tmp_path, "cam0", frames0)
    d1 = _write_frames(tmp_path, "cam1", frames1)

    inp = tin.create_image_input(f"dir:{d0},{d1}")
    assert isinstance(inp, tin.DirectoryInput) and inp.num_cameras == 2
    got, want = _both(f"dir:{d0},{d1}")
    # synchronized: truncated to the shorter camera stream
    assert len(got) == 3
    np.testing.assert_array_equal(got[1][1], frames1[1])
    _assert_same_sets(got, want)
    # a bare directory path is a directory input too
    _assert_same_sets(*_both(d0))


def test_video_capture_input(tmp_path):
    """The cv2.VideoCapture path (a v4l2 device uses the same class with a
    device index).  MJPG in .avi must be writable here: a missing codec
    fails the test."""
    path = str(tmp_path / "seq.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (64, 48))
    assert w.isOpened()
    rng = np.random.default_rng(1)
    for _ in range(5):
        w.write(rng.uniform(0, 255, (48, 64, 3)).astype(np.uint8))
    w.release()

    got, want = _both(f"video:{path}")
    assert len(got) == 5 and got[0][0].shape == (48, 64, 3)
    _assert_same_sets(got, want)
    with tin.create_image_input(f"video:{path},video:{path}") as two:
        assert two.num_cameras == 2 and len(list(two)) == 5


def test_input_refusals(tmp_path):
    with pytest.raises(RuntimeError):
        tin.create_image_input(f"video:{tmp_path}/does_not_exist.avi")
    d = tmp_path / "empty"
    d.mkdir()
    with pytest.raises(RuntimeError):
        tin.create_image_input(f"dir:{d}")
    (d / "a.png").write_bytes(b"")
    with pytest.raises(ValueError):
        tin.create_image_input(f"dir:{d},video:{tmp_path}/x.avi")
    assert tin._parse_spec("v4l2:3") == ("v4l2", "3")
    assert all(dev.spec.startswith("v4l2:") for dev in tin.list_v4l2_devices())


class _StubDetector:
    """Fixed features per image: none for a (nearly) uniform image, else
    eight at positions drawn from the image's mean."""

    def __init__(self, feature_cls):
        self.feature_cls = feature_cls

    def detect(self, gray):
        if gray.std() < 1.0:
            return [], None
        rng = np.random.default_rng(int(gray.mean() * 1000))
        h, w = gray.shape
        return [self.feature_cls(xy=rng.uniform([0, 0], [w, h]),
                                 feature_id=int(i))
                for i in rng.choice(100, 8, replace=False)], None


def _run_consumer(mod, ds_mod, spec, root, options, n_cam):
    dataset = ds_mod.Dataset(num_cameras=n_cam, image_sizes=[])
    lines = []
    consumer = mod.LiveImageConsumer(
        dataset, _StubDetector(ds_mod.PointFeature),
        mod.LiveCaptureOptions(**options,
                               visualization_directory=str(root / "viz")),
        record_directories=[str(root / f"rec{ci}") for ci in range(n_cam)],
        log=lines.append)
    inp_mod = tin if mod is tlive else jin
    with inp_mod.create_image_input(spec) as inp:
        kept = mod.run_live_capture(inp, consumer)
    return kept, dataset, consumer, lines


@pytest.mark.parametrize("options", [
    dict(record_images=True),
    dict(record_images=True, record_with_detections_only=False,
         max_imagesets=2),
])
def test_live_consumer_matches_reference(tmp_path, options):
    rng = np.random.default_rng(2)
    frames = [[rng.integers(0, 255, (40, 60), np.uint8) for _ in range(4)]
              for _ in range(2)]
    frames[0][1] = frames[1][1] = np.full((40, 60), 90, np.uint8)  # dropped
    frames[0][2] = np.full((40, 60), 200, np.uint8)  # camera 0 sees nothing
    dirs = [_write_frames(tmp_path, f"cam{ci}", f) for ci, f in
            enumerate(frames)]
    spec = ",".join(f"dir:{d}" for d in dirs)
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    kp, dp, cp, lp = _run_consumer(tlive, tds, spec, tmp_path / "port",
                                   options, 2)
    kr, dr, cr, lr = _run_consumer(jlive, jds, spec, tmp_path / "ref",
                                   options, 2)
    assert kp == kr > 0 and lp == lr
    assert any("dropped" in line for line in lp)
    assert dp.image_sizes == dr.image_sizes == [(60, 40), (60, 40)]
    assert len(dp.imagesets) == len(dr.imagesets)
    for a, b in zip(dp.imagesets, dr.imagesets):
        assert a.filenames == b.filenames
        for fa, fb in zip(a.features, b.features):
            assert [f.feature_id for f in fa] == [f.feature_id for f in fb]
            assert all(np.array_equal(x.xy, y.xy) for x, y in zip(fa, fb))
    assert cp.num_recorded == cr.num_recorded > 0
    for ci in range(2):
        assert np.array_equal(cp.detections_per_pixel[ci],
                              cr.detections_per_pixel[ci])
        names = sorted(os.listdir(tmp_path / "port" / f"rec{ci}"))
        assert names == sorted(os.listdir(tmp_path / "ref" / f"rec{ci}"))
        for n in names:
            assert np.array_equal(
                cv2.imread(str(tmp_path / "port" / f"rec{ci}" / n)),
                cv2.imread(str(tmp_path / "ref" / f"rec{ci}" / n)))
        png = f"viz/coverage_camera{ci}.png"
        assert np.array_equal(cv2.imread(str(tmp_path / "port" / png)),
                              cv2.imread(str(tmp_path / "ref" / png)))
    assert cp.detect_seconds <= cp.imageset_seconds


@pytest.fixture(scope="module")
def board(tmp_path_factory):
    """The tagged board of tests/test_detector.py as uint8 frames on disk
    (two views and a blank one), its port spec saved as YAML, and the
    port detector's features on the two views, in turn (each call draws
    the detector's next random numbers)."""
    jspec, tspec, img, h_pp = _board_image(0, 0.0)
    root = tmp_path_factory.mktemp("board")
    u8 = (img * 255).astype(np.uint8)
    d0 = _write_frames(root, "cam0", [u8, u8, np.full_like(u8, 255)])
    yaml = str(root / "pattern.yaml")
    tpat.save_pattern_yaml(tspec, yaml)
    det = tdet.FeatureDetector([tspec], device="cpu")
    want = [det.detect(u8)[0] for _ in range(2)]
    return tspec, d0, yaml, want


def test_live_consumer_with_the_port_detector(board, tmp_path):
    tspec, d0, _, want = board
    det = tdet.FeatureDetector([tspec], device="cpu")
    dataset = tds.Dataset(num_cameras=1, image_sizes=[])
    consumer = tlive.LiveImageConsumer(
        dataset, det,
        tlive.LiveCaptureOptions(record_images=True,
                                 visualization_directory=str(tmp_path / "v")),
        record_directories=[str(tmp_path / "rec0")], log=lambda *a: None)
    with tin.create_image_input(f"dir:{d0}") as inp:
        kept = tlive.run_live_capture(inp, consumer)
    assert kept == 2 and len(dataset.imagesets) == 2  # the blank is dropped
    assert len(want[0]) > 30
    for s, ref in zip(dataset.imagesets, want):
        got = s.features[0]
        assert [f.feature_id for f in got] == [f.feature_id for f in ref]
        assert all(np.array_equal(a.xy, b.xy) for a, b in zip(got, ref))
    assert consumer.num_recorded == 2
    assert len(os.listdir(tmp_path / "rec0")) == 2
    assert (tmp_path / "v" / "coverage_camera0.png").exists()
    assert consumer.detections_per_pixel[0].max() >= 1


def test_record_command(board, tmp_path, capsys):
    tspec, d0, yaml, want = board
    out = tmp_path / "out"
    assert tcli.main(["record", "--inputs", f"dir:{d0}", "--pattern_files",
                      yaml, "--output_directory", str(out), "--max_imagesets",
                      "2", "--record_images", "--device", "cpu"]) == 0
    assert "recorded 2 imagesets" in capsys.readouterr().out
    ds = dataset_bin.load_dataset(str(out / "dataset.bin"))
    h, w = cv2.imread(os.path.join(d0, "img000.png")).shape[:2]
    assert len(ds.imagesets) == 2 and ds.image_sizes == [(w, h)]
    got = {f.feature_id: f.xy for f in ds.imagesets[0].features[0]}
    ref = {f.feature_id: f.xy for f in want[0]}
    assert sorted(got) == sorted(ref)
    # the file keeps float32 positions
    assert max(np.abs(got[k] - ref[k]).max() for k in ref) < 1e-4
    assert len(ds.known_geometries) == 1
    assert (out / "coverage_camera0.png").exists()
    assert len(os.listdir(out / "images_camera0")) == 2


def test_pattern_display_matches_reference():
    kw = dict(num_star_segments=16, squares_x=8, squares_y=8,
              square_length_in_meters=0.02)
    tspec = tpat.PatternSpec(**kw, tags=[tpat.AprilTagInfo(3, 3, 2, 2, 0)])
    jspec = jpat.PatternSpec(**kw, tags=[jpat.AprilTagInfo(3, 3, 2, 2, 0)])
    got = PatternDisplay(tspec, screen_size=(640, 480), supersample=2)
    want = JPatternDisplay(jspec, screen_size=(640, 480), supersample=2)
    assert got.image.shape == (480, 640)
    assert got.image.dtype == want.image.dtype
    assert np.array_equal(got.image, want.image)
    assert np.array_equal(got._img8, want._img8)
    assert got.image[:4].mean() > 0.95 and got.image.min() < 0.2
    # the probe must not raise on a headless machine
    assert isinstance(PatternDisplay.available(), bool)
    assert PatternDisplay.available() == JPatternDisplay.available()


def test_render_synthetic_workers_write_the_same_files(board, tmp_path,
                                                       monkeypatch):
    """``render-synthetic`` with two cores (the views in two threads, each
    with a copy of the generator) writes the same bytes as with one core,
    degradations included."""
    _, _, yaml, _ = board
    args = ["render-synthetic", "--pattern_file", yaml, "--num_images", "3",
            "--width", "160", "--height", "120", "--min_z", "0.3",
            "--max_z", "0.4", "--defocus_sigma", "0.8", "--exposure_drift",
            "0.1", "--noise", "0.02", "--seed", "3"]
    for name, cores in (("one", {0}), ("two", {0, 1})):
        monkeypatch.setattr(os, "sched_getaffinity", lambda pid: cores)
        assert tcli.main(args + ["--output_directory",
                                 str(tmp_path / name)]) == 0
    names = sorted(os.listdir(tmp_path / "one"))
    assert len(names) == 3 and names == sorted(os.listdir(tmp_path / "two"))
    for n in names:
        assert ((tmp_path / "one" / n).read_bytes()
                == (tmp_path / "two" / n).read_bytes()), n

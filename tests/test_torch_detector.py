"""The port's feature detector and image-side CLI against the reference
package, on the CPU in float64.

- ``FeatureDetector.detect`` and ``detect_batch`` on the 12×12 tagged
  board of ``tests/test_detector.py`` (one noisy image, and a batch of two)
  and one gradient-mode run (on a 10×10 board): the same feature ids,
  positions within 1e-6 px.  The detector's NumPy generator draws in the reference's order, so
  both render the same templates.
- ``render-synthetic`` writes PNGs byte-identical to the reference CLI's
  (that command runs no JAX); ``create-pattern`` writes the same YAML and
  preview PNG; ``extract-features`` writes exactly the features
  ``detect_batch`` returns (as float32, the format's type).
- Without a card, the entry points raise unless asked for the CPU.

The module runs with one intra-op thread (``tests/torch_threads.py``).
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from camera_calibration_torch import cli as tcli
from camera_calibration_torch.features import detector as tdet
from camera_calibration_torch.features import pattern as tpat
from camera_calibration_torch.io import dataset_bin
from camera_calibration_tpu import cli as jcli
from camera_calibration_tpu.features import detector as jdet
from camera_calibration_tpu.features import pattern as jpat
from torch_threads import one_torch_thread  # noqa: F401

POS_PX = 1e-6
CPU64 = dict(device="cpu", dtype=torch.float64)


def _board_image(seed, noise, n=12, square_px=26.0, angle=0.04, persp=2e-5):
    """The tagged board of ``tests/test_detector.py:_make_pattern_image``:
    (reference spec, port spec, image, pattern-to-pixel homography)."""
    rng = np.random.default_rng(seed)
    spec = jpat.PatternSpec(
        num_star_segments=16, squares_x=n, squares_y=n,
        square_length_in_meters=0.02,
        tags=[jpat.AprilTagInfo(x=4, y=4, width=3, height=3, index=0)])
    c, s = np.cos(angle), np.sin(angle)
    h_pp = np.array([[square_px * c, -square_px * s, 2.2 * square_px],
                     [square_px * s, square_px * c, 2.0 * square_px],
                     [persp, -persp, 1.0]])
    size = int(square_px * (n + 3))
    img = jpat.render_pattern(spec, np.linalg.inv(h_pp), (size, size),
                              supersample=4,
                              tag_renderer=jpat.make_tag_renderer(spec))
    if noise:
        img = np.clip(img + rng.normal(0, noise, img.shape), 0, 1)
    return spec, _port_spec(spec), img, h_pp


def _port_spec(spec):
    return tpat.PatternSpec(
        num_star_segments=spec.num_star_segments, squares_x=spec.squares_x,
        squares_y=spec.squares_y,
        square_length_in_meters=spec.square_length_in_meters,
        tags=[tpat.AprilTagInfo(t.x, t.y, t.width, t.height, t.index)
              for t in spec.tags])


def _same_features(got, want, h_pp=None, spec=None):
    """Same feature ids, positions within 1e-6 px; with ``h_pp``, also
    close to the rendered truth."""
    g = {f.feature_id: f.xy for f in got}
    w = {f.feature_id: f.xy for f in want}
    assert sorted(g) == sorted(w)
    assert len(g) > 0.6 * spec.feature_count()
    gap = max(np.abs(g[k] - w[k]).max() for k in w)
    assert gap <= POS_PX, gap
    cm = tpat.corners_for_patterns([spec])[0]
    errs = []
    for fid, xy in g.items():
        q = h_pp @ np.array([*cm[fid], 1.0])
        errs.append(np.linalg.norm(xy - q[:2] / q[2]))
    assert np.median(errs) < 0.1


@pytest.fixture(scope="module")
def boards():
    return [_board_image(seed, 0.02) for seed in (4, 5)]


def test_detect_matches_the_reference(boards):
    jspec, tspec, img, h_pp = boards[0]
    want, _ = jdet.FeatureDetector([jspec]).detect(img)
    got, per_pattern = tdet.FeatureDetector([tspec], **CPU64).detect(img)
    _same_features(got, want, h_pp, tspec)
    assert sum(len(d) for d in per_pattern) == len(got)


def test_detect_batch_matches_the_reference(boards):
    jspec, tspec = boards[0][:2]
    images = [b[2] for b in boards]
    want = jdet.FeatureDetector([jspec]).detect_batch(images)
    got = tdet.FeatureDetector([tspec], **CPU64).detect_batch(images)
    assert len(got) == len(want) == 2
    for (gf, _), (wf, _), board in zip(got, want, boards):
        _same_features(gf, wf, board[3], tspec)


def test_gradient_mode_matches_the_reference():
    jspec, tspec, img, h_pp = _board_image(12, 0.01, n=10)
    opts = dict(refinement_type="gradient")
    want, _ = jdet.FeatureDetector(
        [jspec], jdet.DetectorOptions(**opts)).detect(img)
    got, _ = tdet.FeatureDetector(
        [tspec], tdet.DetectorOptions(**opts), **CPU64).detect(img)
    _same_features(got, want, h_pp, tspec)


def test_entry_points_need_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    spec = tpat.PatternSpec(16, 6, 6, 0.02)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdet.FeatureDetector([spec])
    tpat.save_pattern_yaml(spec, tmp_path / "p.yaml")
    (tmp_path / "img").mkdir()
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["extract-features", "--image_directories",
                   str(tmp_path / "img"), "--pattern_files",
                   str(tmp_path / "p.yaml"), "--output",
                   str(tmp_path / "d.bin")])


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """A 10×10 board made by each package's create-pattern, and three
    512×384 views of it rendered by each package's render-synthetic."""
    root = tmp_path_factory.mktemp("cli")
    out = {}
    for name, cli in (("port", tcli), ("reference", jcli)):
        pat_dir = root / name / "pattern"
        cli.main(["create-pattern", "--output_directory", str(pat_dir),
                  "--squares_x", "10", "--squares_y", "10",
                  "--square_length_in_meters", "0.02",
                  "--dpi_pixels_per_square", "16"])
        base = pat_dir / "pattern_resolution_10x10_segments_16"
        cli.main(["render-synthetic", "--pattern_file", f"{base}.yaml",
                  "--output_directory", str(root / name / "images"),
                  "--num_images", "3", "--width", "512", "--height", "384",
                  "--min_z", "0.27", "--max_z", "0.36", "--noise", "0.01",
                  "--defocus_sigma", "0.8", "--seed", "3"])
        out[name] = (base, root / name / "images")
    return out


def test_create_pattern_writes_the_reference_files(rendered):
    port, ref = rendered["port"][0], rendered["reference"][0]
    for suffix in (".yaml", ".png"):
        assert filecmp.cmp(f"{port}{suffix}", f"{ref}{suffix}",
                           shallow=False), suffix
    assert open(f"{port}.pdf", "rb").read(8) == b"%PDF-1.4"


def test_render_synthetic_pngs_are_byte_identical(rendered):
    port, ref = rendered["port"][1], rendered["reference"][1]
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(ref)) and len(names) == 3
    for name in names:
        assert filecmp.cmp(port / name, ref / name, shallow=False), name


def test_extract_features_writes_what_detect_batch_returns(rendered,
                                                          tmp_path):
    import cv2

    base, images = rendered["port"]
    out = tmp_path / "dataset.bin"
    tcli.main(["extract-features", "--image_directories", str(images),
               "--pattern_files", f"{base}.yaml", "--output", str(out),
               "--device", "cpu", "--dtype", "float64"])
    ds = dataset_bin.load_dataset(str(out))
    spec = tpat.load_pattern_yaml(f"{base}.yaml")
    names = sorted(os.listdir(images))
    imgs = [cv2.imread(str(images / n), cv2.IMREAD_GRAYSCALE) for n in names]
    want = tdet.FeatureDetector([spec], **CPU64).detect_batch(imgs)
    assert ds.num_cameras == 1 and len(ds.imagesets) == len(names)
    assert ds.image_sizes == [(512, 384)]
    total = 0
    for imageset, name, (features, _) in zip(ds.imagesets, names, want):
        assert imageset.filenames == [name]
        got = imageset.features[0]
        assert [f.feature_id for f in got] == [f.feature_id for f in features]
        for g, w in zip(got, features):
            # dataset.bin stores float32 coordinates
            np.testing.assert_array_equal(g.xy, w.xy.astype(np.float32))
        total += len(got)
    assert total > 0.5 * len(names) * spec.feature_count()
    geom = ds.known_geometries[0]
    assert geom.cell_length_in_meters == np.float32(0.02)
    assert geom.feature_id_to_position == tpat.corners_for_patterns([spec])[0]

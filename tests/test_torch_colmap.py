"""Port parity: COLMAP interchange (``io/colmap.py``), ``export-colmap``,
``refine-colmap``, ``compare-point-clouds`` and ``visualize-calibration``.

Both packages get the same float64 inputs on the CPU (the port's
commands with ``--device cpu``):

- ``write_model`` of one model per camera kind (PINHOLE, FULL_OPENCV,
  THIN_PRISM_FISHEYE) with images, 2D points and tracks drawn from a
  NumPy seed: the three files byte-identical; ``read_model`` of them gives
  the same cameras, images and points in both packages, and the port
  writes what it read back to the same bytes;
- ``export-colmap`` of a saved state (an OpenCV camera seeing the
  320×240 dataset of ``tests/test_torch_cli.py`` from poses rotated by
  0.01 rad and moved by 5 mm at random): the same files;
- ``refine-colmap`` of that export, 4 LM iterations: the refined poses,
  points and intrinsics within 1e-8 relative (the packages' LM solves sum
  in different orders; observed ~1e-12), the same printed words and the
  final cost to 1e-8;
- ``compare-point-clouds`` of two .obj clouds, paired and unpaired: the
  same printed text;
- ``visualize-calibration``: the arrays that the reference plots
  (``imshow`` captured) equal to the port's ``camera_visualization`` to
  1e-9 (the direction RGB) and 1e-6 px (the displacement: a least-squares
  pinhole fit differences rounding), for the saved state, for a Kalibr
  YAML (radtan and equidistant cameras) and for a COLMAP model; the port
  writes every image.

The module runs with one intra-op thread (``tests/torch_threads.py``).
"""

import filecmp

import jax.numpy as jnp
import matplotlib.axes
import numpy as np
import pytest
import torch

from camera_calibration_torch import cli as tcli
from camera_calibration_torch import problems
from camera_calibration_torch.ba.state import BAState
from camera_calibration_torch.init.state_init import (
    feature_id_to_point_index, initial_points)
from camera_calibration_torch.io import colmap as tcol
from camera_calibration_torch.io import dataset_bin as tdataset_bin
from camera_calibration_torch.io import state_io as tstate_io
from camera_calibration_torch.models import parametric as tpm
from camera_calibration_torch.models import pinhole as tph
from camera_calibration_torch.ops import se3
from camera_calibration_tpu import cli as jcli
from camera_calibration_tpu.io import colmap as jcol
from camera_calibration_tpu.models import parametric as jpm
from camera_calibration_tpu.models import pinhole as jph
from torch_threads import one_torch_thread  # noqa: F401

FILES = ("cameras.txt", "images.txt", "points3D.txt")
W, H = 320, 240


def _camera_params(kind, rng):
    p = np.zeros(12)
    p[:4] = [290.0, 288.0, 161.0, 119.0]
    p[4:] = rng.normal(0, 0.02, 8)
    return p


def _cameras(kind, rng):
    """The same camera in both packages: (port model, reference model)."""
    if kind == "pinhole":
        args = (290.0, 288.0, 161.0, 119.0, W, H)
        return (tph.make_pinhole(*args, device="cpu"), jph.make_pinhole(*args))
    p = _camera_params(kind, rng)
    if kind == "opencv":
        return (tpm.CentralOpenCVModel(params=torch.as_tensor(p), width=W,
                                       height=H),
                jpm.CentralOpenCVModel(params=jnp.asarray(p), width=W,
                                       height=H))
    return (tpm.CentralThinPrismFisheyeModel(
        params=torch.as_tensor(p), width=W, height=H,
        use_equidistant_projection=True),
        jpm.CentralThinPrismFisheyeModel(
            params=jnp.asarray(p), width=W, height=H,
            use_equidistant_projection=True))


def _models(kind, seed=0):
    """(port ColmapModel, reference ColmapModel) of two cameras, five
    images and 40 points with random tracks."""
    rng = np.random.default_rng(seed)
    cams = [_cameras(kind, rng) for _ in range(2)]
    images, points = [], {}
    for i in range(5):
        q = rng.normal(0, 1, 4)
        pts2d = [(float(x), float(y), int(pid)) for x, y, pid in zip(
            rng.uniform(0, W, 7), rng.uniform(0, H, 7),
            rng.integers(-1, 40, 7))]
        images.append(dict(image_id=i + 1, q=q / np.linalg.norm(q),
                           t=rng.normal(0, 1, 3), camera_id=1 + i % 2,
                           name=f"im{i}.png",
                           points2d=pts2d if i != 3 else []))
    for pid in range(1, 41):
        points[pid] = (rng.normal(0, 1, 3), rng.integers(0, 256, 3),
                       float(rng.uniform()),
                       [(int(a), int(b)) for a, b in
                        rng.integers(1, 6, (int(rng.integers(0, 4)), 2))])
    return tuple(
        mod.ColmapModel(cameras={1: cams[0][k], 2: cams[1][k]},
                        images=[mod.ColmapImage(**im) for im in images],
                        points3d=points)
        for k, mod in ((0, tcol), (1, jcol)))


def _same_files(a, b):
    for name in FILES:
        assert filecmp.cmp(a / name, b / name, shallow=False), name


def _camera_arrays(cam):
    if hasattr(cam, "params"):
        return [np.asarray(cam.params)]
    return [np.asarray([cam.fx, cam.fy, cam.cx, cam.cy], float)]


@pytest.mark.parametrize("kind", ["pinhole", "opencv", "tpf"])
def test_write_and_read_model_match_reference(kind, tmp_path):
    port, ref = _models(kind)
    tcol.write_model(tmp_path / "port", port)
    jcol.write_model(tmp_path / "ref", ref)
    _same_files(tmp_path / "port", tmp_path / "ref")
    got = tcol.read_model(tmp_path / "ref", device="cpu")
    want = jcol.read_model(tmp_path / "ref")
    assert got.cameras.keys() == want.cameras.keys()
    for cid in want.cameras:
        gc, wc = got.cameras[cid], want.cameras[cid]
        assert type(gc).__name__ == type(wc).__name__
        assert (gc.width, gc.height) == (wc.width, wc.height)
        for a, b in zip(_camera_arrays(gc), _camera_arrays(wc)):
            np.testing.assert_array_equal(a, b)
    assert len(got.images) == len(want.images)
    for a, b in zip(got.images, want.images):
        assert (a.image_id, a.camera_id, a.name, a.points2d) == \
            (b.image_id, b.camera_id, b.name, b.points2d)
        np.testing.assert_array_equal(a.q, b.q)
        np.testing.assert_array_equal(a.t, b.t)
    assert got.points3d.keys() == want.points3d.keys()
    for pid, (xyz, rgb, err, track) in want.points3d.items():
        g = got.points3d[pid]
        np.testing.assert_array_equal(g[0], xyz)
        np.testing.assert_array_equal(g[1], rgb)
        assert (g[2], g[3]) == (err, track)
    tcol.write_model(tmp_path / "again", got)
    _same_files(tmp_path / "again", tmp_path / "ref")


def test_non_equidistant_fisheye_and_grid_models_are_refused():
    p = torch.as_tensor(_camera_params("tpf", np.random.default_rng(0)))
    cam = tpm.CentralThinPrismFisheyeModel(params=p, width=W, height=H,
                                           use_equidistant_projection=False)
    with pytest.raises(TypeError, match="equidistant"):
        tcol._camera_to_colmap(cam)
    with pytest.raises(TypeError, match="no COLMAP model"):
        tcol._camera_to_colmap(object())
    with pytest.raises(ValueError, match="unsupported"):
        tcol._camera_from_colmap("FOV", W, H, [1.0] * 5, device="cpu")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """dataset.bin and a saved state of an OpenCV camera, and both
    packages' ``export-colmap`` of it."""
    root = tmp_path_factory.mktemp("torch_colmap")
    ds, _, poses = problems.make_calibration_dataset(seed=2, n_imagesets=10,
                                                     k=12, w=W, h=H)
    ds_path = root / "dataset.bin"
    tdataset_bin.save_dataset(ds_path, ds)
    rng = np.random.default_rng(7)
    qs = np.stack([se3.matrix_to_quat_np(r) for r, _ in poses])
    dq = se3.quat_exp(torch.as_tensor(rng.normal(0, 0.01, (len(poses), 3))))
    fid = feature_id_to_point_index(ds)
    params = np.zeros(12)
    params[:4] = [0.9 * W * 1.01, 0.9 * W * 0.99, 0.5 * W + 1, 0.5 * H - 1]
    params[4:6] = [0.01, -0.005]
    state = BAState(
        rig_q_global=se3.quat_mul(dq, torch.as_tensor(qs)),
        rig_t_global=torch.as_tensor(np.stack([t for _, t in poses])
                                     + rng.normal(0, 0.005, (len(poses), 3))),
        cam_q_rig=torch.tensor([[1.0, 0, 0, 0]], dtype=torch.float64),
        cam_t_rig=torch.zeros((1, 3), dtype=torch.float64),
        points=torch.as_tensor(initial_points(ds, fid, [None])),
        intrinsics=(tpm.CentralOpenCVModel(params=torch.as_tensor(params),
                                           width=W, height=H),))
    state_dir = root / "state"
    tstate_io.save_ba_state(state_dir, state, [True] * len(poses), fid)
    for tag, main in (("ref", jcli.main), ("port", tcli.main)):
        assert main(["export-colmap", "--state_directory", str(state_dir),
                     "--output_directory", str(root / tag / "colmap"),
                     "--dataset_files", str(ds_path)]) == 0
    return root


def test_export_colmap_matches_reference(setup):
    _same_files(setup / "port" / "colmap", setup / "ref" / "colmap")
    model = tcol.read_model(setup / "port" / "colmap", device="cpu")
    assert len(model.images) == 10 and len(model.points3d) == 144
    assert sum(len(im.points2d) for im in model.images) > 1000


def test_refine_colmap_matches_reference(setup, capsys):
    outs = []
    for tag, main, extra in (("ref", jcli.main, []),
                             ("port", tcli.main, ["--device", "cpu"])):
        assert main(["refine-colmap", "--colmap_model",
                     str(setup / "ref" / "colmap"), "--output_directory",
                     str(setup / tag / "refined"), "--iterations", "4"]
                    + extra) == 0
        outs.append(capsys.readouterr().out.replace(f"/{tag}/", "/"))
    cost = [float(o.split("final cost ")[1].split()[0]) for o in outs]
    assert abs(cost[1] - cost[0]) <= 1e-8 * cost[0]
    assert outs[0].split("final cost")[0] == outs[1].split("final cost")[0]
    assert outs[0].split("\n")[1:] == outs[1].split("\n")[1:]
    start = tcol.read_model(setup / "ref" / "colmap", device="cpu")
    got = tcol.read_model(setup / "port" / "refined", device="cpu")
    want = jcol.read_model(setup / "ref" / "refined")

    def rel(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                     / max(np.abs(np.asarray(b)).max(), 1.0))

    for a, b in zip(got.images, want.images):
        assert rel(a.q, b.q) <= 1e-8 and rel(a.t, b.t) <= 1e-8
    pa = np.stack([p[0] for p in got.points3d.values()])
    pb = np.stack([p[0] for p in want.points3d.values()])
    assert rel(pa, pb) <= 1e-8
    assert rel(got.cameras[1].params, want.cameras[1].params) <= 1e-8
    # the refinement moved the perturbed poses
    assert max(rel(a.t, b.t) for a, b in zip(got.images, start.images)) \
        > 1e-4


def _write_obj(path, pts):
    with open(path, "w") as f:
        for p in pts:
            f.write("v %.6f %.6f %.6f\n" % tuple(p))


def test_compare_point_clouds_matches_reference(tmp_path, capsys):
    rng = np.random.default_rng(3)
    a = rng.normal(0, 1, (300, 3))
    r = np.linalg.qr(rng.normal(0, 1, (3, 3)))[0]
    r *= np.sign(np.linalg.det(r))
    b = 1.3 * a @ r.T + [0.2, -0.1, 0.5] + rng.normal(0, 0.01, a.shape)
    _write_obj(tmp_path / "a.obj", a)
    _write_obj(tmp_path / "b.obj", b[:250])
    for extra in ([], ["--paired"]):
        argv = ["compare-point-clouds", str(tmp_path / "a.obj"),
                str(tmp_path / "b.obj")] + extra
        assert jcli.main(argv) == 0
        ref = capsys.readouterr().out
        assert tcli.main(argv) == 0
        assert capsys.readouterr().out == ref
    assert "scale 1.3" in ref


KALIBR = """cam0:
  camera_model: pinhole
  intrinsics: [290.0, 288.0, 161.0, 119.0]
  distortion_model: radtan
  distortion_coeffs: [-0.1, 0.02, 0.001, -0.0005]
  resolution: [320, 240]
cam1:
  camera_model: pinhole
  intrinsics: [150.0, 150.0, 160.0, 120.0]
  distortion_model: equidistant
  distortion_coeffs: [0.01, -0.005, 0.001, -0.0002]
  resolution: [320, 240]
"""


def _reference_arrays(monkeypatch, args):
    """The arrays the reference's ``visualize-calibration`` plots, in
    order, per written image."""
    shown = []
    imshow = matplotlib.axes.Axes.imshow
    monkeypatch.setattr(matplotlib.axes.Axes, "imshow",
                        lambda self, x, *a, **k: shown.append(np.array(x))
                        or imshow(self, x, *a, **k))
    assert jcli.main(["visualize-calibration"] + args) == 0
    monkeypatch.undo()
    return shown


@pytest.mark.parametrize("source", ["state", "kalibr", "colmap"])
def test_visualize_calibration_matches_reference(setup, source, tmp_path,
                                                 monkeypatch):
    if source == "kalibr":
        (tmp_path / "camchain.yaml").write_text(KALIBR)
        args = ["--kalibr_yaml", str(tmp_path / "camchain.yaml")]
        cams = tcli._kalibr_load_cameras(tmp_path / "camchain.yaml", "cpu")
    elif source == "colmap":
        args = ["--colmap_model", str(setup / "ref" / "colmap")]
        cams = {cid - 1: c for cid, c in tcol.read_model(
            setup / "ref" / "colmap", device="cpu").cameras.items()}
    else:
        args = ["--state_directory", str(setup / "state")]
        state, _, _ = tstate_io.load_ba_state(setup / "state", device="cpu")
        cams = dict(enumerate(state.intrinsics))
    shown = _reference_arrays(
        monkeypatch, args + ["--output_directory", str(tmp_path / "ref")])
    expected = []
    for idx in sorted(cams):
        rgb, disp = tcli.camera_visualization(cams[idx])
        expected += [rgb] + ([] if disp is None else [disp])
    assert len(shown) == len(expected) >= 2 * len(cams) - 1
    for got, ref in zip(expected, shown):
        ref = np.asarray(ref, float)
        if ref.ndim == 3:
            np.testing.assert_allclose(np.clip(got, 0, 1), ref, rtol=0,
                                       atol=1e-9)
        else:
            assert np.array_equal(np.isnan(got), np.isnan(ref))
            np.testing.assert_allclose(got[~np.isnan(ref)],
                                       ref[~np.isnan(ref)], rtol=0,
                                       atol=1e-6)
    assert tcli.main(["visualize-calibration"] + args + [
        "--output_directory", str(tmp_path / "port"), "--device",
        "cpu"]) == 0
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir())

"""Port parity: datasets, observation tables, dataset.bin and state IO.

- ``io/dataset_bin``: the golden ``dataset.bin`` bytes of
  ``tests/test_golden_io.py`` read and written back bit for bit, a dataset
  written by the port read by the reference package (and the reverse) to
  the same features, and the multi-file merge;
- ``ba/dataset``: ``build_observation_table`` and
  ``build_per_camera_tables`` equal to the reference package's tables
  (every column exactly), with and without ``image_used``;
- ``io/state_io``: the port writes the reference package's files byte for
  byte (every model family), and a save/load round trip gives the state
  back to the files' 14 significant digits.
"""

import dataclasses
import filecmp

import numpy as np
import pytest
import torch

from camera_calibration_torch import convert, problems
from camera_calibration_torch.ba import dataset as tds
from camera_calibration_torch.io import dataset_bin as tbin
from camera_calibration_torch.io import state_io as tio
from camera_calibration_tpu.ba import dataset as jds
from camera_calibration_tpu.io import dataset_bin as jbin
from camera_calibration_tpu.io import state_io as jio
from test_golden_io import _golden_dataset_bytes
from torch_threads import one_torch_thread  # noqa: F401

FILES = ("rig_tr_global.yaml", "camera_tr_rig.yaml", "intrinsics0.yaml",
         "points.yaml", "rig_tr_global.yaml.obj", "points.yaml.obj")


def _features(ds):
    return [[[(float(f.xy[0]), float(f.xy[1]), f.feature_id) for f in feats]
             for feats in s.features] for s in ds.imagesets]


def _same_dataset(a, b):
    assert a.num_cameras == b.num_cameras
    assert [tuple(s) for s in a.image_sizes] == [tuple(s) for s in b.image_sizes]
    assert _features(a) == _features(b)
    assert [s.filenames for s in a.imagesets] == [s.filenames
                                                  for s in b.imagesets]
    assert [(g.cell_length_in_meters, g.feature_id_to_position)
            for g in a.known_geometries] == [
        (g.cell_length_in_meters, g.feature_id_to_position)
        for g in b.known_geometries]


def test_golden_dataset_bin_bit_for_bit(tmp_path):
    p = tmp_path / "golden.bin"
    p.write_bytes(_golden_dataset_bytes())
    ds = tbin.load_dataset(p)
    assert isinstance(ds, tds.Dataset)
    _same_dataset(ds, jbin.load_dataset(p))
    q = tmp_path / "rewritten.bin"
    tbin.save_dataset(q, ds)
    assert q.read_bytes() == _golden_dataset_bytes()


@pytest.fixture(scope="module")
def small_dataset():
    ds, _, _ = problems.make_calibration_dataset(seed=5, n_imagesets=4, k=6)
    return ds


def test_dataset_bin_crosses_both_packages(tmp_path, small_dataset):
    a, b = tmp_path / "port.bin", tmp_path / "ref.bin"
    tbin.save_dataset(a, small_dataset)
    ref = jbin.load_dataset(a)
    jbin.save_dataset(b, ref)
    assert a.read_bytes() == b.read_bytes()
    _same_dataset(tbin.load_dataset(b), ref)


def test_load_datasets_merges_like_the_reference(tmp_path, small_dataset):
    paths = []
    for i in range(2):
        p = tmp_path / f"d{i}.bin"
        tbin.save_dataset(p, small_dataset)
        paths.append(str(p))
    joined = ",".join(paths)
    merged = tbin.load_datasets(joined)
    _same_dataset(merged, jbin.load_datasets(joined))
    assert len(merged.imagesets) == 2 * len(small_dataset.imagesets)
    assert len(merged.known_geometries) == 2
    bad = dataclasses.replace(small_dataset, image_sizes=[(1, 1)])
    with pytest.raises(ValueError):
        merged.merge(bad)


def _ref_dataset(ds):
    return jds.Dataset(
        num_cameras=ds.num_cameras, image_sizes=list(ds.image_sizes),
        imagesets=[jds.Imageset(features=[
            [jds.PointFeature(xy=np.asarray(f.xy), feature_id=f.feature_id)
             for f in feats] for feats in s.features])
            for s in ds.imagesets],
        known_geometries=[jds.KnownGeometry(g.cell_length_in_meters,
                                            dict(g.feature_id_to_position))
                          for g in ds.known_geometries])


def _same_table(got, ref):
    for name in ("imageset", "camera", "point", "pixel", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


@pytest.mark.parametrize("image_used", [None, [True, False, True]])
def test_observation_tables_match_the_reference(small_dataset, image_used):
    # drop a geometry entry, so one feature id is not in the map
    fid = {i: i for i in range(35)}
    ref_ds = _ref_dataset(small_dataset)
    tables = tds.build_per_camera_tables(small_dataset, fid,
                                         image_used=image_used, device="cpu")
    ref = jds.build_per_camera_tables(ref_ds, fid, image_used=image_used)
    assert len(tables) == len(ref) == 1
    _same_table(tables[0], ref[0])
    flat = tds.build_observation_table(small_dataset, fid, pad_to=200,
                                       device="cpu")
    _same_table(flat, jds.build_observation_table(ref_ds, fid, pad_to=200))
    assert tables[0].pixel.dtype == torch.float64


@pytest.mark.parametrize("family", ["central", "noncentral", "parametric"])
def test_state_io_writes_the_reference_files(tmp_path, family):
    rng = np.random.default_rng(11)
    if family == "parametric":
        from test_parametric import _tpf_model
        ref_model = _tpf_model(True)
    else:
        grid = rng.normal(0, 1, (5, 7, 3))
        grid /= np.linalg.norm(grid, axis=-1, keepdims=True)
        from camera_calibration_tpu.models import central_generic as jcg
        from camera_calibration_tpu.models import noncentral_generic as jncg
        ref_model = jcg.CentralGenericModel(
            grid=grid, width=320, height=240, calibration_min_x=3,
            calibration_min_y=4, calibration_max_x=310,
            calibration_max_y=230)
        if family == "noncentral":
            ref_model = jncg.NoncentralGenericModel(
                direction_grid=grid, point_grid=rng.normal(0, 0.01, (5, 7, 3)),
                width=320, height=240, calibration_min_x=3,
                calibration_min_y=4, calibration_max_x=310,
                calibration_max_y=230)
    m, p = 4, 9
    q = rng.normal(0, 1, (m, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    arrays = dict(rig_q_global=q, rig_t_global=rng.normal(0, 1, (m, 3)),
                  cam_q_rig=np.array([[1.0, 0, 0, 0]]),
                  cam_t_rig=np.zeros((1, 3)),
                  points=rng.normal(0, 1, (p, 3)))
    used = [True, False, True, True]
    fid = {10 + i: i for i in range(p)}
    state = convert.ba_state(dict(arrays, intrinsics=(ref_model,)),
                             device="cpu")
    from camera_calibration_tpu.ba.state import BAState as JState
    jstate = JState(**arrays, intrinsics=(ref_model,))
    tio.save_ba_state(tmp_path / "port", state, used, fid)
    jio.save_ba_state(tmp_path / "ref", jstate, used, fid)
    for name in FILES:
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "ref" / name,
                           shallow=False), name

    back, used_back, fid_back = tio.load_ba_state(tmp_path / "port",
                                                  device="cpu")
    ref_back, _, _ = jio.load_ba_state(tmp_path / "port")
    assert used_back == used and fid_back == fid
    for name in arrays:
        np.testing.assert_array_equal(getattr(back, name).numpy(),
                                      np.asarray(getattr(ref_back, name)))
        np.testing.assert_allclose(getattr(back, name)[
            np.asarray(used) if name.startswith("rig") else slice(None)
        ].numpy(), arrays[name][
            np.asarray(used) if name.startswith("rig") else slice(None)],
            rtol=1e-13, atol=1e-13)
    got_m, ref_m = back.intrinsics[0], ref_back.intrinsics[0]
    assert type(got_m).__name__ == type(ref_m).__name__
    for f in dataclasses.fields(got_m):
        a, b = getattr(got_m, f.name), getattr(ref_m, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            assert a == b, f.name

"""Port parity: NoncentralGeneric initialization from scratch.

The reference package and the port run ``NoncentralDenseInitializer.run``
on the same features: the port's ``problems.make_noncentral_calibration_
dataset`` (the cross-slit camera and draws of the reference's
``tests/test_noncentral_init.py``; held to that file's dataset first),
320×240, 6 views, dataset seed 5, initializer seed 6, with that test's
options.  Both packages' bootstrap polish (``_polish_bootstrap``, L-BFGS
over the common pixels of a triple) runs on 300 pixels in place of 2,500,
the same change on both sides, so that the two whole runs fit this file's
time (the reference's polish of 2,500 pixels takes ~12 s per candidate).

Held against each other:

- the bootstrap: the same triple and poses (observed bit-identical: the
  stage is the same NumPy code on the same densified matches);
- the whole run: the same ``image_used``; poses to 1e-8 (observed
  ~5e-10: the P3P polish of each localization runs in PyTorch, and the
  alternating refinement carries its last-bit differences); the point
  statistics to 1e-9 relative, the counts identical; the line fields'
  centroid to 1e-9, anchors to 1e-8 and directions to 1e-7 (observed
  4.0e-9 and 3.1e-8: a pixel's line is the principal axis of two or three
  points that may lie a centimetre apart, so the points' ~1e-10 gap grows
  there; on the same statistics the two ``line_field()`` agree to 1e-12,
  below);
- ``line_field()``, ``observation_directions()`` and
  ``_field_handedness`` on the same accumulated statistics to 1e-12;
- ``localize_image`` (P3P seed, point-to-line Gauss–Newton) and one round
  of ``alternating_refinement`` from the same state, to 1e-8;
- the ``.npz`` cache: each package loads the other's file.

- ``build_ba_state(model_kind="noncentral_generic")`` at a 5×5 grid from
  the reference's result of the whole run, in both packages: the poses and
  points to 1e-8 relative and the observation tables identical.  The grids
  come from capped-CG LM fits (the direction grid as a central fit, the
  origin grid to the line anchors) that the reference's own run moves by
  ~1e-4 under a 1e-14 relative change of its input, so, as in
  ``tests/test_torch_init.py``, both grids are held to twice that change,
  measured here and asserted above 1e-9 (observed at this input:
  directions 2.4e-5 against 6.7e-5, origins 9.8e-5 against 4.6e-4).

The module runs with one intra-op thread (``tests/torch_threads.py``).
"""

import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

from camera_calibration_torch import problems
from camera_calibration_torch.init import dense_init as tdi
from camera_calibration_torch.init import noncentral_init as tni
from camera_calibration_torch.init import state_init as tsi
from camera_calibration_torch.models.noncentral_generic import (
    NoncentralGenericModel)
from camera_calibration_tpu.ba import dataset as jds
from camera_calibration_tpu.init import dense_init as jdi
from camera_calibration_tpu.init import noncentral_init as jni
from camera_calibration_tpu.init import state_init as jsi
from torch_threads import one_torch_thread  # noqa: F401

DATASET = dict(seed=5, n_imagesets=6)
OPTIONS = dict(max_initialization_attempts=80, seed=6,
               min_matched_area_accept=0.2)
POLISH_POINTS = 300


def _reference_dataset(ds):
    """The reference package's Dataset holding the same features."""
    return jds.Dataset(
        num_cameras=ds.num_cameras, image_sizes=list(ds.image_sizes),
        imagesets=[jds.Imageset(features=[[
            jds.PointFeature(xy=np.asarray(f.xy), feature_id=f.feature_id)
            for f in s.features[0]]]) for s in ds.imagesets],
        known_geometries=[jds.KnownGeometry(
            cell_length_in_meters=g.cell_length_in_meters,
            feature_id_to_position=dict(g.feature_id_to_position))
            for g in ds.known_geometries])


@pytest.fixture(scope="module")
def datasets():
    ds = problems.make_noncentral_calibration_dataset(**DATASET)[0]
    return ds, _reference_dataset(ds)


@pytest.fixture(scope="module")
def runs(datasets):
    """Both packages' whole runs (bootstrap polish on POLISH_POINTS
    pixels), with the state right after the bootstrap."""
    boot = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (tni, jni):
            cls = mod.NoncentralDenseInitializer
            mp.setattr(cls, "_polish_bootstrap", functools.partialmethod(
                cls._polish_bootstrap, max_points=POLISH_POINTS))
            original = cls.attempt_bootstrap

            def attempt(self, _original=original):
                ok = _original(self)
                boot[type(self).__module__] = (
                    ok, copy.deepcopy(self.image_tr_global),
                    self.point_sum.copy(), self.point_count.copy())
                return ok

            mp.setattr(cls, "attempt_bootstrap", attempt)
        ds_t, ds_j = datasets
        res_j = jni.NoncentralDenseInitializer(
            ds_j, 0, jdi.DenseInitOptions(**OPTIONS)).run()
        res_t = tni.NoncentralDenseInitializer(
            ds_t, 0, tdi.DenseInitOptions(**OPTIONS)).run()
    return res_j, res_t, boot[jni.__name__], boot[tni.__name__]


def _pose_gap(a, b):
    gap = 0.0
    for pa, pb in zip(a, b):
        assert (pa is None) == (pb is None)
        if pa is not None:
            gap = max(gap, np.abs(pa[0] - pb[0]).max(),
                      np.abs(pa[1] - pb[1]).max())
    return gap


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def test_dataset_matches_reference():
    """The port's dataset is the reference test's (seed 1, its first
    three views)."""
    import test_noncentral_init as ref

    ds_j, _, poses_j = ref._make_dataset(seed=1, n_imagesets=3)
    ds_t, _, poses_t = problems.make_noncentral_calibration_dataset(
        seed=1, n_imagesets=3)
    for sj, st in zip(ds_j.imagesets, ds_t.imagesets):
        fj, ft = sj.features[0], st.features[0]
        assert [f.feature_id for f in fj] == [f.feature_id for f in ft]
        assert max(np.abs(np.asarray(a.xy) - np.asarray(b.xy)).max()
                   for a, b in zip(fj, ft)) < 1e-9
    assert _pose_gap(poses_j, poses_t) == 0.0


def test_bootstrap_matches_reference(runs):
    _, _, (ok_j, poses_j, sum_j, cnt_j), (ok_t, poses_t, sum_t, cnt_t) = runs
    assert ok_j and ok_t
    assert _pose_gap(poses_j, poses_t) <= 1e-12
    assert _rel(sum_j, sum_t) <= 1e-12
    assert np.array_equal(cnt_j, cnt_t)


def test_run_matches_reference(runs):
    res_j, res_t, _, _ = runs
    assert res_j is not None and res_t is not None
    assert res_t.image_used == res_j.image_used
    assert sum(res_t.image_used) == DATASET["n_imagesets"]
    assert _pose_gap(res_j.image_tr_global, res_t.image_tr_global) <= 1e-8
    assert _rel(res_j.point_sum, res_t.point_sum) <= 1e-9
    assert _rel(res_j.point_sq_sum, res_t.point_sq_sum) <= 1e-9
    assert np.array_equal(res_j.point_count, res_t.point_count)
    dj, aj, vj, cj = res_j.line_field()
    dt, at, vt, ct = res_t.line_field()
    assert np.array_equal(vj, vt)
    assert np.abs(dj[vj] - dt[vt]).max() <= 1e-7
    assert np.abs(aj[vj] - at[vt]).max() <= 1e-8
    assert np.abs(cj - ct).max() <= 1e-9


def _port_result(res_j):
    """The reference's result as the port's class, same arrays."""
    return tni.NoncentralInitResult(**{
        f.name: copy.deepcopy(getattr(res_j, f.name))
        for f in dataclasses.fields(tni.NoncentralInitResult)})


def test_line_field_on_the_same_statistics(runs):
    res_j, _, _, _ = runs
    res_t = _port_result(res_j)
    for a, b in zip(res_j.line_field(), res_t.line_field()):
        assert np.array_equal(np.isnan(a), np.isnan(b))
        assert np.nanmax(np.abs(np.asarray(a, float) - np.asarray(b, float))) \
            <= 1e-12
    for a, b in zip(res_j.observation_directions(),
                    res_t.observation_directions()):
        assert np.nanmax(np.abs(np.asarray(a, float) - np.asarray(b, float))) \
            <= 1e-12
    dirs, _, valid, _ = res_j.line_field()
    assert abs(tni._field_handedness(dirs, valid)
               - jni._field_handedness(dirs, valid)) <= 1e-12


def _seeded(mod, ds, res_j):
    """An initializer of ``mod`` holding the reference's final state."""
    init = mod.NoncentralDenseInitializer(
        ds, 0, mod.di.DenseInitOptions(**OPTIONS))
    for name in ("point_sum", "point_sq_sum", "point_count"):
        setattr(init, name, getattr(res_j, name).copy())
    init.image_used = list(res_j.image_used)
    init.image_tr_global = copy.deepcopy(res_j.image_tr_global)
    init.global_tr_known_geometry = copy.deepcopy(
        res_j.global_tr_known_geometry)
    return init


def test_localize_and_refine_from_the_same_state(datasets, runs):
    """``localize_image`` by the P3P seed on every view, and one round of
    ``alternating_refinement``, from the reference's final state."""
    ds_t, ds_j = datasets
    res_j = runs[0]
    init_j = _seeded(jni, ds_j, res_j)
    init_t = _seeded(tni, ds_t, res_j)
    field = init_j.line_field_cached()
    for si in range(len(ds_t.imagesets)):
        pj = init_j.localize_image(si, field=field)
        pt = init_t.localize_image(si, field=field)
        assert (pj is None) == (pt is None), si
        if pj is not None:
            assert _pose_gap([pj], [pt]) <= 1e-8, si
    init_j.alternating_refinement(rounds=1)
    init_t.alternating_refinement(rounds=1)
    assert _pose_gap(init_j.image_tr_global, init_t.image_tr_global) <= 1e-8
    assert _rel(init_j.point_sum, init_t.point_sum) <= 1e-9
    assert np.array_equal(init_j.point_count, init_t.point_count)


def test_dense_init_cache_round_trip(runs, tmp_path):
    """Each package loads the other's ``.npz`` of a noncentral result."""
    res_j, res_t, _, _ = runs
    tdi.save_dense_init(tmp_path / "port.npz", [res_t, None])
    jdi.save_dense_init(tmp_path / "ref.npz", [res_j, None])
    for path, res in ((tmp_path / "port.npz", res_t),
                      (tmp_path / "ref.npz", res_j)):
        for load, cls in ((tdi.load_dense_init, tni.NoncentralInitResult),
                          (jdi.load_dense_init, jni.NoncentralInitResult)):
            got, none = load(str(path))
            assert none is None and isinstance(got, cls)
            for name in ("point_sum", "point_sq_sum", "point_count"):
                assert np.array_equal(getattr(got, name), getattr(res, name))
            assert got.image_used == res.image_used
            assert _pose_gap(got.image_tr_global, res.image_tr_global) == 0
            assert tuple(got.buffer_size) == tuple(res.buffer_size)


def test_build_ba_state_noncentral(datasets, runs):
    grid = (5, 5)
    ds_t, ds_j = datasets
    result = runs[0]
    sj, dj, fj, uj = jsi.build_ba_state(
        ds_j, [result], grid, model_kind="noncentral_generic")
    st, dt, ft, ut = tsi.build_ba_state(
        ds_t, [_port_result(result)], grid, model_kind="noncentral_generic",
        device="cpu")
    nudged = dataclasses.replace(result,
                                 point_sum=result.point_sum * (1 + 1e-14))
    mn = jsi.fit_initial_model_noncentral(nudged, grid)
    assert fj == ft and uj == ut
    for name in ("rig_q_global", "rig_t_global", "cam_q_rig", "cam_t_rig",
                 "points"):
        assert _rel(np.asarray(getattr(sj, name)),
                    getattr(st, name).numpy()) <= 1e-8, name
    mj, mt = sj.intrinsics[0], st.intrinsics[0]
    assert isinstance(mt, NoncentralGenericModel)
    for name in ("direction_grid", "point_grid"):
        ref = np.asarray(getattr(mj, name))
        spread = np.abs(np.asarray(getattr(mn, name)) - ref).max()
        assert spread > 1e-9, name
        assert np.abs(getattr(mt, name).numpy() - ref).max() <= 2 * spread, \
            name
    for tj, tt in zip(dj, dt):
        for name in ("imageset", "camera", "point", "pixel", "valid"):
            assert np.array_equal(np.asarray(getattr(tj, name)),
                                  getattr(tt, name).numpy()), name

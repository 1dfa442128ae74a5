"""Port parity: the calibration pipeline from a feature dataset.

The reference package (its XLA path on the CPU) and the port on the CPU run
the whole pipeline of ``tests/test_e2e.py`` in float64 — the feature dataset
(10 views of a 12×12 board by a 320×240 pinhole camera), ``DenseInitializer``,
``build_ba_state`` and ``calibrate`` with a 2-level pyramid — once each, in
a module fixture that records every BA stage.  Held against each other:

- the dense initialization: the same localized imagesets, poses to 1e-8;
  the initial grid's directions to twice the spread of the reference's
  own fit under a 1e-14 relative change of its input (measured in the
  test: 2.0e-5 rad, against a gap of 1.4e-5 rad);
- every BA stage: the same LM iteration and accepted-iteration counts; the
  outlier count; the final cost to 1e-6 relative, the reprojection-error
  median to 1e-6 px and the metric scale factor to 1e-6;
- ``observation_reprojection_errors``, ``delete_outlier_features`` (with
  injected outliers: the same count and the same masks),
  ``scale_to_metric``, the grid resolutions and both grid resamples on the
  same inputs, to 1e-9 or exactly;
- ``polish_float64`` from a float32 state: a float64 CPU state at the
  float64 pipeline's final cost (1e-3 relative); ``convert_model`` (central to noncentral) reproduces its
  source's directions.

The module runs with one intra-op thread (``tests/torch_threads.py``).

Also: a CPU check that at the grid of a 2448×2048 camera at 25 px per cell
the ``project_blocks`` kernel's plan reads its fields from device memory
(they are past one block's shared memory), and stages them at 1080p.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camera_calibration_torch import _cuda
from camera_calibration_torch import calibrate as tcal
from camera_calibration_torch.ba import window_cuda as wc
from camera_calibration_torch.init.state_init import build_ba_state as tbuild
from camera_calibration_torch.models import central_generic_cuda as cgc
from camera_calibration_tpu import calibrate as jcal
from camera_calibration_tpu.ba import dataset as jds
from camera_calibration_tpu.ba.state import BAState as JState
from camera_calibration_tpu.init import state_init as jsi
from camera_calibration_tpu.models import central_generic as jcg
from camera_calibration_tpu.models import noncentral_generic as jncg
import torch_e2e_init
from torch_threads import one_torch_thread  # noqa: F401

OPTIONS = dict(num_pyramid_levels=2, approx_pixels_per_cell=40,
               outlier_removal_factor=8.0, final_iterations=30,
               pyramid_iterations=(8, 25))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _directions(model, step=7):
    """A grid model's unit directions on a pixel lattice, as NumPy."""
    from camera_calibration_torch.models import central_generic as tcg
    xs = np.arange(2, model.width - 2, step) + 0.5
    ys = np.arange(2, model.height - 2, step) + 0.5
    px = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    probe = tcg.CentralGenericModel(
        grid=torch.as_tensor(np.array(_np(model.grid))), width=model.width,
        height=model.height, calibration_min_x=model.calibration_min_x,
        calibration_min_y=model.calibration_min_y,
        calibration_max_x=model.calibration_max_x,
        calibration_max_y=model.calibration_max_y)
    return tcg.unproject(probe, torch.as_tensor(px))[0].numpy()


def _run(pkg, dense_init, build, **build_kw):
    """One package's whole pipeline from its dense initialization of the
    e2e dataset; every run_ba call recorded."""
    ds, result = dense_init()
    state0, data0, fid, used = build(ds, [result], (6, 6), **build_kw)
    stages = []
    run_ba = pkg.run_ba

    def recorded(state, data_, max_iterations, threshold, options, **kw):
        out = run_ba(state, data_, max_iterations, threshold, options, **kw)
        rep = out[1]["report"]
        stages.append((max_iterations, threshold, rep.iterations,
                       rep.accepted, out[1]["final_cost"]))
        return out

    pkg.run_ba = recorded
    try:
        state, data, report = pkg.calibrate(
            state0, data0, pkg.CalibrateOptions(**OPTIONS),
            known_geometries=ds.known_geometries,
            feature_id_to_point_index=fid, log=lambda *a: None)
    finally:
        pkg.run_ba = run_ba
    return dict(ds=ds, result=result, state0=state0, data0=data0,
                state=state, data=data, report=report, stages=stages,
                fid=fid, used=used)


@pytest.fixture(scope="module")
def pipelines():
    ref = _run(jcal, torch_e2e_init.reference, jsi.build_ba_state)
    got = _run(tcal, torch_e2e_init.port, tbuild, device="cpu")
    return got, ref


def _initial_fit_spread(result, ref_model):
    """How far the reference package's own initial grid fit moves, in its
    directions on the pixel lattice, when the dense direction sums change
    by ±1e-14 relative."""
    base = _directions(ref_model)
    return max(
        np.abs(_directions(jsi.fit_initial_model(dataclasses.replace(
            result, direction_sum=result.direction_sum * (1.0 + eps)),
            (6, 6))) - base).max()
        for eps in (1e-14, -1e-14))


def test_pipeline_dense_initialization_and_state(pipelines):
    """The dense initialization and the initial CentralGeneric state.

    The initial grid (25 LM iterations of the capped-CG grid fit) is not
    determined to 1e-9 by its input: the reference's own fitted
    directions move by about 2e-5 rad when the direction sums change by
    1e-14 relative.  The check measures that spread and holds the port's
    directions to twice it."""
    got, ref = pipelines
    assert got["result"].image_used == ref["result"].image_used
    assert got["result"].buffer_size == (320, 240)
    assert got["used"] == ref["used"] and sum(got["used"]) >= 8
    assert got["fid"] == ref["fid"]
    for pg, pr in zip(got["result"].image_tr_global,
                      ref["result"].image_tr_global):
        if pr is not None:
            np.testing.assert_allclose(pg[0], pr[0], rtol=0, atol=1e-8)
            np.testing.assert_allclose(pg[1], pr[1], rtol=0, atol=1e-8)
    st, js = got["state0"], ref["state0"]
    assert st.points.dtype == torch.float64 and st.points.device.type == "cpu"
    np.testing.assert_allclose(_np(st.rig_q_global), _np(js.rig_q_global),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(st.rig_t_global), _np(js.rig_t_global),
                               rtol=0, atol=1e-8)
    np.testing.assert_array_equal(_np(st.points), _np(js.points))
    model, ref_model = st.intrinsics[0], js.intrinsics[0]
    assert model.grid.shape == (6, 6, 3) and model.grid.is_contiguous()
    assert (model.width, model.calibration_max_x) == (320, 319)
    spread = _initial_fit_spread(ref["result"], ref_model)
    assert spread > 1e-9, spread
    gap = np.abs(_directions(model) - _directions(ref_model)).max()
    assert gap <= 2.0 * spread, (gap, spread)
    table, ref_table = got["data0"][0], ref["data0"][0]
    for name in ("imageset", "camera", "point", "pixel", "valid"):
        np.testing.assert_array_equal(_np(getattr(table, name)),
                                      _np(getattr(ref_table, name)))


def test_pipeline_stages_and_report(pipelines):
    got, ref = pipelines
    assert len(got["stages"]) == len(ref["stages"]) == 4
    for g, r in zip(got["stages"], ref["stages"]):
        assert g[:4] == r[:4], (got["stages"], ref["stages"])
    rg, rr = got["report"], ref["report"]
    assert rg["outliers_removed"] == rr["outliers_removed"]
    assert abs(rg["final_cost"] - rr["final_cost"]) <= 1e-6 * rr["final_cost"]
    assert abs(rg["reprojection_error_median"]
               - rr["reprojection_error_median"]) <= 1e-6
    assert rg["reprojection_error_median"] < 0.02, rg
    assert abs(rg["scale_factor"] - rr["scale_factor"]) <= 1e-6
    assert abs(rg["scale_factor"] - 1.0) < 0.05
    assert rg["solver"]["accepted"] == rr["solver"]["accepted"]
    # the final grid: compute_grid_resolution(320, 240, 40) = (10, 8)
    assert got["state"].intrinsics[0].grid.shape == (8, 10, 3)
    assert got["state"].intrinsics[0].grid.is_contiguous()


def _ref_state(state):
    """The port's (CPU) state as the reference package's."""
    m = state.intrinsics[0]
    model = jcg.CentralGenericModel(
        grid=jnp.asarray(_np(m.grid)), width=m.width, height=m.height,
        calibration_min_x=m.calibration_min_x,
        calibration_min_y=m.calibration_min_y,
        calibration_max_x=m.calibration_max_x,
        calibration_max_y=m.calibration_max_y)
    return JState(**{f: jnp.asarray(_np(getattr(state, f))) for f in (
        "rig_q_global", "rig_t_global", "cam_q_rig", "cam_t_rig", "points")},
        intrinsics=(model,))


def _ref_tables(data):
    return tuple(jds.ObservationTable(
        imageset=jnp.asarray(_np(s.imageset).astype(np.int32)),
        camera=jnp.asarray(_np(s.camera).astype(np.int32)),
        point=jnp.asarray(_np(s.point).astype(np.int32)),
        pixel=jnp.asarray(_np(s.pixel)), valid=jnp.asarray(_np(s.valid)))
        for s in data)


def test_reprojection_errors_and_outliers(pipelines):
    got, _ = pipelines
    state, data = got["state"], got["data"]
    seg = data[0]
    pixel = seg.pixel.clone()
    rows = torch.nonzero(seg.valid)[::37, 0][:6]
    pixel[rows] += torch.tensor([4.0, -3.0], dtype=pixel.dtype)
    data = (dataclasses.replace(seg, pixel=pixel),)
    errs = tcal.observation_reprojection_errors(state, data)
    ref_errs = jcal.observation_reprojection_errors(_ref_state(state),
                                                    _ref_tables(data))
    e, r = _np(errs[0]), _np(ref_errs[0])
    np.testing.assert_array_equal(np.isfinite(e), np.isfinite(r))
    np.testing.assert_allclose(e[np.isfinite(e)], r[np.isfinite(r)],
                               rtol=0, atol=1e-9)
    new, removed = tcal.delete_outlier_features(state, data, 8.0)
    ref_new, ref_removed = jcal.delete_outlier_features(
        _ref_state(state), _ref_tables(data), 8.0)
    assert removed == ref_removed >= len(rows)
    np.testing.assert_array_equal(_np(new[0].valid), _np(ref_new[0].valid))
    assert not bool(new[0].valid[rows].any())


def test_scale_to_metric(pipelines):
    got, _ = pipelines
    state = tcal.scale_state(got["state"], 1.25)
    out, factor = tcal.scale_to_metric(state, got["ds"].known_geometries,
                                       got["fid"])
    ref_out, ref_factor = jcal.scale_to_metric(
        _ref_state(state), got["ds"].known_geometries, got["fid"])
    assert abs(factor - ref_factor) <= 1e-12 and abs(factor - 0.8) < 0.05
    np.testing.assert_allclose(_np(out.points), _np(ref_out.points),
                               rtol=1e-12, atol=0)
    assert out.points.dtype == state.points.dtype


def test_polish_float64_from_float32(pipelines):
    """The polish moves a float32 state and its tables to the CPU in
    float64, lowers the paired cost on every accepted step and returns to
    the float64 pipeline's optimum."""
    got, _ = pipelines
    options = tcal.CalibrateOptions(**dict(OPTIONS, polish_iterations=6))
    state32 = tcal.cast_floating(got["state"], torch.float32)
    data32 = tcal.cast_floating(got["data"], torch.float32)
    out, data64, info = tcal.polish_float64(state32, data32, options,
                                            log=lambda *a: None)
    assert out.points.dtype == torch.float64
    assert out.points.device.type == "cpu"
    assert out.intrinsics[0].grid.dtype == torch.float64
    assert data64[0].pixel.dtype == torch.float64
    assert data64[0].valid.dtype == torch.bool
    np.testing.assert_array_equal(_np(data64[0].valid), _np(data32[0].valid))
    hist = info["history"]
    assert 1 <= len(hist) <= 6
    assert all(h["paired_new_cost"] < h["paired_cost"] for h in hist
               if h["accepted"])
    # back at the float64 pipeline's optimum
    final = got["report"]["final_cost"]
    assert abs(info["final_cost"] - final) <= 1e-3 * final


@pytest.mark.parametrize("size", [(320, 240), (640, 480), (1920, 1080),
                                  (2448, 2048)])
def test_grid_resolutions(size):
    full = tcal.compute_grid_resolution(*size, 25)
    assert full == jcal.compute_grid_resolution(*size, 25)
    for level in range(3):
        assert tcal.grid_resolution_for_level(level, *full) == \
            jcal.grid_resolution_for_level(level, *full)
    if size == (1920, 1080):
        assert full == (79, 45)
        assert [tcal.grid_resolution_for_level(lv, *full)
                for lv in (2, 1)] == [(44, 25), (59, 34)]


def test_project_blocks_grid_limit_at_5mp():
    """The 2448×2048 pipeline grid at 25 px per cell (100×84 knots) would
    need more shared memory per block than a Hopper block has to stage the
    grid and both frame fields: the plan picks the kernel that reads them
    from device memory there, and the staged one at the 1080p grid (45×79).
    ``window_apply_j`` reads its tangent through L1 at every grid: the K=5
    tangent at 108×108 (233,280 B) as the one at 45×79."""
    gw, gh = tcal.compute_grid_resolution(2448, 2048, 25)
    assert (gw, gh) == (100, 84)
    assert cgc.staged_bytes(gh, gw, blocks=True) == 302_400
    assert cgc.staged_bytes(gh, gw, blocks=True) > _cuda.MAX_SMEM_BYTES
    assert not cgc.project_staged(gh, gw, blocks=True)
    assert cgc.project_smem_bytes(gh, gw, blocks=True) == 0
    assert cgc.project_staged(gh, gw)  # project alone: 100,800 B
    assert cgc.project_staged(45, 79, blocks=True)
    assert cgc.project_smem_bytes(45, 79, blocks=True) == 127_980
    # window_apply_j stages no tangent: its plan takes no grid size, so
    # 108x108 launches as 45x79 does, one block per 64 observations
    assert wc.apply_j_blocks(262_144) == 4_096
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.check_smem(cgc.staged_bytes(gh, gw, blocks=True),
                         "project_blocks")


@pytest.mark.parametrize("family", ["central", "noncentral"])
def test_grid_resample_matches_the_reference(family):
    rng = np.random.default_rng(3)
    gh, gw = 9, 11
    yy, xx = np.meshgrid(np.linspace(-0.5, 0.5, gh),
                         np.linspace(-0.6, 0.6, gw), indexing="ij")
    dirs = np.stack([np.sin(xx), np.sin(yy), np.cos(xx) * np.cos(yy)], -1)
    dirs += rng.normal(0, 1e-3, dirs.shape)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    bounds = dict(width=320, height=240, calibration_min_x=0,
                  calibration_min_y=0, calibration_max_x=319,
                  calibration_max_y=239)
    from camera_calibration_torch.models import central_generic as tcg
    from camera_calibration_torch.models import noncentral_generic as tncg
    if family == "central":
        got = tcal.resample_grid_model(
            tcg.CentralGenericModel(grid=torch.as_tensor(dirs), **bounds),
            (15, 12))
        ref = jcal.resample_grid_model(
            jcg.CentralGenericModel(grid=jnp.asarray(dirs), **bounds),
            (15, 12))
        pairs = ((got.grid, ref.grid),)
    else:
        origins = rng.normal(0, 0.01, dirs.shape)
        got = tcal.resample_grid_model(tncg.NoncentralGenericModel(
            direction_grid=torch.as_tensor(dirs),
            point_grid=torch.as_tensor(origins), **bounds), (15, 12))
        ref = jcal.resample_grid_model(jncg.NoncentralGenericModel(
            direction_grid=jnp.asarray(dirs),
            point_grid=jnp.asarray(origins), **bounds), (15, 12))
        pairs = ((got.direction_grid, ref.direction_grid),
                 (got.point_grid, ref.point_grid))
    for a, b in pairs:
        assert tuple(a.shape) == (12, 15, 3)
        assert a.is_contiguous()  # the kernels take row-major grids
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-12)


def test_resample_models_if_necessary(pipelines):
    got, _ = pipelines
    state = got["state"]
    same = tcal.resample_models_if_necessary(state, "central_generic", 40, 0,
                                             log=lambda *a: None)
    assert same is state
    coarse = tcal.resample_models_if_necessary(state, "central_generic", 40,
                                               1, log=lambda *a: None)
    ref = jcal.resample_models_if_necessary(_ref_state(state),
                                            "central_generic", 40, 1,
                                            log=lambda *a: None)
    np.testing.assert_allclose(_np(coarse.intrinsics[0].grid),
                               _np(ref.intrinsics[0].grid), rtol=0,
                               atol=1e-12)
    assert coarse.intrinsics[0].grid.shape == (6, 8, 3)


def test_convert_central_to_noncentral():
    """convert_model's grid arm: the dense unprojection of a central model
    refitted at another resolution, with zero line origins; the result
    reproduces the source model's directions."""
    rng = np.random.default_rng(4)
    yy, xx = np.meshgrid(np.linspace(-0.5, 0.5, 6), np.linspace(-0.6, 0.6, 7),
                         indexing="ij")
    dirs = np.stack([np.sin(xx), np.sin(yy), np.cos(xx) * np.cos(yy)], -1)
    dirs += rng.normal(0, 1e-3, dirs.shape)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    from camera_calibration_torch.models import central_generic as tcg
    source = tcg.CentralGenericModel(
        grid=torch.as_tensor(dirs), width=48, height=36,
        calibration_min_x=0, calibration_min_y=0, calibration_max_x=47,
        calibration_max_y=35)
    got, q = tcal.convert_model(source, "noncentral_generic", (8, 5))
    assert q is None and tuple(got.direction_grid.shape) == (5, 8, 3)
    assert got.direction_grid.is_contiguous()
    assert not bool(got.point_grid.any())
    assert (got.width, got.calibration_max_y) == (48, 35)
    probe = dataclasses.replace(source, grid=got.direction_grid)
    np.testing.assert_allclose(_directions(probe, 3), _directions(source, 3),
                               rtol=0, atol=1e-3)

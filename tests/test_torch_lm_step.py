"""Port parity for the whole slice: the LM bundle-adjustment step.

On ``__graft_entry__._make_problem(dtype=float64)`` (64×48 image, 7×7
grid, 16 poses, 64 points, grid-layout table) the JAX package's step (its
XLA path on the CPU, jitted) and the port's step on the CPU get the same
state, warm starts, λ and tables:

- one two-pass step (``make_lm_step``), from a fresh λ and from a state
  perturbed so far that the valid set shifts (paired ≠ full cost);
- three cached-blocks steps (``make_lm_scan``), also with CG warm starts,
  the gain-ratio λ schedule and frozen groups;
- ``optimize`` in both step forms, history against history;

for ``solver="schur"`` and ``"schur_poses"``.  ``accept`` and the CG
iteration counts must be identical; costs, λ and the state agree to 1e-9
relative (both run float64; only summation orders differ, and the
observed gap is ~1e-15).

It also checks the port's benchmark problem against ``bench.py``'s, the
observation-table helpers, the options the port took on after the first
slice (``cg_jacobian_dtype="bfloat16"`` and the parametric models since the
third; ``tests/test_torch_bf16.py`` and ``tests/test_torch_parametric*.py``
hold them against the JAX package) and what it still refuses, and that
entry points never drop silently to the CPU.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import bench
from camera_calibration_torch import config, convert, problems
from camera_calibration_torch.ba import lm_pcg as T
from camera_calibration_torch.models import protocol
from camera_calibration_tpu.ba import lm_pcg as J
from torch_threads import one_torch_thread  # noqa: F401

REL = dict(rtol=1e-9, atol=1e-12)
STATE_TOL = dict(rtol=1e-9, atol=1e-10)
SOLVERS = ["schur", "schur_poses"]


@pytest.fixture(scope="module")
def problem():
    state, data = graft._make_problem(dtype=jnp.float64)
    return state, data


def _port(state, data):
    ts = convert.ba_state(state, device="cpu")
    td = tuple(convert.observation_table(s, device="cpu") for s in data)
    return ts, td


def _options(solver, **kw):
    kw = dict(max_pcg_iterations=20, proj_iterations=8, solver=solver, **kw)
    return J.BAOptions(**kw), T.BAOptions(**kw)


def _assert_state(ts, js):
    for name in ("rig_q_global", "rig_t_global", "cam_q_rig", "cam_t_rig",
                 "points"):
        np.testing.assert_allclose(getattr(ts, name), getattr(js, name),
                                   **STATE_TOL, err_msg=name)
    for tm, jm in zip(ts.intrinsics, js.intrinsics):
        np.testing.assert_allclose(tm.grid, jm.grid, **STATE_TOL)


def _assert_step(got, ref):
    """(state, warm, lam, accept, cost, new_cost, pcg_iters, paired_old,
    paired_new) of the port against the JAX step."""
    _assert_state(got[0], ref[0])
    for gw, rw in zip(got[1], ref[1]):
        np.testing.assert_allclose(gw, rw, rtol=0, atol=1e-8)
    assert got[3] == bool(ref[3])
    assert got[6] == int(ref[6])
    for i in (2, 4, 5, 7, 8):
        np.testing.assert_allclose(float(got[i]), float(ref[i]), **REL)


def _perturbed(state, scale):
    rng = np.random.default_rng(5)
    return dataclasses.replace(
        state,
        points=state.points + rng.normal(0, scale, state.points.shape),
        rig_t_global=state.rig_t_global
        + rng.normal(0, scale, state.rig_t_global.shape))


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("scale,lam0", [(0.0, -1.0), (0.1, 1e-9)])
def test_two_pass_step(problem, solver, scale, lam0):
    state, data = problem
    if scale:
        state = _perturbed(state, scale)
    ts, td = _port(state, data)
    oj, ot = _options(solver)
    ref = J.make_lm_step(oj)(state, tuple(s.pixel for s in data),
                             jnp.asarray(lam0), data)
    got = T.make_lm_step(ot)(ts, tuple(s.pixel for s in td),
                             torch.tensor(lam0, dtype=torch.float64), td)
    _assert_step(got, ref)
    assert got[3] and float(got[5]) < float(got[4])
    if scale:  # the valid set shifted: paired and full costs differ
        assert float(got[8]) != pytest.approx(float(got[5]), rel=1e-3)


@pytest.mark.parametrize("solver,extra", [
    ("schur", {}),
    ("schur_poses", {}),
    ("schur", dict(cg_warm_start=True, lambda_schedule="gain_ratio",
                   freeze=("intrinsics", "extrinsics"))),
])
def test_cached_blocks_steps(problem, solver, extra):
    state, data = problem
    ts, td = _port(state, data)
    oj, ot = _options(solver, **extra)
    n = 3
    sj, wj, lj, outs_j = J.make_lm_scan(oj, n)(
        state, tuple(s.pixel for s in data), jnp.asarray(-1.0), data)
    st, wt, lt, outs_t = T.make_lm_scan(ot, n)(
        ts, tuple(s.pixel for s in td), torch.tensor(-1.0, dtype=torch.float64),
        td)
    _assert_state(st, sj)
    for a, b in zip(wt, wj):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(lt), float(lj), **REL)
    accept_j, cost_j, new_j, iters_j, old_pj, new_pj = (np.asarray(o)
                                                       for o in outs_j)
    accept_t, cost_t, new_t, iters_t, old_pt, new_pt = outs_t
    assert list(accept_t) == list(accept_j)
    assert list(iters_t) == [int(i) for i in iters_j]
    for a, b in ((cost_t, cost_j), (new_t, new_j), (old_pt, old_pj),
                 (new_pt, new_pj)):
        np.testing.assert_allclose(np.asarray(a), b, **REL)
    assert all(accept_t) and new_pt[-1] < old_pt[0]
    if "intrinsics" in extra.get("freeze", ()):
        assert torch.equal(st.intrinsics[0].grid, ts.intrinsics[0].grid)


@pytest.mark.parametrize("solver,k", [("schur", 1), ("schur_poses", 3)])
def test_optimize_history(problem, solver, k):
    state, data = problem
    ts, td = _port(state, data)
    oj, ot = _options(solver, max_lm_iterations=5, lm_steps_per_call=k)
    sj, info_j = J.optimize(state, None, None, oj, data=data)
    st, info_t = T.optimize(ts, None, None, ot, data=td)
    hj, ht = info_j["history"], info_t["history"]
    assert len(ht) == len(hj) == 5
    for a, b in zip(ht, hj):
        assert set(a) == set(b)
        for key in ("iteration", "accepted", "pcg_iterations"):
            assert a[key] == b[key], key
        for key in ("cost", "new_cost", "paired_cost", "paired_new_cost",
                    "lambda"):
            np.testing.assert_allclose(a[key], b[key], **REL, err_msg=key)
    _assert_state(st, sj)
    rj, rt = info_j["report"], info_t["report"]
    assert (rt.iterations, rt.accepted, rt.rejected, rt.pcg_iterations_total) \
        == (rj.iterations, rj.accepted, rj.rejected, rj.pcg_iterations_total)
    np.testing.assert_allclose(info_t["final_cost"], info_j["final_cost"], **REL)


def test_optimize_converts_numpy_inputs(problem):
    """A state and tables given as numpy (dicts) go onto the given device
    and give the same run as the port's own objects."""
    state, data = problem
    ts, td = _port(state, data)
    options = T.BAOptions(max_pcg_iterations=10, proj_iterations=6,
                          max_lm_iterations=2)
    fields = ("rig_q_global", "rig_t_global", "cam_q_rig", "cam_t_rig",
              "points")
    np_state = {k: np.asarray(getattr(state, k)) for k in fields}
    np_state["intrinsics"] = [
        dict(grid=np.asarray(m.grid), width=m.width, height=m.height,
             calibration_min_x=m.calibration_min_x,
             calibration_min_y=m.calibration_min_y,
             calibration_max_x=m.calibration_max_x,
             calibration_max_y=m.calibration_max_y)
        for m in state.intrinsics]
    np_data = tuple(
        dict(imageset=np.asarray(s.imageset), camera=np.asarray(s.camera),
             point=np.asarray(s.point), pixel=np.asarray(s.pixel),
             valid=np.asarray(s.valid), grid_shape=s.grid_shape)
        for s in data)
    s1, i1 = T.optimize(np_state, None, None, options, data=np_data,
                        device="cpu")
    s2, i2 = T.optimize(ts, None, None, options, data=td)
    assert i1["history"] == i2["history"]
    assert torch.equal(s1.points, s2.points)
    # one camera-sorted flat table and its segments: re-laid into grid
    # layout by optimize, the same run
    flat = {k: v for k, v in np_data[0].items() if k != "grid_shape"}
    s3, i3 = T.optimize(np_state, flat, ((0, len(flat["valid"])),), options,
                        device="cpu")
    assert i3["history"] == i2["history"]
    assert td[0].grid_shape == data[0].grid_shape
    back = convert.state_to_numpy(s1)
    assert back["points"].shape == np_state["points"].shape


def test_bench_problem_matches_reference():
    """problems.make_bench_problem draws the numpy RNG in bench.py's order:
    identical float32 state; observations from each package's own
    float32 projection agree to 1e-3 px, with at most 2 boundary flips of
    the valid mask in 2048 rows."""
    sj, dj, mj = bench.make_bench_problem(n_points=128, n_poses=16)
    st, dt, mt = problems.make_bench_problem(n_points=128, n_poses=16,
                                             device="cpu")
    for name in ("rig_q_global", "rig_t_global", "cam_q_rig", "cam_t_rig",
                 "points"):
        a, b = getattr(st, name).numpy(), np.asarray(getattr(sj, name))
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(st.intrinsics[0].grid.numpy(),
                                  np.asarray(sj.intrinsics[0].grid))
    seg_t, seg_j = dt[0], dj[0]
    assert seg_t.grid_shape == seg_j.grid_shape == (16, 128)
    for name in ("imageset", "point", "camera"):
        np.testing.assert_array_equal(getattr(seg_t, name).numpy(),
                                      np.asarray(getattr(seg_j, name)))
    vt, vj = seg_t.valid.numpy(), np.asarray(seg_j.valid)
    assert int((vt != vj).sum()) <= 2
    both = vt & vj
    dpx = np.abs(seg_t.pixel.numpy()[both] - np.asarray(seg_j.pixel)[both])
    assert float(dpx.max()) <= 1e-3
    assert abs(mt["n_obs"] - mj["n_obs"]) <= 2 and mt["gres"] == mj["gres"]


def test_observation_tables_match_reference():
    """split_by_camera, pad_table (indices padded with the last entry) and
    to_grid_layout give the JAX package's tables."""
    from camera_calibration_torch.ba import dataset as tds
    from camera_calibration_tpu.ba import dataset as jds

    rng = np.random.default_rng(3)
    m, p, n = 6, 12, 50
    pairs = rng.choice(m * p, n, replace=False)
    cols = dict(imageset=(pairs // p).astype(np.int32),
                camera=np.repeat([0, 1], [30, 20]).astype(np.int32),
                point=(pairs % p).astype(np.int32),
                pixel=rng.uniform(0, 64, (n, 2)),
                valid=rng.uniform(size=n) > 0.2)
    jt = jds.ObservationTable(**{k: jnp.asarray(v) for k, v in cols.items()})
    tt = convert.observation_table(cols, device="cpu")
    segments = ((0, 30), (30, 20))

    def same(a, b):
        for name in ("imageset", "camera", "point", "pixel", "valid"):
            np.testing.assert_array_equal(getattr(a, name).numpy(),
                                          np.asarray(getattr(b, name)),
                                          err_msg=name)
        assert a.grid_shape == b.grid_shape

    for a, b in zip(tds.split_by_camera(tt, segments),
                    jds.split_by_camera(jt, segments)):
        same(a, b)
        same(tds.pad_table(a, 16), jds.pad_table(b, 16))
        same(tds.to_grid_layout(a, m, p), jds.to_grid_layout(b, m, p))


@pytest.mark.parametrize("change", [dict(cg_jacobian_dtype="bfloat16")])
def test_unported_options_raise(problem, change):
    """``cg_jacobian_dtype="bfloat16"`` raised until the third slice: it now
    runs and lowers the paired cost; a dtype the option does not know
    raises."""
    state, data = problem
    ts, td = _port(state, data)
    options = T.BAOptions(max_lm_iterations=1, max_pcg_iterations=20,
                          proj_iterations=8, **change)
    _, info = T.optimize(ts, None, None, options, data=td)
    (h,) = info["history"]
    assert h["accepted"] and h["paired_new_cost"] < h["paired_cost"]
    assert h["pcg_iterations"] > 0
    unknown = dataclasses.replace(options, cg_jacobian_dtype="float16")
    with pytest.raises(ValueError, match="cg_jacobian_dtype"):
        T.optimize(ts, None, None, unknown, data=td)
    with pytest.raises(ValueError, match="cg_jacobian_dtype"):
        T.make_lm_step(unknown)


@pytest.mark.parametrize("change", [
    dict(solver="auto"), dict(solver="pcg"), dict(solver="schur_direct"),
    dict(solver="schur_direct_points"), dict(block_chunk=256),
    dict(debug_verify=True), dict(profile_dir="trace"),
])
def test_options_ported_since_the_first_slice_run(problem, change, tmp_path):
    """The options that raised in the first slice now run: one step lowers
    the paired cost (tests/test_torch_solvers.py holds each against the JAX
    package)."""
    state, data = problem
    ts, td = _port(state, data)
    if "profile_dir" in change:
        change = dict(profile_dir=str(tmp_path / "trace"))
    options = T.BAOptions(max_lm_iterations=1, max_pcg_iterations=20,
                          proj_iterations=8, **change)
    _, info = T.optimize(ts, None, None, options, data=td)
    (h,) = info["history"]
    assert h["accepted"] and h["paired_new_cost"] < h["paired_cost"]
    direct = options.solver in ("auto", "schur_direct", "schur_direct_points")
    assert (h["pcg_iterations"] == 0) == direct
    assert info["report"].as_dict()["iterations"] == 1
    if "profile_dir" in change:
        trace = json.loads((tmp_path / "trace" / "lm_trace.json").read_text())
        # the program's spans ride in the trace as user annotations
        marks = {e["name"] for e in trace["traceEvents"]
                 if e.get("cat") == "user_annotation"}
        assert {"ba.solve", "lm.iter", "lm.solve"} <= marks


def test_frozen_eliminated_group_and_other_models_raise(problem):
    """Freezing the eliminated group runs the full-system PCG (as the JAX
    package does).  The parametric models raised until the third slice: an
    OpenCV camera now optimizes; an object that is no camera model
    raises."""
    state, data = problem
    ts, td = _port(state, data)
    runs = []
    for solver in ("schur", "pcg"):
        options = T.BAOptions(freeze=("points",), max_lm_iterations=1,
                              solver=solver)
        runs.append(T.optimize(ts, None, None, options, data=td))
    assert runs[0][1]["history"] == runs[1][1]["history"]
    assert runs[0][1]["history"][0]["pcg_iterations"] > 0
    assert torch.equal(runs[0][0].points, ts.points)
    assert protocol.is_grid_model(ts.intrinsics[0])
    assert not protocol.is_grid_model(object())
    from camera_calibration_tpu.models import parametric

    pinhole = convert.camera_model(parametric.CentralOpenCVModel(
        params=jnp.asarray([54.4, 54.4, 32.0, 24.0] + [0.0] * 8), width=64,
        height=48), device="cpu")
    assert torch.equal(protocol.intrinsics_tangent_zero(pinhole),
                       torch.zeros(12, dtype=torch.float64))
    _, info = T.optimize(dataclasses.replace(ts, intrinsics=(pinhole,)),
                         None, None, T.BAOptions(max_lm_iterations=1),
                         data=td)
    (h,) = info["history"]
    assert h["accepted"] and h["paired_new_cost"] < h["paired_cost"]
    with pytest.raises(TypeError, match="not a camera model"):
        protocol.intrinsics_tangent_zero(object())
    with pytest.raises(TypeError, match="not a camera model"):
        T.optimize(dataclasses.replace(ts, intrinsics=(object(),)), None,
                   None, T.BAOptions(max_lm_iterations=1), data=td)


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch,
                                                             problem):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        config.default_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        problems.make_bench_problem(n_points=8, n_poses=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        problems.make_parametric_bench_problem("opencv", n_points=8,
                                               n_poses=2)
    state, data = problem
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.ba_state(state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.observation_table(data[0])
    assert config.default_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"

"""Port parity: bundle adjustment of a parametric camera.

On ``tests/ba_harness.make_problem(model_kind="tpf")`` (a ThinPrismFisheye
camera, 12 poses of 64 points, perturbed by ``ba_harness.perturb_state``,
the table in grid layout) the JAX package (its XLA path on the CPU) and
the port on the CPU get the same state, warm starts, λ and tables, in
float64: one two-pass step, two cached-blocks steps and 8-iteration
``optimize`` histories in every solver mode, ``block_chunk`` and ``auto``.
``accept`` and the CG iteration counts must be identical; costs, λ and the
state agree to 1e-9 relative (the observed gap is 6e-10 or less: the
costs fall to 1e-6 of their start, where only summation orders differ).

It also checks the conversion of parametric models to and from numpy and
the parametric twins of the benchmark problem at a cut size.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ba_harness
from camera_calibration_torch import convert, problems
from camera_calibration_torch.ba import lm_pcg as T
from camera_calibration_torch.models import parametric as tpm
from camera_calibration_tpu.ba import lm_pcg as J
from camera_calibration_tpu.ba.dataset import split_by_camera, to_grid_layout
from test_parametric import _opencv_model, _radial_model, _tpf_model
from torch_threads import one_torch_thread  # noqa: F401

REL = dict(rtol=1e-9, atol=1e-12)
STATE_TOL = dict(rtol=1e-9, atol=1e-10)
SOLVERS = ["schur", "schur_poses", "pcg", "schur_direct",
           "schur_direct_points"]


def _close(got, ref, tol=REL, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **tol,
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def tpf_problem():
    """``ba_harness``'s ThinPrismFisheye problem (12 poses of 64 points),
    perturbed, its table in (poses × points) grid layout (the direct
    solvers' layout)."""
    m, p = 12, 64
    gt, obs, segs = ba_harness.make_problem(model_kind="tpf", n_points=p,
                                            n_poses=m)
    state = ba_harness.perturb_state(gt, seed=1)
    data = tuple(to_grid_layout(s, m, p) for s in split_by_camera(obs, segs))
    ts = convert.ba_state(state, device="cpu")
    td = tuple(convert.observation_table(s, device="cpu") for s in data)
    return state, data, ts, td


def _options(solver, **kw):
    kw = dict(dict(max_pcg_iterations=20, proj_iterations=8, solver=solver),
              **kw)
    return J.BAOptions(**kw), T.BAOptions(**kw)


def _assert_state(ts, js):
    for name in ("rig_q_global", "rig_t_global", "cam_q_rig", "cam_t_rig",
                 "points"):
        _close(getattr(ts, name), getattr(js, name), STATE_TOL, name)
    for tm, jm in zip(ts.intrinsics, js.intrinsics):
        if hasattr(jm, "params"):
            _close(tm.params, jm.params, STATE_TOL)
        else:
            _close(tm.grid, jm.grid, STATE_TOL)


def assert_histories(ht, hj):
    assert len(ht) == len(hj)
    for a, b in zip(ht, hj):
        for key in ("iteration", "accepted", "pcg_iterations"):
            assert a[key] == b[key], key
        for key in ("cost", "new_cost", "paired_cost", "paired_new_cost",
                    "lambda"):
            _close(a[key], b[key], REL, key)


def assert_step(got, ref):
    _assert_state(got[0], ref[0])
    assert got[3] == bool(ref[3])
    assert got[6] == int(ref[6])
    for i in (2, 4, 5, 7, 8):
        _close(float(got[i]), float(ref[i]), REL)


@pytest.mark.parametrize("solver", SOLVERS)
def test_ba_step_and_history(tpf_problem, solver):
    state, data, ts, td = tpf_problem
    oj, ot = _options(solver)
    lam_j, lam_t = jnp.asarray(-1.0), torch.tensor(-1.0, dtype=torch.float64)
    warm_j, warm_t = tuple(s.pixel for s in data), tuple(s.pixel for s in td)
    assert_step(T.make_lm_step(ot)(ts, warm_t, lam_t, td),
                J.make_lm_step(oj)(state, warm_j, lam_j, data))
    sj, _, lj, outs_j = J.make_lm_scan(oj, 2)(state, warm_j, lam_j, data)
    st, _, lt, outs_t = T.make_lm_scan(ot, 2)(ts, warm_t, lam_t, td)
    _assert_state(st, sj)
    _close(float(lt), float(lj), REL)
    assert list(outs_t[0]) == [bool(a) for a in np.asarray(outs_j[0])]
    assert list(outs_t[3]) == [int(i) for i in np.asarray(outs_j[3])]
    for a, b in zip(outs_t[1:], outs_j[1:]):
        _close(np.asarray(a, float), np.asarray(b), REL)
    oj, ot = _options(solver, max_lm_iterations=8,
                      cost_reduction_threshold=0.0)
    sj, ij = J.optimize(state, None, None, oj, data=data)
    st, it = T.optimize(ts, None, None, ot, data=td)
    assert_histories(it["history"], ij["history"])
    assert len(it["history"]) == 8
    _assert_state(st, sj)
    assert it["history"][-1]["paired_new_cost"] \
        < 1e-3 * it["history"][0]["paired_cost"]


def test_block_chunk_and_auto(tpf_problem):
    """``block_chunk`` merges dense intrinsics blocks of chunks; ``auto``
    counts the parametric tangent when it sizes the reduced system."""
    state, data, ts, td = tpf_problem
    n = td[0].count
    chunk = next(c for c in (128, 96, 64, 32) if n % c == 0 and n > c)
    for solver, extra in (("schur", dict(block_chunk=chunk)), ("auto", {})):
        oj, ot = _options(solver, max_lm_iterations=3, **extra)
        assert T.resolve_solver(ot, ts).solver == J.resolve_solver(
            oj, state).solver
        sj, ij = J.optimize(state, None, None, oj, data=data)
        st, it = T.optimize(ts, None, None, ot, data=td)
        assert_histories(it["history"], ij["history"])
        _assert_state(st, sj)


def test_convert_round_trip(tpf_problem):
    """Parametric models to numpy and back, by JAX class name and by a
    dict's ``kind``; width, height and the projection flag come along."""
    state, _, ts, _ = tpf_problem
    back = convert.state_to_numpy(ts)
    (intr,) = back["intrinsics"]
    assert intr["kind"] == "thin_prism_fisheye"
    assert intr["use_equidistant_projection"] is True
    again = convert.ba_state(back, device="cpu")
    m = again.intrinsics[0]
    assert isinstance(m, tpm.CentralThinPrismFisheyeModel)
    assert torch.equal(m.params, ts.intrinsics[0].params)
    assert (m.width, m.height) == (state.intrinsics[0].width,
                                   state.intrinsics[0].height)
    plain = convert.camera_model(_tpf_model(False), device="cpu")
    assert plain.use_equidistant_projection is False
    for jm, cls in ((_opencv_model(), tpm.CentralOpenCVModel),
                    (_radial_model(), tpm.CentralRadialModel)):
        tm = convert.camera_model(jm, device="cpu")
        assert isinstance(tm, cls) and tm.width == 640
        d = convert.state_to_numpy(dataclasses.replace(
            ts, intrinsics=(tm,)))["intrinsics"][0]
        assert isinstance(convert.camera_model(d, device="cpu"), cls)
    with pytest.raises(ValueError, match="kind"):
        convert.camera_model({"params": np.zeros(12)}, device="cpu")


def test_parametric_bench_problem_runs():
    """The parametric twins of the bench problem, cut to 16 poses of 128
    points: every row valid, one step of each solver form lowers the
    paired cost."""
    for kind in ("thin_prism_fisheye", "opencv", "radial"):
        st, data, meta = problems.make_parametric_bench_problem(
            kind, n_points=128, n_poses=16, device="cpu")
        assert meta["n_obs"] == int(data[0].valid.sum()) > 1900
        model = st.intrinsics[0]
        ref = problems.parametric_bench_model(kind, device="cpu")
        assert type(model) is type(ref)
        moved = (model.params - ref.params).abs() / ref.params.abs().clamp(1)
        assert 0 < float(moved.max()) < 6e-3
        for k in (1, 2):
            options = T.BAOptions(max_lm_iterations=2, lm_steps_per_call=k)
            _, info = T.optimize(st, None, None, options, data=data)
            h = info["history"]
            assert h[0]["accepted"]
            assert h[-1]["paired_new_cost"] < 1e-2 * h[0]["paired_cost"]

"""Port parity: the BA solver modes and options beyond ``schur``.

On ``__graft_entry__._make_problem(dtype=float64)`` (64×48 image, 7×7
grid, 16 poses, 64 points, grid-layout table) the JAX package (its XLA
path on the CPU) and the port on the CPU get the same state, warm starts,
λ and tables, for ``solver="auto"`` (which resolves to ``schur_direct``
here), ``"schur_direct"``, ``"schur_direct_points"`` and ``"pcg"``:

- one two-pass step, three cached-blocks steps and ``optimize`` histories;
- ``pcg`` with the points frozen, and the Schur modes falling back to it
  when their eliminated group is frozen;
- the dense direct solve against a tight PCG solve of the same system;
- ``block_chunk`` blocks and costs against the JAX chunked evaluation;
- ``verify_cost``'s measurements and its guards; ``profile_dir``.

``accept`` and the CG iteration counts must be identical (0 for the direct
modes); costs, λ and the state agree to 1e-9 relative (both float64).
"""

import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from camera_calibration_torch import convert
from camera_calibration_torch.ba import lm_pcg as T
from camera_calibration_torch.ba.state import (
    fix_gauge_mask as t_mask, zero_tangent as t_zero,
)
from camera_calibration_tpu.ba import lm_pcg as J
from camera_calibration_tpu.ba.state import fix_gauge_mask as j_mask
from torch_threads import one_torch_thread  # noqa: F401

REL = dict(rtol=1e-9, atol=1e-12)
STATE_TOL = dict(rtol=1e-9, atol=1e-10)
MODES = ["auto", "schur_direct", "schur_direct_points", "pcg"]


def _lam0(package):
    """λ = −1 (initialise from the diagonal) in the dtype optimize uses, so
    that the JAX package's compiled steps are shared between tests."""
    if package is J:
        return jnp.asarray(-1.0, jnp.float64)
    return torch.tensor(-1.0, dtype=torch.float64)


@pytest.fixture(scope="module")
def problem():
    state, data = graft._make_problem(dtype=jnp.float64)
    ts = convert.ba_state(state, device="cpu")
    td = tuple(convert.observation_table(s, device="cpu") for s in data)
    return state, data, ts, td


def _options(solver, **kw):
    kw = dict(dict(max_pcg_iterations=20, proj_iterations=8, solver=solver),
              **kw)
    return J.BAOptions(**kw), T.BAOptions(**kw)


def _resolved(problem, solver, **kw):
    state, _, ts, _ = problem
    oj, ot = _options(solver, **kw)
    oj, ot = J.resolve_solver(oj, state), T.resolve_solver(ot, ts)
    assert ot.solver == oj.solver
    return oj, ot


def _assert_state(ts, js):
    for name in ("rig_q_global", "rig_t_global", "cam_q_rig", "cam_t_rig",
                 "points"):
        np.testing.assert_allclose(getattr(ts, name), getattr(js, name),
                                   **STATE_TOL, err_msg=name)
    for tm, jm in zip(ts.intrinsics, js.intrinsics):
        np.testing.assert_allclose(tm.grid, jm.grid, **STATE_TOL)


def _assert_tangent(tt, jt, **tol):
    for a, b in zip(tt.leaves(), jax.tree_util.tree_leaves(jt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


def test_auto_resolves_from_the_reduced_size(problem):
    state, _, ts, _ = problem
    # 64 points * 3 + 6 + 7*7*2 = 296 reduced unknowns
    for limit, mode in ((2048, "schur_direct"), (296, "schur_direct"),
                        (295, "schur")):
        oj = J.resolve_solver(J.BAOptions(solver="auto"), state, limit)
        ot = T.resolve_solver(T.BAOptions(solver="auto"), ts, limit)
        assert ot.solver == oj.solver == mode
    assert T.resolve_solver(T.BAOptions(solver="pcg"), ts).solver == "pcg"
    with pytest.raises(ValueError, match="resolve"):
        T.lm_step(ts, (), torch.tensor(-1.0), (), T.BAOptions(solver="auto"))
    with pytest.raises(ValueError, match="unknown solver"):
        T.make_lm_step(T.BAOptions(solver="dense"))


@pytest.mark.parametrize("solver", MODES)
def test_two_pass_step(problem, solver):
    state, data, ts, td = problem
    oj, ot = _resolved(problem, solver)
    ref = J.make_lm_step(oj)(state, tuple(s.pixel for s in data), _lam0(J),
                             data)
    got = T.make_lm_step(ot)(ts, tuple(s.pixel for s in td), _lam0(T), td)
    _assert_state(got[0], ref[0])
    assert got[3] == bool(ref[3]) and got[3]
    assert got[6] == int(ref[6])
    assert (got[6] == 0) == solver.startswith(("auto", "schur_direct"))
    for i in (2, 4, 5, 7, 8):
        np.testing.assert_allclose(float(got[i]), float(ref[i]), **REL)


@pytest.mark.parametrize("solver,extra", [
    ("auto", {}), ("schur_direct", {}), ("schur_direct_points", {}),
    ("pcg", dict(cg_warm_start=True, freeze=("points",))),
])
def test_cached_blocks_steps(problem, solver, extra):
    state, data, ts, td = problem
    oj, ot = _resolved(problem, solver, **extra)
    n = 3
    sj, wj, lj, outs_j = J.make_lm_scan(oj, n)(
        state, tuple(s.pixel for s in data), _lam0(J), data)
    st, wt, lt, outs_t = T.make_lm_scan(ot, n)(
        ts, tuple(s.pixel for s in td), _lam0(T), td)
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
    assert new_pt[-1] < old_pt[0]
    frozen = extra.get("freeze", ())
    if frozen:
        assert all(i > 0 for i in iters_t)  # the CG solve ran
    if "points" in frozen:
        assert torch.equal(st.points, ts.points)


@pytest.mark.parametrize("solver,frozen,k", [
    ("schur", "points", 1), ("schur_poses", "poses", 3),
    ("schur_direct", "poses", 1), ("schur_direct_points", "points", 3)])
def test_frozen_eliminated_group_runs_pcg(problem, solver, frozen, k):
    """A Schur mode whose eliminated group is frozen runs the full-system
    PCG: the same run as solver="pcg"."""
    _, _, ts, td = problem
    runs = []
    for mode in (solver, "pcg"):
        _, ot = _options(mode, freeze=(frozen,), max_lm_iterations=3,
                         lm_steps_per_call=k)
        runs.append(T.optimize(ts, None, None, ot, data=td))
    (s1, i1), (s2, i2) = runs
    assert i1["history"] == i2["history"]
    assert all(h["pcg_iterations"] > 0 for h in i1["history"])
    assert torch.equal(s1.points, s2.points)
    group = s1.points if frozen == "points" else s1.rig_t_global
    assert torch.equal(group, ts.points if frozen == "points"
                       else ts.rig_t_global)


@pytest.mark.parametrize("solver,k", [("auto", 1), ("schur_direct", 3),
                                      ("schur_direct_points", 1), ("pcg", 1)])
def test_optimize_history(problem, solver, k):
    state, data, ts, td = problem
    oj, ot = _options(solver, max_lm_iterations=5, lm_steps_per_call=k)
    sj, info_j = J.optimize(state, None, None, oj, data=data)
    st, info_t = T.optimize(ts, None, None, ot, data=td)
    hj, ht = info_j["history"], info_t["history"]
    assert len(ht) == len(hj) > 0
    for a, b in zip(ht, hj):
        assert set(a) == set(b)
        for key in ("iteration", "accepted", "pcg_iterations"):
            assert a[key] == b[key], key
        for key in ("cost", "new_cost", "paired_cost", "paired_new_cost",
                    "lambda"):
            np.testing.assert_allclose(a[key], b[key], **REL, err_msg=key)
    _assert_state(st, sj)
    rj, rt = info_j["report"].as_dict(), info_t["report"].as_dict()
    assert set(rt) == set(rj)
    for key in ("iterations", "accepted", "rejected", "pcg_iterations_total"):
        assert rt[key] == rj[key], key
    np.testing.assert_allclose(info_t["final_cost"], info_j["final_cost"], **REL)


def test_auto_on_flat_tables_falls_back_to_schur(problem):
    """table_layout="flat" keeps a flat table, which the direct solver
    cannot assemble from: auto runs schur, as in the JAX package."""
    state, data, ts, td = problem
    flat = tuple(dataclasses.replace(s, grid_shape=None) for s in td)
    kw = dict(max_lm_iterations=2, table_layout="flat")
    _, auto = _options("auto", **kw)
    _, schur = _options("schur", **kw)
    _, info_a = T.optimize(ts, None, None, auto, data=flat)
    _, info_s = T.optimize(ts, None, None, schur, data=flat)
    assert info_a["history"] == info_s["history"]
    assert info_a["history"][0]["pcg_iterations"] > 0
    _, direct = _options("schur_direct", **kw)
    with pytest.raises(ValueError, match="grid-layout"):
        T.optimize(ts, None, None, direct, data=flat)


def test_cg_warm_start_warns_for_the_direct_modes(problem):
    _, _, ts, td = problem
    _, ot = _options("schur_direct", max_lm_iterations=1, cg_warm_start=True,
                     lm_steps_per_call=2)
    with pytest.warns(UserWarning, match="no effect"):
        T.optimize(ts, None, None, ot, data=td)
    _, ot = _options("pcg", max_lm_iterations=1, cg_warm_start=True,
                     lm_steps_per_call=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        T.optimize(ts, None, None, ot, data=td)


def _solve_inputs(problem, options):
    """Blocks, masked gradient, block diagonal and mask at the start state
    (the port)."""
    _, _, ts, td = problem
    bt, _ = T.compute_blocks(td, ts, tuple(s.pixel for s in td), options)
    mt = t_mask(ts, ())
    gt = T._masked(T.apply_jtw(td, bt, [b.r for b in bt], ts), mt)
    return bt, gt, T.jtwj_block_diag(td, bt, ts), mt


def test_schur_direct_matches_tight_pcg(problem):
    """The dense direct solve, eliminating either group, equals an almost
    exact PCG solve of the same damped normal equations (the JAX package's
    own check, tests/test_ba.py:40-83, with λ = 10 so that PCG converges in
    a few hundred iterations).  The direct solves match the JAX package's
    through the steps above."""
    _, _, ts, td = problem
    _, ot = _options("pcg", max_pcg_iterations=2000, pcg_rel_tolerance=1e-10)
    bt, gt, dt, mt = _solve_inputs(problem, ot)
    lam = torch.tensor(10.0, dtype=torch.float64)
    ref, iters = T.pcg_solve(td, bt, ts, gt, dt, lam, mt, ot)
    assert 20 < iters < 2000
    for elim in ("poses", "points"):
        got, n_iters = T.schur_direct_solve(td, bt, ts, gt, dt, lam, mt, ot,
                                            eliminate=elim)
        assert n_iters == 0
        for a, b in zip(got.leaves(), ref.leaves()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6 * float(b.abs().max()))


def test_schur_direct_non_positive_definite_gives_nan(problem, monkeypatch):
    """A reduced system that Cholesky cannot factor gives a NaN step, which
    the LM step rejects (the JAX package's cho_factor semantics), with no
    exception."""
    _, _, ts, td = problem
    _, ot = _options("schur_direct")
    bt, gt, bd, mt = _solve_inputs(problem, ot)
    lam = torch.tensor(-1e6, dtype=torch.float64)
    delta, _ = T.schur_direct_solve(td, bt, ts, gt, bd, lam, mt, ot)
    assert bool(torch.isnan(delta.points).all())
    cholesky_ex = torch.linalg.cholesky_ex

    def fails(h):
        chol, _ = cholesky_ex(h)
        return chol, torch.ones((), dtype=torch.int32)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", fails)
    out = T.lm_step(ts, tuple(s.pixel for s in td), _lam0(T), td, ot)
    assert out[3] is False and torch.equal(out[0].points, ts.points)
    assert float(out[2]) > 0  # λ doubled from its initial value


def test_flat_offsets_and_dense_intrinsics_jacobian(problem):
    state, data, ts, td = problem
    offs_t, total_t = T._flat_offsets(ts)
    offs_j, total_j = J._flat_offsets(state)
    assert total_t == total_j == t_zero(ts).ravel().numel()
    assert {k: v[:2] for k, v in offs_t.items()} == \
        {k: v[:2] for k, v in offs_j.items()}
    # the same window Jacobian through both forms
    rng = np.random.default_rng(4)
    gh, gw, k = offs_t[("intr", 0)][2]
    n = 200
    j_win = rng.normal(0, 1, (32 * k, n))
    base = np.stack([rng.integers(-3, gw, n), rng.integers(-3, gh, n)],
                    1).astype(np.int32)
    from camera_calibration_torch.ba import residuals as tres
    from camera_calibration_tpu.ba import residuals as jres

    got = T._dense_intr_j(tres.GridIntr(torch.as_tensor(j_win),
                                        torch.as_tensor(base), k), gh, gw, k)
    want = J._dense_intr_j(jres.GridIntr(jnp.asarray(j_win),
                                         jnp.asarray(base), k), gh, gw, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-15)


def test_block_chunk(problem):
    """Chunks of 256 rows (the table's 1024 rows: four chunks, flat within
    each) give the JAX package's chunked blocks and costs, and the step of
    the unchunked tables; a chunk that does not divide the rows leaves the
    table whole."""
    state, data, ts, td = problem
    oj, ot = _options("schur", block_chunk=256)
    warm_j = tuple(s.pixel for s in data)
    warm_t = tuple(s.pixel for s in td)
    bj, wj = J.compute_blocks(data, state, warm_j, oj)
    bt, wt = T.compute_blocks(td, ts, warm_t, ot)
    for name in ("r", "j_rig", "j_cam", "j_point", "weight", "cost"):
        np.testing.assert_allclose(getattr(bt[0], name).numpy(),
                                   np.asarray(getattr(bj[0], name)),
                                   rtol=1e-9, atol=1e-12, err_msg=name)
    valid = np.array(bj[0].valid)
    np.testing.assert_array_equal(bt[0].valid.numpy(), valid)
    np.testing.assert_allclose(bt[0].intr.j_win.numpy()[:, valid],
                               np.asarray(bj[0].intr.j_win)[:, valid],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(bt[0].intr.base_xy.numpy()[valid],
                                  np.asarray(bj[0].intr.base_xy)[valid])
    np.testing.assert_allclose(wt[0].numpy(), np.asarray(wj[0]), atol=1e-8)
    cj, vj, _ = J.total_cost(data, state, warm_j, oj)
    ct, vt, _ = T.total_cost(td, ts, warm_t, ot)
    np.testing.assert_allclose(ct[0].numpy(), np.asarray(cj[0]), **REL)
    np.testing.assert_array_equal(vt[0].numpy(), np.array(vj[0]))
    # the step of the unchunked tables, up to rounding
    _, whole = _options("schur")
    a = T.lm_step(ts, warm_t, _lam0(T), td, ot)
    b = T.lm_step(ts, warm_t, _lam0(T), td, whole)
    assert a[3] == b[3] and a[6] == b[6]
    np.testing.assert_allclose(float(a[5]), float(b[5]), **REL)
    # 300 does not divide 1024: one evaluation, on the grid layout
    _, odd = _options("schur", block_chunk=300)
    b_odd, _ = T.compute_blocks(td, ts, warm_t, odd)
    b_whole, _ = T.compute_blocks(td, ts, warm_t, whole)
    assert torch.equal(b_odd[0].intr.j_win, b_whole[0].intr.j_win)
    assert torch.equal(b_odd[0].cost, b_whole[0].cost)


def test_verify_cost_matches_reference(problem):
    state, data, ts, td = problem
    oj, ot = _options("schur", freeze=("intrinsics",))
    ref = J.verify_cost(state, data, oj, seed=3)
    got = T.verify_cost(ts, td, ot, seed=3)
    assert set(got) == set(ref)
    for key in ("cost", "grad_analytic", "grad_fd"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-7, err_msg=key)
    assert got["cost_block_pass_rel_diff"] < 1e-12
    assert got["grad_rel_diff"] < 1e-5


def test_verify_cost_guards(problem, monkeypatch):
    _, _, ts, td = problem
    _, ot = _options("schur")
    # optimize runs the checks once when asked
    calls = []
    real = T.verify_cost
    monkeypatch.setattr(T, "verify_cost",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    T.optimize(ts, None, None, dataclasses.replace(
        ot, debug_verify=True, max_lm_iterations=1), data=td)
    assert calls == [1]
    monkeypatch.undo()
    # a gradient that disagrees with the finite differences
    apply_jtw = T.apply_jtw
    monkeypatch.setattr(T, "apply_jtw", lambda *a: apply_jtw(*a).map(
        lambda x: 1.5 * x))
    with pytest.raises(AssertionError, match="gradient check"):
        T.verify_cost(ts, td, ot)
    monkeypatch.undo()
    # a cost that changes between two evaluations
    total_cost = T.total_cost
    bump = iter(range(1, 100))

    def drifting(*a):
        costs, valids, warms = total_cost(*a)
        return [c + next(bump) for c in costs], valids, warms

    monkeypatch.setattr(T, "total_cost", drifting)
    with pytest.raises(AssertionError, match="nondeterministic"):
        T.verify_cost(ts, td, ot)


def test_profile_dir_writes_a_trace(problem, tmp_path):
    _, _, ts, td = problem
    _, ot = _options("schur", max_lm_iterations=1)
    out = tmp_path / "prof"
    _, info = T.optimize(ts, None, None,
                         dataclasses.replace(ot, profile_dir=str(out)),
                         data=td)
    trace = json.loads((out / "lm_trace.json").read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    assert len(info["history"]) == 1 and len(events) > 10

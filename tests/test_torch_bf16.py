"""Port parity: ``cg_jacobian_dtype="bfloat16"``, the CG matvecs on bf16
copies of the Jacobian blocks.

The JAX package (its XLA path on the CPU) and the port on the CPU get the
same inputs in float64:

- the rounding to bfloat16: float64 and float32 values, ties included,
  round to the same bf16 values in both packages (both round through
  float32), so the bf16 copies of the blocks agree bit for bit;
- the plain window ops on a bf16 ``j_win`` against the JAX package's XLA
  fallback on the same bf16 values (both widen to float32 and sum in the
  vector's float64): 1e-12 relative;
- LM steps and ``optimize`` histories with bf16 CG on the benchmark problem
  (``bench.make_bench_problem`` cut to 16 poses of 128 points, cast to
  float64) and on ``tests/ba_harness``'s ThinPrismFisheye problem:
  identical accept and CG counts; costs, λ and state to 1e-9 relative
  (observed 1e-10 or less: with identical bf16 values only summation
  orders differ);
- the bf16 copies are made once per solve, and only the CG matvecs read
  them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ba_harness
import bench
from camera_calibration_torch import convert
from camera_calibration_torch.ba import lm_pcg as T
from camera_calibration_torch.ba import residuals as tres
from camera_calibration_torch.ba import window_cuda as wc
from camera_calibration_tpu.ba import lm_pcg as J
from camera_calibration_tpu.ba import residuals as jres
from camera_calibration_tpu.ba.dataset import split_by_camera, to_grid_layout
from torch_threads import one_torch_thread  # noqa: F401

REL = dict(rtol=1e-9, atol=1e-12)
STATE_TOL = dict(rtol=1e-9, atol=1e-10)


def _close(got, ref, tol=REL, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **tol,
                               err_msg=err_msg)


def _jax_bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _torch_bf16(x):
    return torch.as_tensor(x).to(torch.bfloat16).float().numpy()


def test_bf16_rounding_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, 20000) * 10.0 ** rng.integers(-8, 8, 20000)
    # exact ties of bf16 in float32, and float64 values just beside them
    # (where rounding float64 straight to bf16 would differ from rounding
    # through float32)
    b = _torch_bf16(x).astype(np.float32).view(np.uint32)
    ties = ((b & 0xFFFF0000) | 0x8000).view(np.float32).astype(np.float64)
    near = ties * (1 + np.array([-1e-12, 1e-12])[:, None])
    for vals in (x, ties, near.ravel(), x.astype(np.float32)):
        np.testing.assert_array_equal(_torch_bf16(vals), _jax_bf16(vals))


@pytest.mark.parametrize("k", [2, 5])
def test_plain_window_ops_on_bf16_match_reference(k):
    rng = np.random.default_rng(k)
    gh, gw, n = 9, 11, 700
    j_win = rng.normal(0, 1, (32 * k, n))
    base = np.stack([rng.integers(-3, gw, n), rng.integers(-3, gh, n)],
                    1).astype(np.int32)
    tangent = rng.normal(0, 1, (gh, gw, k))
    ws = rng.normal(0, 1, (n, 2))
    jj = jres.GridIntr(j_win=jnp.asarray(j_win).astype(jnp.bfloat16),
                       base_xy=jnp.asarray(base), k_tangent=k)
    tj = torch.as_tensor(j_win).to(torch.bfloat16)
    tb = torch.as_tensor(base)
    got = wc.window_apply_j(tj, tb, torch.as_tensor(tangent))
    ref = jres.intr_apply_j(jj, jnp.asarray(tangent))
    assert got.dtype == torch.float64
    _close(got, ref, dict(rtol=1e-12, atol=1e-12))
    got = wc.window_apply_jtw(tj, tb, torch.as_tensor(ws), gh, gw, k)
    ref = jres.intr_apply_jtw(jj, jnp.asarray(ws), jnp.zeros((gh, gw, k)))
    _close(got, ref, dict(rtol=1e-12, atol=1e-12))


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


@pytest.fixture(scope="module")
def bench_problem():
    state, data, _ = bench.make_bench_problem(n_points=128, n_poses=16)
    state, data = _f64(state), _f64(data)
    ts = convert.ba_state(state, device="cpu")
    td = tuple(convert.observation_table(s, device="cpu") for s in data)
    return state, data, ts, td


@pytest.fixture(scope="module")
def tpf_problem():
    m, p = 12, 64
    gt, obs, segs = ba_harness.make_problem(model_kind="tpf", n_points=p,
                                            n_poses=m)
    state = ba_harness.perturb_state(gt, seed=1)
    data = tuple(to_grid_layout(s, m, p) for s in split_by_camera(obs, segs))
    ts = convert.ba_state(state, device="cpu")
    td = tuple(convert.observation_table(s, device="cpu") for s in data)
    return state, data, ts, td


def _options(solver, **kw):
    kw = dict(dict(max_pcg_iterations=20, proj_iterations=8, solver=solver,
                   cg_jacobian_dtype="bfloat16"), **kw)
    return J.BAOptions(**kw), T.BAOptions(**kw)


def test_bf16_copies_match_reference(bench_problem, tpf_problem):
    """The CG matvecs' bf16 copies of both intrinsics kinds, bit for bit."""
    for state, data, ts, td in (bench_problem, tpf_problem):
        oj, ot = _options("schur")
        bj, _ = jax.jit(lambda d, st, w: J.compute_blocks(d, st, w, oj))(
            data, state, tuple(s.pixel for s in data))
        bt, _ = T.compute_blocks(td, ts, tuple(s.pixel for s in td), ot)
        cj, ct = J._cg_cast_blocks(bj, oj)[0], T._cg_cast_blocks(bt, ot)[0]
        pairs = [(ct.j_rig, cj.j_rig), (ct.j_cam, cj.j_cam),
                 (ct.j_point, cj.j_point)]
        if isinstance(ct.intr, tres.GridIntr):
            pairs.append((ct.intr.j_win, cj.intr.j_win))
        else:
            pairs.append((ct.intr.j_params, cj.intr.j_params))
        for a, b in pairs:
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                a.float().numpy(), np.asarray(b.astype(jnp.float32)))
        assert ct.r is bt[0].r and ct.weight is bt[0].weight


def _assert_state(ts, js):
    for name in ("rig_q_global", "rig_t_global", "cam_q_rig", "cam_t_rig",
                 "points"):
        _close(getattr(ts, name), getattr(js, name), STATE_TOL, name)
    for tm, jm in zip(ts.intrinsics, js.intrinsics):
        _close(tm.params if hasattr(jm, "params") else tm.grid,
               jm.params if hasattr(jm, "params") else jm.grid, STATE_TOL)


@pytest.mark.parametrize("name,solver", [
    ("bench", "schur"), ("bench", "pcg"), ("tpf", "schur_poses"),
    ("tpf", "pcg")])
def test_bf16_steps_and_history(bench_problem, tpf_problem, name, solver):
    state, data, ts, td = bench_problem if name == "bench" else tpf_problem
    oj, ot = _options(solver)
    lam_j, lam_t = jnp.asarray(-1.0), torch.tensor(-1.0, dtype=torch.float64)
    warm_j, warm_t = tuple(s.pixel for s in data), tuple(s.pixel for s in td)
    got = T.make_lm_step(ot)(ts, warm_t, lam_t, td)
    ref = J.make_lm_step(oj)(state, warm_j, lam_j, data)
    _assert_state(got[0], ref[0])
    assert got[3] == bool(ref[3]) and got[6] == int(ref[6]) > 0
    for i in (2, 4, 5, 7, 8):
        _close(float(got[i]), float(ref[i]))
    sj, _, lj, outs_j = J.make_lm_scan(oj, 2)(state, warm_j, lam_j, data)
    st, _, lt, outs_t = T.make_lm_scan(ot, 2)(ts, warm_t, lam_t, td)
    _assert_state(st, sj)
    _close(float(lt), float(lj))
    assert list(outs_t[0]) == [bool(a) for a in np.asarray(outs_j[0])]
    assert list(outs_t[3]) == [int(i) for i in np.asarray(outs_j[3])]
    for a, b in zip(outs_t[1:], outs_j[1:]):
        _close(np.asarray(a, float), np.asarray(b))
    oj, ot = _options(solver, max_lm_iterations=6,
                      cost_reduction_threshold=0.0)
    sj, ij = J.optimize(state, None, None, oj, data=data)
    st, it = T.optimize(ts, None, None, ot, data=td)
    hj, ht = ij["history"], it["history"]
    assert len(ht) == len(hj) == 6
    for a, b in zip(ht, hj):
        for key in ("accepted", "pcg_iterations"):
            assert a[key] == b[key], key
        for key in ("cost", "new_cost", "paired_cost", "paired_new_cost",
                    "lambda"):
            _close(a[key], b[key], err_msg=key)
    _assert_state(st, sj)


def test_bf16_copies_are_made_once_per_solve(bench_problem, monkeypatch):
    """One schur step: one cast of the blocks for the solve; every CG
    matvec reads the bf16 j_win (one J·v and one JᵀW·s a CG iteration),
    the right-hand side, gradient and back-substitution the float64 one."""
    _, _, ts, td = bench_problem
    casts, seen = [], {"window_apply_j": [], "window_apply_jtw": []}
    cast = T._cg_cast_blocks
    monkeypatch.setattr(T, "_cg_cast_blocks",
                        lambda *a: casts.append(1) or cast(*a))
    for name in seen:
        fn = getattr(wc, name)
        monkeypatch.setattr(wc, name, lambda j, *a, _fn=fn, _n=name, **kw:
                            seen[_n].append(j.dtype) or _fn(j, *a, **kw))
    _, ot = _options("schur")
    out = T.make_lm_step(ot)(ts, tuple(s.pixel for s in td),
                             torch.tensor(-1.0, dtype=torch.float64), td)
    iters = out[6]
    assert len(casts) == 1 and iters > 1
    assert seen["window_apply_j"].count(torch.bfloat16) == iters
    assert seen["window_apply_jtw"].count(torch.bfloat16) == iters
    assert seen["window_apply_j"].count(torch.float64) == 1
    assert seen["window_apply_jtw"].count(torch.float64) == 2


def test_unknown_cg_jacobian_dtype_raises(bench_problem):
    _, _, ts, td = bench_problem
    options = dataclasses.replace(_options("schur")[1],
                                  cg_jacobian_dtype="float16")
    with pytest.raises(ValueError, match="cg_jacobian_dtype"):
        T.optimize(ts, None, None, options, data=td)

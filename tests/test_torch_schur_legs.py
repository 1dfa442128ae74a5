"""The pose and point legs of the point-eliminated Schur matvec on grid
tables (``ba/schur_cuda.py``): plain versions, dispatch and the path rules.

On the CPU the two passes take their plain versions.  In float64 they are
held to the composition the solve used before them (``lm_pcg``'s per-group
``_apply_j_subset`` / ``_apply_jt_subset``: four grid einsums, the camera
einsums and the zero tangents) on small grid problems whose rows are partly
masked: a K=2 CentralGeneric and a K=5 NoncentralGeneric camera, and a rig
of two cameras, each with float64 and with bfloat16 Jacobians (both sides
widen the same bf16 values).  Tolerance 1e-12 relative to the largest
value: the same float64 products, summed in another order at most.  A
whole LM step through the new passes equals the step through the old
composition to the same bar.

A tensor that is neither on the CPU nor a float32/bfloat16 set on the card
raises (a ``meta`` tensor stands for the card here): no plain fallback, no
launch counted.  ``schur_poses``, ``pcg`` and flat tables keep the
per-group legs and never reach the two passes.

Tables sharded in bands of imagesets (``parallel/sharding.py``) take the
two passes on each band: here the bands are cut in one process and their
sums added by hand in place of the all-reduce (``_reduce``), and the sum
over the bands equals the whole grid's legs to 1e-12 (an empty band adds
0).  ``tests/test_torch_sharding.py`` runs them over a two-process group.
"""

import dataclasses

import numpy as np
import pytest
import torch

from camera_calibration_torch import _cuda, problems
from camera_calibration_torch.ba import lm_pcg as T
from camera_calibration_torch.ba import schur_cuda as sc
from camera_calibration_torch.ba.state import fix_gauge_mask
from camera_calibration_torch.parallel import sharding
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-12
F64 = torch.float64


def _masked_rows(table, seed, share=0.3):
    """The table with about ``share`` of its rows made unobserved."""
    rng = np.random.default_rng(seed)
    keep = torch.as_tensor(rng.uniform(size=table.count) >= share)
    return dataclasses.replace(table, valid=table.valid & keep)


def _rig_of_two(state, data):
    """The problem's camera twice in one rig: the second 2 cm to the side,
    with the same observations (its residuals are whatever they are)."""
    t2 = state.cam_t_rig.new_tensor([[0.02, 0.0, 0.0]])
    state = dataclasses.replace(
        state, cam_q_rig=torch.cat([state.cam_q_rig] * 2),
        cam_t_rig=torch.cat([state.cam_t_rig, t2]),
        intrinsics=state.intrinsics * 2)
    second = dataclasses.replace(data[0],
                                 camera=torch.ones_like(data[0].camera))
    return state, (data[0], second)


def _problem(kind):
    make = (problems.make_noncentral_bench_problem if kind == "noncentral"
            else problems.make_bench_problem)
    state, data, _ = make(n_points=96, n_poses=12, gres=8, device="cpu",
                          dtype=F64)
    if kind == "rig":
        state, data = _rig_of_two(state, data)
    data = tuple(_masked_rows(s, seed=i) for i, s in enumerate(data))
    return state, data


@pytest.fixture(scope="module")
def problems_f64():
    out = {}
    for kind in ("central", "noncentral", "rig"):
        state, data = _problem(kind)
        options = T.BAOptions(proj_iterations=6)
        blocks, _ = T.compute_blocks(data, state,
                                     tuple(s.pixel for s in data), options)
        out[kind] = (state, data, blocks)
    return out


def _rand_tangent(state, seed):
    rng = np.random.default_rng(seed)
    mask = fix_gauge_mask(state)
    flat = torch.as_tensor(rng.normal(0, 1, mask.ravel().numel()))
    return mask.unravel(flat * mask.ravel())


def _assert_rel(got, ref):
    assert got.shape == ref.shape
    scale = max(float(ref.abs().max()), 1e-300)
    assert float((got - ref).abs().max()) <= REL * scale


def _d_inv(blocks, data, state):
    _, _, pts_b, _ = T.jtwj_block_diag(data, blocks, state)
    return T._damped_inv(pts_b, torch.tensor(0.3, dtype=F64))


@pytest.mark.parametrize("jac", ["float64", "bfloat16"])
@pytest.mark.parametrize("kind", ["central", "noncentral", "rig"])
def test_plain_legs_equal_the_per_group_composition(problems_f64, kind, jac):
    state, data, blocks = problems_f64[kind]
    d_inv = _d_inv(blocks, data, state)
    if jac == "bfloat16":
        options = dataclasses.replace(T.BAOptions(),
                                      cg_jacobian_dtype="bfloat16")
        blocks = T._cg_cast_blocks(blocks, options)
        assert blocks[0].j_rig.dtype == torch.bfloat16
    keep = dict(rig=True, cam=True, points=False, intr=True)
    elim = dict(rig=False, cam=False, points=True, intr=False)
    mask = fix_gauge_mask(state)
    v = _rand_tangent(state, seed=1)
    v = dataclasses.replace(v, points=torch.zeros_like(v.points))

    # pass A: Bᵀv against J_pointᵀ W (J_keep v)
    s_intr = [T.res.intr_apply_j(b.intr, v.intr[ci])
              for ci, b in enumerate(blocks)]
    rows = T._grid_rows(data, state)
    assert rows == (0, state.rig_q_global.shape[0])
    t = T._point_legs(data, blocks, rows, v, s_intr)
    u = T._apply_j_subset(data, blocks, v, **keep)
    t_ref = T._apply_jt_subset(data, blocks, u, state, **elim).points
    _assert_rel(t, t_ref)

    # pass B: J_keepᵀ W (J_keep v − J_point D⁻¹ t), and with v = 0
    y = torch.einsum("pjk,pk->pj", d_inv, t_ref)
    u2 = T._apply_j_subset(
        data, blocks,
        dataclasses.replace(T.zero_tangent(state), points=y), **elim)
    out_flat = torch.full_like(mask.ravel(), float("nan"))
    out_flat[mask.unravel(torch.arange(out_flat.numel())).points.ravel()] = 0
    out = mask.unravel(out_flat)
    got = T._pose_legs(data, blocks, rows, v, s_intr, t_ref, d_inv, out_flat,
                       out)
    diff = [a - b for a, b in zip(u, u2)]
    _assert_rel(got, T._apply_jt_subset(data, blocks, diff, state,
                                        **keep).ravel())
    got = T._pose_legs(data, blocks, rows, None, None, t_ref, d_inv,
                       out_flat, out)
    _assert_rel(-got, T._apply_jt_subset(data, blocks, u2, state,
                                         **keep).ravel())


def _assert_same_run(a, b):
    """Two step outputs alike: flags and counts equal, numbers to 1e-12."""
    if isinstance(a, torch.Tensor):
        _assert_rel(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_run(x, y)
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=REL)
    elif isinstance(a, (bool, int)):
        assert a == b
    else:  # the state
        for name in ("rig_q_global", "rig_t_global", "cam_q_rig",
                     "cam_t_rig", "points"):
            _assert_rel(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("form", ["two-pass", "cached-blocks, warm CG"])
@pytest.mark.parametrize("kind", ["central", "noncentral", "rig"])
def test_lm_steps_through_the_legs_equal_the_old_composition(
        problems_f64, monkeypatch, kind, form):
    """LM steps through the two passes and through the per-group
    composition (the one two-pass step; two cached-blocks steps, the second
    warm-started from the first): the same CG iteration counts and accept
    decisions, costs and state to 1e-12."""
    state, data, _ = problems_f64[kind]
    options = T.BAOptions(max_pcg_iterations=25, proj_iterations=6,
                          pcg_rel_tolerance=1e-4)
    if form == "two-pass":
        step = T.make_lm_step(options)
    else:
        step = T.make_lm_scan(
            dataclasses.replace(options, cg_warm_start=True), 2)
    warm = tuple(s.pixel for s in data)
    lam = torch.tensor(-1.0, dtype=F64)
    calls = []
    point_leg = sc.point_leg
    monkeypatch.setattr(sc, "point_leg",
                        lambda *a, **k: calls.append(1) or point_leg(*a, **k))
    new = step(state, warm, lam, data)
    assert calls
    n_calls = len(calls)
    monkeypatch.setattr(T, "_grid_rows", lambda d, s: None)
    old = step(state, warm, lam, data)
    assert len(calls) == n_calls
    _assert_same_run(new, old)


def _meta_case(m=3, p=5, jac=torch.float32, vec=torch.float32):
    n = m * p

    def z(shape, dtype=vec):
        return torch.zeros(shape, dtype=dtype, device="meta")

    return dict(j_rig=z((n, 2, 6), jac), j_cam=z((n, 2, 6), jac),
                j_point=z((n, 2, 3), jac), weight=z((n,)), s_intr=z((n, 2)),
                x_rig=z((m, 6)), x_cam=z((6,)), grid_shape=(m, p)), (m, p)


def _call(leg, kw, mp):
    m, p = mp
    if leg == "point":
        return sc.point_leg(**kw)
    z = torch.zeros((p, 3), device="meta")
    return sc.pose_leg(**kw, t=z, d_inv=torch.zeros((p, 3, 3), device="meta"),
                       rig_out=torch.zeros((m, 6), device="meta"),
                       cam_out=torch.zeros(6, device="meta"))


@pytest.mark.parametrize("leg", ["point", "pose"])
@pytest.mark.parametrize("fault,error", [
    ("float64 Jacobians", TypeError),
    ("float16 Jacobians", TypeError),
    ("mixed Jacobian types", TypeError),
    ("float64 vectors", TypeError),
    ("transposed j_rig", ValueError),
    ("wrong grid shape", ValueError),
    ("a vector of the wrong shape", ValueError),
    ("no fault: not on a card", ValueError),
])
def test_a_call_off_the_cpu_raises_and_does_not_fall_back(monkeypatch, leg,
                                                          fault, error):
    def refuse(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(sc, "point_leg_plain", refuse)
    monkeypatch.setattr(sc, "pose_leg_plain", refuse)
    kw, mp = _meta_case(
        jac={"float64 Jacobians": F64,
             "float16 Jacobians": torch.float16}.get(fault, torch.float32),
        vec=F64 if fault == "float64 vectors" else torch.float32)
    if fault == "mixed Jacobian types":
        kw["j_cam"] = kw["j_cam"].bfloat16()
    elif fault == "transposed j_rig":
        kw["j_rig"] = kw["j_rig"].transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "wrong grid shape":
        kw["grid_shape"] = (mp[0] + 1, mp[1])
    elif fault == "a vector of the wrong shape":
        kw["x_rig"] = torch.zeros((mp[0], 3), device="meta")
    before = dict(_cuda.launches)
    with pytest.raises(error):
        _call(leg, kw, mp)
    assert dict(_cuda.launches) == before


@pytest.mark.parametrize("solver,layout", [
    ("schur_poses", "auto"), ("pcg", "auto"), ("schur", "flat")])
def test_other_paths_keep_the_per_group_legs(problems_f64, monkeypatch,
                                             solver, layout):
    """``schur_poses``, ``pcg`` and flat tables never reach the two
    passes; their steps lower the paired cost."""
    def refuse(*a, **k):
        raise AssertionError("reached the grid passes")

    monkeypatch.setattr(sc, "point_leg", refuse)
    monkeypatch.setattr(sc, "pose_leg", refuse)
    state, data, _ = problems_f64["central"]
    if layout == "flat":
        data = tuple(dataclasses.replace(s, grid_shape=None) for s in data)
        assert T._grid_rows(data, state) is None
    options = T.BAOptions(solver=solver, max_lm_iterations=2,
                          max_pcg_iterations=20, proj_iterations=6,
                          table_layout=layout)
    _, info = T.optimize(state, None, None, options, data=data)
    hist = info["history"]
    assert hist[0]["accepted"]
    assert hist[-1]["paired_new_cost"] < hist[0]["paired_cost"]


def _bands(state, data, cuts):
    """The tables cut into bands of imagesets ``[cuts[r], cuts[r+1])``, one
    a rank, as ``sharding.shard_observations`` cuts them."""
    p = state.points.shape[0]
    world = len(cuts) - 1
    out = []
    for r in range(world):
        m0, m1 = cuts[r], cuts[r + 1]
        tables = [dataclasses.replace(
            T._slice_table(seg, slice(m0 * p, m1 * p)), grid_shape=(m1 - m0, p))
            for seg in data]
        out.append(sharding.ShardedTables(
            tables, sharding.Shard(None, r, world,
                                   band_starts=(m0,) * len(data))))
    return out


@pytest.mark.parametrize("kind", ["central", "noncentral", "rig"])
def test_band_legs_sum_to_the_whole_grid(problems_f64, monkeypatch, kind):
    """Both passes (the matvec's and the right-hand side's) on three bands
    of imagesets, one of them empty, summed, equal the passes on the whole
    grid; each band's rows are the ones it holds."""
    state, data, blocks = problems_f64[kind]
    monkeypatch.setattr(T, "_reduce", lambda d, *t: list(t))
    m = state.rig_q_global.shape[0]
    mask = fix_gauge_mask(state)
    v = _rand_tangent(state, seed=3)
    d_inv = _d_inv(blocks, data, state)
    t_e = torch.as_tensor(np.random.default_rng(4).normal(
        0, 1, tuple(state.points.shape)))

    def legs(dat, blks):
        rows = T._grid_rows(dat, state)
        s_intr = [None if b is None else T.res.intr_apply_j(b.intr, v.intr[ci])
                  for ci, b in enumerate(blks)]
        t = T._point_legs(dat, blks, rows, v, s_intr)
        got = []
        for x in (v, None):
            out_flat = torch.zeros_like(mask.ravel())
            got.append(T._pose_legs(dat, blks, rows, x, s_intr, t_e, d_inv,
                                    out_flat, mask.unravel(out_flat)))
        return rows, [t] + got

    _, whole = legs(data, blocks)
    cuts = (0, 5, 5, m)
    total = None
    for r, band in enumerate(_bands(state, data, cuts)):
        if band[0].count:
            band_blocks, _ = T.compute_blocks(
                band, state, tuple(s.pixel for s in band),
                T.BAOptions(proj_iterations=6))
        else:  # an empty band's blocks are never read
            band_blocks = [None] * len(band)
        rows, parts = legs(band, band_blocks)
        assert rows == (cuts[r], cuts[r + 1] - cuts[r])
        total = parts if total is None else [a + b
                                             for a, b in zip(total, parts)]
    for got, ref in zip(total, whole):
        _assert_rel(got, ref)


def test_grid_rows_are_the_rows_every_table_holds(problems_f64):
    """Whole grids give every imageset; a shard's bands give its band
    (empty ones too); flat tables, bands of unknown start (tables not cut
    by ``shard_observations``) and cameras holding different rows give
    None."""
    state, data, _ = problems_f64["rig"]
    m = state.rig_q_global.shape[0]
    assert T._grid_rows(data, state) == (0, m)
    bands = _bands(state, data, (0, 4, 4, m))
    assert [T._grid_rows(b, state) for b in bands] == [(0, 4), (4, 0),
                                                       (4, m - 4)]
    flat = (data[0], dataclasses.replace(data[1], grid_shape=None))
    assert T._grid_rows(flat, state) is None
    unknown = sharding.ShardedTables(bands[2], sharding.Shard(None, 2, 3))
    assert T._grid_rows(unknown, state) is None
    mixed = sharding.ShardedTables(
        bands[2], sharding.Shard(None, 2, 3, band_starts=(4, 3)))
    assert T._grid_rows(mixed, state) is None
    short = (data[0], T._slice_table(data[1], slice(0, 10)))
    assert T._grid_rows(short, state) is None


@pytest.mark.parametrize("kind", ["central", "noncentral"])
def test_intrinsics_jtw_writes_into_the_given_output(problems_f64, kind):
    """``intr_apply_jtw(..., out=)`` writes J_intrᵀ·ws into ``out`` and
    returns it: the values of the call without ``out``."""
    state, data, blocks = problems_f64[kind]
    b = blocks[0]
    ws = torch.as_tensor(np.random.default_rng(6).normal(
        0, 1, (data[0].count, 2)))
    shape = tuple(T.zero_tangent(state).intr[0].shape)
    ref = T.res.intr_apply_jtw(b.intr, ws, torch.zeros(shape, dtype=F64))
    out = torch.full(shape, float("nan"), dtype=F64)
    got = T.res.intr_apply_jtw(b.intr, ws, out, out=out)
    assert got is out
    assert torch.equal(out, ref)

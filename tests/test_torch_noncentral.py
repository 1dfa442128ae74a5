"""Port parity: the NoncentralGeneric model and its bundle adjustment.

The problem follows the JAX package's own noncentral BA recipe
(``tests/test_ba.py:138-210``) on ``__graft_entry__._make_problem`` (64×48
image, 7×7 grid, 10 poses of 50 points in grid layout): a smooth
line-origin field, pixels regenerated through the noncentral projection,
and the state perturbed (poses, points and both grids).  Everything is
float64 on the CPU; the JAX functions run jitted on their XLA path.

Checked against the JAX package: the model functions (projection from the
image center and warm-started, unprojection, the implicit-function
sensitivities ``pix_wrt_x`` and ``j_win``), ``segment_blocks`` and
``segment_cost``, ``scale_state``, the protocol's tangent and retraction,
one LM step in both Schur solvers and both step forms, and ``optimize``
histories.  Tolerance 1e-9 relative (the observed gap is ~1e-15); ``accept``
and the CG iteration counts identical.  Also: the ``convert`` round trip and
the port's noncentral bench problem at a small size; and what the card's
projection kernel (``models/noncentral_generic_cuda.py``) relies on: the
loop run for exactly ``max_iterations`` with per-point ``done`` and no host
test gives ``project_points``' result bit for bit, the wrapper's clamp
bounds are the plain ones, and a CPU call goes to the plain function.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import ba_harness
from camera_calibration_torch import _cuda, convert, problems, tracing
from camera_calibration_torch.ba import lm_pcg as T
from camera_calibration_torch.ba import residuals as tres
from camera_calibration_torch.ba import state as tstate
from camera_calibration_torch.models import central_generic as tcg
from camera_calibration_torch.models import noncentral_generic as tncg
from camera_calibration_torch.models import noncentral_generic_cuda as tncgc
from camera_calibration_torch.models import protocol as tprot
from camera_calibration_torch.models.base import replace
from camera_calibration_tpu.ba import lm_pcg as J
from camera_calibration_tpu.ba import residuals as jres
from camera_calibration_tpu.ba import state as jstate
from camera_calibration_tpu.models import noncentral_generic as jncg
from camera_calibration_tpu.models import protocol as jprot
from camera_calibration_tpu.models.base import replace as jreplace
from camera_calibration_tpu.ops import manifolds as jman
from torch_threads import one_torch_thread  # noqa: F401

REL = dict(rtol=1e-9, atol=1e-12)
STATE_TOL = dict(rtol=1e-9, atol=1e-10)


@pytest.fixture(scope="module")
def problem():
    """(JAX ground-truth state, JAX perturbed state, JAX tables, the port's
    perturbed state and tables)."""
    state_gt, data = graft._make_problem(dtype=jnp.float64, n_points=50,
                                         n_poses=10)
    seg = data[0]
    central = state_gt.intrinsics[0]
    gh, gw = central.grid.shape[:2]
    yy, xx = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    origins = np.stack([0.002 * np.sin(xx / 2.0), 0.002 * np.cos(yy / 2.0),
                        np.zeros_like(xx, float)], -1)
    model = jreplace(jncg.from_central(central),
                     point_grid=jnp.asarray(origins))
    state_gt = dataclasses.replace(state_gt, intrinsics=(model,))
    x_cam, _ = jstate.transform_to_camera(
        state_gt, seg.imageset, seg.camera, state_gt.points[seg.point])
    px, _, valid = jax.jit(lambda x: jncg.project_points(
        model, x, max_iterations=80))(x_cam)
    data = (dataclasses.replace(seg, pixel=px, valid=seg.valid & valid),)
    state0 = ba_harness.perturb_state(state_gt, seed=7, pose_rot=0.005,
                                      pose_t=0.005, point_sigma=0.002,
                                      knot_sigma=0.0)
    rng = np.random.default_rng(8)
    m0 = state0.intrinsics[0]
    m0 = jreplace(
        m0,
        direction_grid=jman.retract_direction(
            m0.direction_grid, jnp.asarray(rng.normal(0, 5e-4, (gh, gw, 2)))),
        point_grid=m0.point_grid + jnp.asarray(rng.normal(0, 5e-4,
                                                          (gh, gw, 3))))
    state0 = dataclasses.replace(state0, intrinsics=(m0,))
    assert data[0].grid_shape == (10, 50)
    ts = convert.ba_state(state0, device="cpu")
    td = tuple(convert.observation_table(s, device="cpu") for s in data)
    return state_gt, state0, data, ts, td


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or REL))


def _assert_state(ts, js):
    for name in ("rig_q_global", "rig_t_global", "cam_q_rig", "cam_t_rig",
                 "points"):
        _close(getattr(ts, name), getattr(js, name), **STATE_TOL)
    for tm, jm in zip(ts.intrinsics, js.intrinsics):
        # Both grids to 1e-9 of the scene's unit scale (unit directions;
        # origins in meters, ~2 m from the points).  The origin field is
        # nearly degenerate with the camera translation, so the CG's
        # rounding shows there first (~3e-10 after two steps).
        for name in ("direction_grid", "point_grid"):
            _close(getattr(tm, name), getattr(jm, name), rtol=0, atol=1e-9)


def test_model_functions(problem):
    state_gt, _, data, _, _ = problem
    jm = state_gt.intrinsics[0]
    tm = convert.camera_model(jm, device="cpu")
    assert isinstance(tm, tncg.NoncentralGenericModel)
    assert (tm.grid_height, tm.grid_width) == (7, 7) and not tm.is_central
    x_cam, _ = jstate.transform_to_camera(
        state_gt, jnp.repeat(jnp.arange(10), 50), jnp.zeros(500, jnp.int32),
        jnp.tile(state_gt.points, (10, 1)))
    rng = np.random.default_rng(1)
    warm = np.asarray(data[0].pixel) + rng.normal(0, 1.0, (500, 2))
    for init, iters in ((None, 40), (warm, 6)):
        jinit = None if init is None else jnp.asarray(init)
        px, g, valid = jax.jit(lambda x, i: jncg.project_points(
            jm, x, init_xy=i, max_iterations=iters))(x_cam, jinit)
        tpx, tg, tvalid = tncg.project_points(
            tm, _t(x_cam), init_xy=None if init is None else _t(init),
            max_iterations=iters)
        _close(tpx, px, rtol=1e-9, atol=1e-9)
        _close(tg, g, rtol=1e-9, atol=1e-10)
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
        assert int(tvalid.sum()) > 400
    blocks = jax.jit(lambda g_, x: jncg.projection_blocks(jm, g_, x))(g, x_cam)
    tblocks = tncg.projection_blocks(tm, _t(g), _t(x_cam))
    np.testing.assert_array_equal(tblocks["win_flat"].numpy(),
                                  np.asarray(blocks["win_flat"]))
    for key in ("pix_wrt_x", "j_win"):  # every window lies inside the grid
        assert tblocks[key].shape == blocks[key].shape
        scale = float(np.abs(np.asarray(blocks[key])).max())
        _close(tblocks[key], blocks[key], rtol=0, atol=1e-12 * scale)
    pix = jnp.asarray(rng.uniform([-5, -5], [70, 55], (300, 2)))
    d, o, inside = jncg.unproject(jm, pix)
    td, to, tinside = tncg.unproject(tm, _t(pix))
    _close(td, d)
    _close(to, o, rtol=1e-9, atol=1e-15)
    np.testing.assert_array_equal(tinside.numpy(), np.asarray(inside))
    tdir, tvalid = tprot.unproject(tm, _t(pix))
    _close(tdir, jprot.unproject(jm, pix)[0])
    # from a central model: the same directions, zero origins
    central = convert.central_generic_model(
        {"grid": np.asarray(jm.direction_grid), "width": 64, "height": 48},
        device="cpu")
    nc = tncg.from_central(central)
    assert torch.equal(nc.direction_grid, central.grid)
    assert not nc.point_grid.any() and nc.width == 64


def test_segment_blocks_and_cost(problem):
    _, state0, data, ts, td = problem
    seg, tseg = data[0], td[0]
    model = state0.intrinsics[0]
    warm = seg.pixel
    kw = dict(huber_px=1.0, max_proj_iterations=6, grid_shape=seg.grid_shape)

    def jax_fn(s, w):
        b, nw = jres.segment_blocks(model, s, seg.imageset, seg.camera,
                                    seg.point, seg.pixel, seg.valid, w, **kw)
        c = jres.segment_cost(model, s, seg.imageset, seg.camera, seg.point,
                              seg.pixel, seg.valid, w, **kw)
        return b, nw, c

    bj, wj, cj = jax.jit(jax_fn)(state0, warm)
    bt, wt = tres.segment_blocks(ts.intrinsics[0], ts, tseg.imageset,
                                 tseg.camera, tseg.point, tseg.pixel,
                                 tseg.valid, tseg.pixel, **kw)
    ct = tres.segment_cost(ts.intrinsics[0], ts, tseg.imageset, tseg.camera,
                           tseg.point, tseg.pixel, tseg.valid, tseg.pixel,
                           **kw)
    valid = np.array(bj.valid)
    np.testing.assert_array_equal(bt.valid.numpy(), valid)
    assert valid.sum() > 400 and bt.intr.k_tangent == 5
    for name in ("r", "j_rig", "j_cam", "j_point", "weight", "cost"):
        _close(getattr(bt, name), getattr(bj, name), rtol=1e-9, atol=1e-12)
    assert bt.intr.j_win.shape == (160, 500)
    assert bt.intr.j_win.is_contiguous()
    assert bt.intr.base_xy.dtype == torch.int32
    np.testing.assert_array_equal(bt.intr.base_xy.numpy(),
                                  np.asarray(bj.intr.base_xy))
    scale = float(np.abs(np.asarray(bj.intr.j_win)).max())
    _close(bt.intr.j_win, bj.intr.j_win, rtol=0, atol=1e-12 * scale)
    _close(wt, wj, rtol=0, atol=1e-9)
    for a, b in zip(ct, cj):
        _close(a, b, rtol=1e-9, atol=1e-12)


def test_scale_state_protocol_and_convert(problem):
    _, state0, _, ts, _ = problem
    _assert_state(tstate.scale_state(ts, 2.5), jstate.scale_state(state0, 2.5))
    jm, tm = state0.intrinsics[0], ts.intrinsics[0]
    zero = tprot.intrinsics_tangent_zero(tm)
    assert zero.shape == jprot.intrinsics_tangent_zero(jm).shape == (7, 7, 5)
    assert tprot.is_grid_model(tm)
    tangent = np.random.default_rng(2).normal(0, 1e-3, (7, 7, 5))
    for scale in (1.0, -0.5):
        got = tprot.intrinsics_retract(tm, _t(tangent), scale)
        want = jprot.intrinsics_retract(jm, jnp.asarray(tangent), scale)
        _close(got.direction_grid, want.direction_grid)
        _close(got.point_grid, want.point_grid)
    # the gauge mask covers 5 values per knot
    mask = tstate.fix_gauge_mask(ts, ("intrinsics",))
    assert mask.intr[0].shape == (7, 7, 5) and not mask.intr[0].any()
    # numpy out and back in
    back = convert.state_to_numpy(ts)
    intr = back["intrinsics"][0]
    assert set(intr) == {"direction_grid", "point_grid"}
    again = convert.ba_state(
        dict(back, intrinsics=[dict(intr, width=64, height=48,
                                    calibration_max_x=63,
                                    calibration_max_y=47)]),
        device="cpu")
    assert torch.equal(again.intrinsics[0].point_grid, tm.point_grid)
    assert torch.equal(again.points, ts.points)
    assert again.intrinsics[0] == dataclasses.replace(
        tm, direction_grid=again.intrinsics[0].direction_grid,
        point_grid=again.intrinsics[0].point_grid)


def _options(solver, **kw):
    kw = dict(dict(max_pcg_iterations=20, proj_iterations=6, solver=solver),
              **kw)
    return J.BAOptions(**kw), T.BAOptions(**kw)


@pytest.mark.parametrize("solver", ["schur", "schur_poses"])
@pytest.mark.parametrize("cached", [False, True])
def test_lm_step(problem, solver, cached):
    _, state0, data, ts, td = problem
    oj, ot = _options(solver)
    warm_j = tuple(s.pixel for s in data)
    warm_t = tuple(s.pixel for s in td)
    lam_j = jnp.asarray(-1.0, jnp.float64)
    lam_t = torch.tensor(-1.0, dtype=torch.float64)
    if cached:
        sj, wj, lj, outs_j = J.make_lm_scan(oj, 2)(state0, warm_j, lam_j, data)
        st, wt, lt, outs_t = T.make_lm_scan(ot, 2)(ts, warm_t, lam_t, td)
        outs_j = [np.asarray(o) for o in outs_j]
        assert list(outs_t[0]) == list(outs_j[0])
        assert list(outs_t[3]) == [int(i) for i in outs_j[3]]
        for a, b in zip(outs_t[1:], outs_j[1:]):
            _close(a, b)
        assert all(outs_t[0])
    else:
        ref = J.make_lm_step(oj)(state0, warm_j, lam_j, data)
        got = T.make_lm_step(ot)(ts, warm_t, lam_t, td)
        sj, wj, lj, st, wt, lt = ref[0], ref[1], ref[2], got[0], got[1], got[2]
        assert got[3] == bool(ref[3]) and got[3]
        assert got[6] == int(ref[6]) > 0
        for i in (4, 5, 7, 8):
            _close(float(got[i]), float(ref[i]))
    _assert_state(st, sj)
    _close(float(lt), float(lj))
    for a, b in zip(wt, wj):
        _close(a, b, rtol=0, atol=1e-8)


def test_optimize_history(problem):
    _, state0, data, ts, td = problem
    oj, ot = _options("schur", max_lm_iterations=4)
    sj, info_j = J.optimize(state0, None, None, oj, data=data)
    st, info_t = T.optimize(ts, None, None, ot, data=td)
    hj, ht = info_j["history"], info_t["history"]
    assert len(ht) == len(hj) == 4
    for a, b in zip(ht, hj):
        for key in ("iteration", "accepted", "pcg_iterations"):
            assert a[key] == b[key], key
        for key in ("cost", "new_cost", "paired_cost", "paired_new_cost",
                    "lambda"):
            _close(a[key], b[key])
    assert ht[-1]["new_cost"] < 0.1 * ht[0]["cost"]
    _assert_state(st, sj)


def test_noncentral_bench_problem_small():
    """The port's noncentral bench problem at 16 poses × 128 points: a
    noncentral state with the origin field, most rows valid, and an LM run
    that lowers the paired cost through the K=5 window path."""
    state, data, meta = problems.make_noncentral_bench_problem(
        n_points=128, n_poses=16, device="cpu")
    model = state.intrinsics[0]
    assert isinstance(model, tncg.NoncentralGenericModel)
    assert model.direction_grid.dtype == torch.float32
    assert float(model.point_grid.abs().max()) > 1e-3
    assert data[0].grid_shape == (16, 128) and meta["n_obs"] > 1500
    options = T.BAOptions(max_lm_iterations=2, max_pcg_iterations=10)
    _, info = T.optimize(state, None, None, options, data=data)
    hist = info["history"]
    assert hist[0]["accepted"]
    assert hist[-1]["paired_new_cost"] < hist[0]["paired_cost"]


def _bench_model(dtype, gh=16, gw=16):
    """The noncentral bench problem's camera: a 640×480 pinhole direction
    grid and the line-origin field (0.002·sin(x/2), 0.002·cos(y/2), 0)."""
    yy, xx = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    origins = np.stack([0.002 * np.sin(xx / 2.0), 0.002 * np.cos(yy / 2.0),
                        np.zeros_like(xx, float)], -1)
    central = problems.pinhole_model(640, 480, gw, gh, device="cpu",
                                     dtype=dtype)
    return replace(tncg.from_central(central),
                   point_grid=torch.as_tensor(origins, dtype=dtype))


def _projection_inputs(model, n=2048, seed=3):
    """Points on the lines of random pixels at 0.5–3 m, and warm starts 0,
    0.3, 3 and 30 px off in turn; every 16th warm start lies far off the
    image, so its window leaves the grid (a negative base counts from the
    far end, then is held inside)."""
    dtype = model.direction_grid.dtype
    rng = np.random.default_rng(seed)
    pix = torch.as_tensor(rng.uniform([2, 2], [638, 478], (n, 2)),
                          dtype=dtype)
    d, o, _ = tncg.unproject(model, pix)
    depth = torch.as_tensor(rng.uniform(0.5, 3.0, (n, 1)), dtype=dtype)
    points = o + depth * d
    scale = torch.tensor([0.0, 0.3, 3.0, 30.0], dtype=dtype).repeat(n // 4)
    warm = pix + scale[:, None] * torch.as_tensor(rng.normal(0, 1, (n, 2)),
                                                  dtype=dtype)
    far = torch.tensor([[-100.0, 240.0], [760.0, 240.0], [320.0, -90.0],
                        [320.0, 600.0], [-300.0, -300.0], [2000.0, 1500.0]],
                       dtype=dtype)
    warm[::16] = far[torch.arange(n // 16) % far.shape[0]]
    return points, warm


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_loop_without_host_test_is_project_points(dtype):
    """Per-point exit gives the plain loop's result: the loop run for all
    ``max_iterations`` with per-point ``done`` (what the kernel does:
    ``noncentral_generic_cuda.lm_loop_plain``) and
    ``project_points`` (which leaves once every point is done) agree bit
    for bit, with points done at different iterations and windows off the
    grid."""
    model = _bench_model(dtype)
    points, warm = _projection_inputs(model)
    eps = 1e-10 if dtype == torch.float32 else 1e-16

    def both(points, warm, iters):
        reads = tracing.host_reads["ncg.project"]
        px, g, valid = tncg.project_points(model, points, init_xy=warm,
                                           max_iterations=iters)
        loop_tests = tracing.host_reads["ncg.project"] - reads
        px_f, g_f, valid_f, done_at = tncgc.lm_loop_plain(
            model, points, warm, iters, eps)
        assert torch.equal(px, px_f) and torch.equal(g, g_f)
        assert torch.equal(valid, valid_f)
        assert len(set(done_at.tolist()) - {-1}) >= 3
        return valid, loop_tests, done_at

    # some far warm starts never reach eps, so the plain loop runs on
    valid, _, done_at = both(points, warm, 4)
    assert int(valid.sum()) > 0.9 * points.shape[0]
    valid, loop_tests, done_at = both(points, warm, 50)
    assert loop_tests == 50 and int((done_at < 0).sum()) > 0
    # the points that are done: the plain loop leaves early
    keep = done_at >= 0
    _, loop_tests, done_at = both(points[keep], warm[keep], 50)
    assert bool((done_at >= 0).all()) and loop_tests < 50
    # the far warm starts begin in windows that the start rule moved
    g0 = tncg.pixel_to_grid(model, warm[::16])
    base = torch.floor(g0).long() - 1
    assert bool((base < 0).any()) and bool((base > 16 - 4).any())


def test_wrapper_clamp_bounds_are_pixel_to_grid_of_the_corners():
    """The kernel's clamp range, Python floats from the model's integer
    bounds (``central_generic._static_clamp_bounds``, which the wrapper
    passes), is the plain loop's ``pixel_to_grid`` of the corners."""
    for gh, gw in ((16, 16), (45, 79)):
        model = replace(_bench_model(torch.float64, gh, gw),
                        calibration_min_x=3, calibration_min_y=5,
                        calibration_max_x=630, calibration_max_y=471)
        lo, hi = tcg._static_clamp_bounds(model)
        assert all(type(v) is float for v in lo + hi)
        corners = torch.tensor([[3.0, 5.0], [630.999, 471.999]],
                               dtype=torch.float64)
        want = tncg.pixel_to_grid(model, corners)
        assert torch.equal(torch.tensor([lo, hi], dtype=torch.float64), want)


def test_cpu_call_goes_to_the_plain_function():
    model = _bench_model(torch.float32)
    points, warm = _projection_inputs(model, n=256)
    launches = dict(_cuda.launches)
    reads = tracing.host_reads["ncg.project"]
    got = tncgc.project_points(model, points, init_xy=warm, max_iterations=6)
    assert tracing.host_reads["ncg.project"] > reads
    want = tncg.project_points(model, points, init_xy=warm, max_iterations=6)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    got = tncgc.project_points(model, points, max_iterations=6)
    want = tncg.project_points(model, points, max_iterations=6)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert dict(_cuda.launches) == launches

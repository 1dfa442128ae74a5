"""Port parity: the CentralGeneric model and its projection blocks.

The same float64 inputs, drawn from a numpy seed, go through the JAX
package (its XLA path, which is what the CPU runs) and the port's plain
PyTorch path on the CPU:

- ``project_directions`` and ``projection_sensitivities``;
- ``residuals._grid_projection_blocks`` (pixels, validity, d px / d x_cam,
  the window knot Jacobian ``j_win`` and its window base) and
  ``residuals.segment_blocks``.

Some warm starts lie far outside the image, so the first evaluation of the
projection reaches knots outside the grid, which must weigh 0.

Tolerances: both sides run the same float64 arithmetic in another
summation order, so values agree to 1e-9 (pixels) and 1e-9 relative
(Jacobians); validity and window bases must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camera_calibration_torch import convert
from camera_calibration_torch.ba import residuals as tres
from camera_calibration_torch.ba import state as tstate
from camera_calibration_torch.models import central_generic as tcg
from camera_calibration_torch.ops import manifolds as tman
from camera_calibration_tpu.ba import residuals as jres
from camera_calibration_tpu.ba import state as jstate
from camera_calibration_tpu.models import central_generic as jcg
from camera_calibration_tpu.ops import manifolds as jman

W, H = 64, 48
PX_TOL = dict(rtol=0.0, atol=1e-9)
REL_TOL = dict(rtol=1e-9, atol=1e-9)


def _models(gh, gw, seed):
    """A distorted pinhole-like direction grid as a JAX and a port model."""
    rng = np.random.default_rng(seed)
    f = 0.85 * W
    yy, xx = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    px = (xx - 1.0) / (gw - 3.0) * W
    py = (yy - 1.0) / (gh - 3.0) * H
    dirs = np.stack([(px - W / 2) / f, (py - H / 2) / f,
                     np.ones_like(px, float)], -1)
    dirs += rng.normal(0, 0.01, dirs.shape)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    fields = dict(width=W, height=H, calibration_min_x=0, calibration_min_y=0,
                  calibration_max_x=W - 1, calibration_max_y=H - 1)
    jm = jcg.CentralGenericModel(grid=jnp.asarray(dirs), **fields)
    tm = convert.central_generic_model(jm, device="cpu")
    return jm, tm


def _projection_inputs(jm, seed, n=60):
    """Unit directions of random pixels, warm starts near them, a few warm
    starts far outside the image and one direction that cannot project."""
    rng = np.random.default_rng(seed)
    pix = rng.uniform([0.5, 0.5], [W - 0.5, H - 0.5], (n, 2))
    dirs = np.array(jcg.unproject(jm, jnp.asarray(pix))[0])
    warm = pix + rng.normal(0, 3.0, pix.shape)
    warm[:6] = [[-20.0, -15.0], [W + 20.0, H / 2], [W / 2, -30.0],
                [W / 2, H + 25.0], [-40.0, H + 40.0], [W + 5.0, -5.0]]
    dirs[-1] = [0.0, 0.0, -1.0]
    return dirs, warm


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("gh,gw", [(7, 7), (7, 9)])
def test_grid_mapping_and_unproject(gh, gw):
    jm, tm = _models(gh, gw, seed=1)
    rng = np.random.default_rng(2)
    xy = rng.uniform(-5, 70, (30, 2))
    np.testing.assert_allclose(tcg.pixel_to_grid(tm, _t(xy)),
                               jcg.pixel_to_grid(jm, jnp.asarray(xy)), **PX_TOL)
    g = rng.uniform(0, gw - 1, (30, 2))
    np.testing.assert_allclose(tcg.grid_to_pixel(tm, _t(g)),
                               jcg.grid_to_pixel(jm, jnp.asarray(g)), **PX_TOL)
    assert tcg.pixel_scale_to_grid_scale(tm) == jcg.pixel_scale_to_grid_scale(jm)
    lo, hi = jcg._grid_clamp_bounds(jm)
    lo_t, hi_t = tcg._static_clamp_bounds(tm)
    np.testing.assert_allclose(lo_t, lo, **PX_TOL)
    np.testing.assert_allclose(hi_t, hi, **PX_TOL)
    for a, b in zip(tcg._grid_clamp_bounds(tm), (lo, hi)):
        np.testing.assert_allclose(a, b, **PX_TOL)
    got_d, got_v = tcg.unproject(tm, _t(xy))
    ref_d, ref_v = jcg.unproject(jm, jnp.asarray(xy))
    np.testing.assert_allclose(got_d, ref_d, **REL_TOL)
    np.testing.assert_array_equal(got_v, ref_v)


@pytest.mark.parametrize("gh,gw,iters,warm", [
    (7, 7, 50, False), (7, 9, 50, True), (9, 7, 4, True)])
def test_project_directions(gh, gw, iters, warm):
    jm, tm = _models(gh, gw, seed=3)
    dirs, warm_xy = _projection_inputs(jm, seed=4)
    init_j = jnp.asarray(warm_xy) if warm else None
    init_t = _t(warm_xy) if warm else None
    ref = jcg.project_directions(jm, jnp.asarray(dirs), init_j,
                                 max_iterations=iters)
    got = tcg.project_directions(tm, _t(dirs), init_t, max_iterations=iters)
    np.testing.assert_array_equal(got[2], ref[2])
    assert int(np.sum(np.asarray(ref[2]))) >= 40
    assert not bool(got[2][-1])  # the backward direction does not project
    np.testing.assert_allclose(got[0], ref[0], **PX_TOL)
    np.testing.assert_allclose(got[1], ref[1], **PX_TOL)

    # project_points normalizes first and rejects zero-length points
    pts = dirs * np.linspace(0.5, 3.0, len(dirs))[:, None]
    pts[0] = 0.0
    ref_p = jcg.project_points(jm, jnp.asarray(pts), init_j,
                               max_iterations=iters)
    got_p = tcg.project_points(tm, _t(pts), init_t, max_iterations=iters)
    np.testing.assert_array_equal(got_p[2], ref_p[2])
    assert not bool(got_p[2][0])
    both = np.asarray(ref_p[2])
    np.testing.assert_allclose(got_p[0].numpy()[both],
                               np.asarray(ref_p[0])[both], **PX_TOL)


def test_projection_sensitivities():
    jm, tm = _models(7, 9, seed=5)
    rng = np.random.default_rng(6)
    g = rng.uniform([1.0, 1.0], [6.99, 4.99], (40, 2))
    ref = jcg.projection_sensitivities(jm, jnp.asarray(g))
    got = tcg.projection_sensitivities(tm, _t(g))
    assert set(got) == set(ref)
    for key in ("pix_wrt_dir", "pn", "weights"):
        np.testing.assert_allclose(got[key], ref[key], **REL_TOL)
    np.testing.assert_array_equal(got["base_xy"], ref["base_xy"])


def _inside_knots(base, gh, gw):
    """(16, N) mask of the window knots [y, x] that lie inside the grid."""
    off = np.arange(4)
    kx = base[:, 0][:, None] + off
    ky = base[:, 1][:, None] + off
    m = ((ky >= 0) & (ky < gh))[:, :, None] & ((kx >= 0) & (kx < gw))[:, None, :]
    return m.reshape(len(base), 16).T


@pytest.mark.parametrize("gh,gw", [(7, 7), (7, 9)])
def test_grid_projection_blocks(gh, gw):
    jm, tm = _models(gh, gw, seed=7)
    dirs, warm_xy = _projection_inputs(jm, seed=8)
    x_cam = dirs * np.linspace(1.0, 2.0, len(dirs))[:, None]
    frames_j = jman.direction_tangents(jm.grid)
    frames_t = tman.direction_tangents(tm.grid)
    for a, b in zip(frames_t, frames_j):
        np.testing.assert_allclose(a, b, **REL_TOL)
    ref = jres._grid_projection_blocks(jm, jnp.asarray(x_cam),
                                       jnp.asarray(warm_xy), 8, frames_j)
    got = tres._grid_projection_blocks(tm, _t(x_cam), _t(warm_xy), 8, frames_t)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[0], ref[0], **PX_TOL)
    np.testing.assert_allclose(got[2], ref[2], **REL_TOL)
    gi, ri = got[3], ref[3]
    assert gi.k_tangent == ri.k_tangent == 2
    base = np.asarray(ri.base_xy)
    np.testing.assert_array_equal(gi.base_xy, base)
    # The reference gathers knots outside the grid through a clamped index;
    # every consumer masks them, so only knots inside the grid are compared.
    inside = np.tile(np.repeat(_inside_knots(base, gh, gw), 2, axis=0), (2, 1))
    jw_t, jw_j = gi.j_win.numpy(), np.asarray(ri.j_win)
    assert jw_t.shape == jw_j.shape == (64, len(dirs))
    np.testing.assert_allclose(jw_t[inside], jw_j[inside], **REL_TOL)
    # outside knots weigh 0 (NaN only where the projection itself is NaN:
    # a warm start whose whole window lies off the grid, never valid)
    outside = jw_t[~inside]
    assert np.all(outside[np.isfinite(outside)] == 0.0)
    assert np.all(np.isfinite(jw_t[:, np.asarray(ref[1])]))


def test_segment_blocks_and_cost():
    """Residuals, every Jacobian block and the cost pass on a few posed
    observations (flat table), with invalid columns zeroed."""
    jm, tm = _models(7, 9, seed=9)
    rng = np.random.default_rng(10)
    m, p, n = 3, 20, 50
    q = rng.normal(size=(m, 4)) * [1.0, 0.05, 0.05, 0.05]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    arrays = dict(
        rig_q_global=q, rig_t_global=rng.normal(0, 0.1, (m, 3)) + [0, 0, 2.0],
        cam_q_rig=np.array([[1.0, 0, 0, 0]]), cam_t_rig=np.zeros((1, 3)),
        points=rng.uniform(-0.6, 0.6, (p, 3)) * [1, 1, 0.05])
    js = jstate.BAState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                        intrinsics=(jm,))
    ts = convert.ba_state(dict(arrays, intrinsics=(jm,)), device="cpu")
    ims = rng.integers(0, m, n)
    pts = rng.integers(0, p, n)
    cams = np.zeros(n, np.int64)
    measured = rng.uniform(0, [W, H], (n, 2))
    obs_valid = rng.uniform(size=n) > 0.1
    warm = measured + rng.normal(0, 2.0, (n, 2))
    warm[:3] = [[-30.0, -30.0], [W + 30.0, 10.0], [10.0, H + 30.0]]
    jargs = [jnp.asarray(a) for a in (ims, cams, pts, measured, obs_valid, warm)]
    targs = [_t(a) for a in (ims, cams, pts, measured, obs_valid, warm)]
    kw = dict(huber_px=1.0, max_proj_iterations=6)
    rb, rw = jres.segment_blocks(jm, js, *jargs, **kw)
    gb, gw_ = tres.segment_blocks(tm, ts, *targs, **kw)
    np.testing.assert_array_equal(gb.valid, rb.valid)
    assert 0 < int(np.sum(np.asarray(rb.valid))) < n
    for name in ("r", "j_rig", "j_cam", "j_point", "weight", "cost"):
        np.testing.assert_allclose(getattr(gb, name), getattr(rb, name),
                                   **REL_TOL, err_msg=name)
    np.testing.assert_allclose(gb.intr.j_win, rb.intr.j_win, **REL_TOL)
    valid = np.asarray(rb.valid)
    np.testing.assert_array_equal(gb.intr.base_xy.numpy()[valid],
                                  np.asarray(rb.intr.base_xy)[valid])
    np.testing.assert_allclose(gw_, rw, **PX_TOL)

    rc = jres.segment_cost(jm, js, *jargs, **kw)
    gc = tres.segment_cost(tm, ts, *targs, **kw)
    np.testing.assert_array_equal(gc[1], rc[1])
    np.testing.assert_allclose(gc[0], rc[0], **REL_TOL)
    np.testing.assert_allclose(gc[2], rc[2], **PX_TOL)

    # grid-layout broadcasts give the same camera-space points as gathers
    gs = (m, p)
    ims_g = np.repeat(np.arange(m), p)
    pts_g = np.tile(np.arange(p), m)
    x = tstate.broadcast_rows(ts.points, _t(pts_g), gs, 1)
    xc, xr = tstate.transform_to_camera(ts, _t(ims_g), _t(np.zeros(m * p, int)),
                                        x, grid_shape=gs)
    xc_j, xr_j = jstate.transform_to_camera(
        js, jnp.asarray(ims_g), jnp.zeros(m * p, jnp.int32),
        js.points[jnp.asarray(pts_g)])
    np.testing.assert_allclose(xc, xc_j, **REL_TOL)
    np.testing.assert_allclose(xr, xr_j, **REL_TOL)

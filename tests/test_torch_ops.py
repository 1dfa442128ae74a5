"""Port parity: ``camera_calibration_torch.ops`` against the JAX package.

The same float64 inputs, drawn from a numpy seed, go through the JAX
function (its XLA path on the CPU) and the port's PyTorch function on the
CPU.  Tolerance: 1e-12 relative/absolute — both sides run float64 closed
forms that differ only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camera_calibration_torch.ops import bspline as tb
from camera_calibration_torch.ops import linalg as tl
from camera_calibration_torch.ops import losses as tlo
from camera_calibration_torch.ops import manifolds as tm
from camera_calibration_torch.ops import se3 as ts
from camera_calibration_torch.ops import segsum as tseg
from camera_calibration_tpu.ops import bspline as jb
from camera_calibration_tpu.ops import linalg as jl
from camera_calibration_tpu.ops import losses as jlo
from camera_calibration_tpu.ops import manifolds as jm
from camera_calibration_tpu.ops import se3 as js
from camera_calibration_tpu.ops import segsum as jseg

TOL = dict(rtol=1e-12, atol=1e-12)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               **(tol or TOL))


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quaternion_ops(rng):
    a, b = _unit_quats(rng, 16), rng.normal(size=(16, 4))
    v = rng.normal(size=(16, 3))
    _close(ts.quat_normalize(_t(b)), js.quat_normalize(jnp.asarray(b)))
    _close(ts.quat_mul(_t(a), _t(b)), js.quat_mul(jnp.asarray(a), jnp.asarray(b)))
    _close(ts.quat_rotate(_t(a), _t(v)),
           js.quat_rotate(jnp.asarray(a), jnp.asarray(v)))
    _close(ts.quat_to_matrix(_t(a)), js.quat_to_matrix(jnp.asarray(a)))


@pytest.mark.parametrize("scale", [1e-10, 1e-3, 0.7])
def test_quat_exp_and_retract_pose(rng, scale):
    u = rng.normal(size=(12, 6)) * scale
    q, t = _unit_quats(rng, 12), rng.normal(size=(12, 3))
    _close(ts.quat_exp(_t(u[:, :3])), js.quat_exp(jnp.asarray(u[:, :3])))
    got = ts.retract_pose(_t(q), _t(t), _t(u))
    ref = js.retract_pose(jnp.asarray(q), jnp.asarray(t), jnp.asarray(u))
    for g, r in zip(got, ref):
        _close(g, r)


def test_direction_manifold(rng):
    d = rng.normal(size=(64, 3))
    d[:8, 0] = 5.0  # |d.x| > 0.9 picks the other helper axis
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    delta = rng.normal(size=(64, 2)) * 0.1
    for g, r in zip(tm.direction_tangents(_t(d)),
                    jm.direction_tangents(jnp.asarray(d))):
        _close(g, r)
    _close(tm.retract_direction(_t(d), _t(delta)),
           jm.retract_direction(jnp.asarray(d), jnp.asarray(delta)))


def test_huber(rng):
    sq = rng.uniform(0, 4, 100)
    _close(tlo.huber_cost(_t(sq), 1.0), jlo.huber_cost(jnp.asarray(sq), 1.0))
    _close(tlo.huber_weight(_t(sq), 1.0), jlo.huber_weight(jnp.asarray(sq), 1.0))


@pytest.mark.parametrize("k", [2, 3, 6])
def test_small_inverses(rng, k):
    m = rng.normal(size=(20, k, k))
    spd = m @ np.swapaxes(m, -1, -2) + 0.5 * np.eye(k)
    _close(tl.inv_spd_blocks(_t(spd)), jl.inv_spd_blocks(jnp.asarray(spd)),
           rtol=1e-10, atol=1e-10)
    if k == 2:
        b = rng.normal(size=(20, 2))
        _close(tl.solve2x2(_t(spd), _t(b)), jl.solve2x2(jnp.asarray(spd), jnp.asarray(b)))
        _close(tl.inv_2x2(_t(spd)), jl.inv_2x2(jnp.asarray(spd)))
        sing = np.zeros((3, 2, 2))
        _close(tl.solve2x2(_t(sing), _t(b[:3])), np.zeros((3, 2)))
    if k == 3:
        _close(tl.inv_3x3(_t(spd)), jl.inv_3x3(jnp.asarray(spd)), rtol=1e-10, atol=1e-10)
    if k == 6:
        _close(tl.inv_spd_6x6(_t(spd)), jl.inv_spd_6x6(jnp.asarray(spd)),
               rtol=1e-10, atol=1e-10)


def test_bspline_weights(rng):
    t = rng.uniform(0, 1, 50)
    _close(tb.cubic_bspline_weights(_t(t)), jb.cubic_bspline_weights(jnp.asarray(t)))
    _close(tb.cubic_bspline_weight_derivs(_t(t)),
           jb.cubic_bspline_weight_derivs(jnp.asarray(t)))


def test_surface_gather_matches_dense_form(rng):
    """The 4×4 window gather equals the dense one-hot contraction, also for
    points whose window reaches outside the grid (those knots get weight
    0, never a clamped index)."""
    grid = rng.normal(size=(7, 9, 3))
    inside = rng.uniform([1.0, 1.0], [6.0, 4.0], (40, 2))
    edge = np.array([[0.3, 2.5], [8.6, 3.1], [4.2, -0.4], [2.0, 6.7],
                     [-0.9, -0.2], [8.9, 6.9]])
    g = np.concatenate([inside, edge])
    ref_v, ref_j = jb.eval_surface_dense_with_jac(jnp.asarray(grid), jnp.asarray(g))
    got_v, got_j = tb.eval_surface_with_jac(_t(grid), _t(g))
    _close(got_v, ref_v)
    _close(got_j, ref_j)
    _close(tb.eval_surface(_t(grid), _t(g)),
           jb.eval_surface_dense(jnp.asarray(grid), jnp.asarray(g)))


def test_segment_sum(rng):
    vals = rng.normal(size=(50, 3, 2))
    ids = rng.integers(-2, 9, 50).astype(np.int32)  # some out of range
    _close(tseg.onehot_segment_sum(_t(vals), _t(ids), 7),
           jseg.onehot_segment_sum(jnp.asarray(vals), jnp.asarray(ids), 7))

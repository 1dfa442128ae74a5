"""Port parity: the parametric camera models and the generic LM.

The JAX package (its XLA path on the CPU) and the port on the CPU get the
same inputs, made with numpy from a seed, in float64:

- ThinPrismFisheye (equidistant and plain), OpenCV and Radial, the models
  of ``tests/test_parametric.py``: ``project_points``, ``unproject`` and
  ``projection_point_jacobian`` to 1e-12 relative;
- ``gn.lm_solve`` (tuple state, IRLS weights, a given λ) and
  ``fit_parametric_to_dense`` on a 160×120 direction image, with and
  without the co-estimated rotation: the state and the cost to 1e-9 (of
  max(|p|, 1) for parameters, of the norm for a quaternion).

Bundle adjustment of a parametric camera is in
``tests/test_torch_parametric_ba.py``.

The OpenCV fit is held to 8 LM iterations: its rational radial factor
leaves a nearly flat valley among k1..k6, along which the fit creeps for
tens of iterations, and the two packages' last-bit differences (2e-12 after
8 iterations) grow there until single coefficients part by 30% after 30,
while the fitted pixels still agree to 3e-6 px.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camera_calibration_torch import convert, problems
from camera_calibration_torch.ba import gn as tgn
from camera_calibration_torch.models import parametric as tpm
from camera_calibration_torch.models import pinhole as tpin
from camera_calibration_torch.models import protocol as tproto
from camera_calibration_torch.ops import se3 as tse3
from camera_calibration_tpu.ba import gn as jgn
from camera_calibration_tpu.models import parametric as jpm
from camera_calibration_tpu.models import pinhole as jpin
from camera_calibration_tpu.models import protocol as jproto
from camera_calibration_tpu.ops import se3 as jse3
from test_parametric import _opencv_model, _radial_model, _tpf_model
from torch_threads import one_torch_thread  # noqa: F401

TIGHT = dict(rtol=1e-12, atol=1e-12)
REL = dict(rtol=1e-9, atol=1e-12)
# fitted parameters range from ~100 (focal lengths) to ~1e-4 (tangential
# terms): 1e-9 of max(|p|, 1), the scale the reference package's harness
# perturbs them by
PARAM_TOL = dict(rtol=1e-9, atol=1e-9)
MODELS = {"tpf_equidistant": lambda: _tpf_model(True),
          "tpf_plain": lambda: _tpf_model(False),
          "opencv": _opencv_model, "radial": _radial_model}


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, ref, tol=TIGHT, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **tol,
                               err_msg=err_msg)


@pytest.fixture(scope="module", params=list(MODELS))
def model_pair(request):
    jm = MODELS[request.param]()
    return jm, convert.camera_model(jm, device="cpu")


@pytest.fixture(scope="module")
def points():
    """Camera-space points: most project inside the 640×480 image, some lie
    behind the camera or outside the image."""
    rng = np.random.default_rng(4)
    nxy = rng.uniform(-0.9, 0.9, (400, 2))
    z = rng.uniform(0.5, 3.0, 400)
    pts = np.concatenate([nxy * z[:, None], z[:, None]], -1)
    pts[::50, 2] *= -1.0
    return pts


def test_projection_matches_reference(model_pair, points):
    jm, tm = model_pair
    pj, aj, vj = jproto.project_points(jm, jnp.asarray(points))
    pt, at, vt = tproto.project_points(tm, _t(points))
    _close(pt, pj)
    _close(at, aj)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert 0 < int(vt.sum()) < len(points)


def test_unprojection_matches_reference(model_pair):
    jm, tm = model_pair
    rng = np.random.default_rng(11)
    px = rng.uniform([0.1 * 640, 0.1 * 480], [0.9 * 640, 0.9 * 480], (300, 2))
    dj, vj = jproto.unproject(jm, jnp.asarray(px), max_iterations=25)
    dt, vt = tproto.unproject(tm, _t(px), max_iterations=25)
    _close(dt, dj)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert bool(vt.all())


def test_point_jacobian_matches_reference(model_pair, points):
    jm, tm = model_pair
    front = points[points[:, 2] > 0]
    jj = jproto.projection_point_jacobian(jm, jnp.asarray(front), None)
    jt = tproto.projection_point_jacobian(tm, _t(front), None)
    assert tuple(jt.shape) == (len(front), 2, 3)
    _close(jt, jj)


def test_grid_point_jacobian_and_refusals():
    """projection_point_jacobian of a CentralGeneric model (the
    sensitivities branch) against the JAX package; NoncentralGeneric and
    objects that are no camera model raise."""
    from camera_calibration_torch.models import noncentral_generic as tncg
    from camera_calibration_tpu.models import central_generic as jcg

    jm = jcg.CentralGenericModel(
        grid=jnp.asarray(problems.pinhole_model(64, 48, 7, 7, device="cpu",
                                                dtype=torch.float64).grid),
        width=64, height=48, calibration_max_x=63, calibration_max_y=47)
    tm = convert.camera_model(jm, device="cpu")
    rng = np.random.default_rng(2)
    px = rng.uniform([8, 8], [56, 40], (64, 2))
    d = np.asarray(jproto.unproject(jm, jnp.asarray(px))[0]) \
        * rng.uniform(1, 2, (64, 1))
    _, gj, _ = jproto.project_points(jm, jnp.asarray(d), max_iterations=40)
    _, gt, _ = tproto.project_points(tm, _t(d), max_iterations=40)
    _close(gt, gj, dict(rtol=1e-10, atol=1e-10))
    jj = jproto.projection_point_jacobian(jm, jnp.asarray(d), gj)
    jt = tproto.projection_point_jacobian(tm, _t(d), _t(gj))
    _close(jt, jj)
    with pytest.raises(NotImplementedError):
        tproto.projection_point_jacobian(tncg.from_central(tm), _t(d), _t(gj))
    for fn in (tproto.intrinsics_tangent_zero,
               lambda m: tproto.project_points(m, _t(d))):
        with pytest.raises(TypeError, match="not a camera model"):
            fn(object())


def test_tangent_and_retract(model_pair):
    jm, tm = model_pair
    rng = np.random.default_rng(3)
    tang = rng.normal(0, 1e-3, np.asarray(jm.params).shape)
    assert torch.equal(tproto.intrinsics_tangent_zero(tm),
                       torch.zeros_like(tm.params))
    got = tproto.intrinsics_retract(tm, _t(tang), 0.5)
    ref = jproto.intrinsics_retract(jm, jnp.asarray(tang), 0.5)
    _close(got.params, ref.params)
    assert (got.width, got.height) == (ref.width, ref.height)


def test_pinhole_matches_reference():
    jc = jpin.make_pinhole(50.0, 52.0, 31.0, 23.5, 64, 48)
    tc = tpin.make_pinhole(50.0, 52.0, 31.0, 23.5, 64, 48, device="cpu")
    _close(tpin.direction_image(tc), jpin.direction_image(jc))
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-1, 1, (50, 2)),
                          rng.uniform(-0.5, 2, (50, 1))], -1)
    for a, b in zip(tpin.project(tc, _t(pts)),
                    jpin.project(jc, jnp.asarray(pts))):
        _close(a, b)


# ----------------------------- generic LM ---------------------------------


def test_lm_solve_matches_reference():
    """A TPF model and a rotation fitted to noisy pixels of rotated
    directions: a tuple state, Huber IRLS weights, and a given first λ.

    The given λ is 1000: the rotation trades against the principal point
    and the distortion, and with little damping 30 CG iterations stop far
    from the solution, where last-bit differences grow (after 4 LM
    iterations from λ = 1e-2 the parameters part by 1.2e-4, from λ = 10 by
    9e-6, from λ = 1000 by 6e-11; 6 iterations).  The λ of the diagonal
    probe is about 9000."""
    rng = np.random.default_rng(6)
    jm = _tpf_model(True)
    dirs = np.concatenate([rng.uniform(-0.6, 0.6, (500, 2)),
                           np.ones((500, 1))], -1)
    target = np.asarray(jpm.project_points(jm, jnp.asarray(dirs))[0]) \
        + rng.normal(0, 0.3, (500, 2))
    target[::40] += 25.0  # outliers for the robust weights
    p0 = np.asarray(jm.params) * (1 + rng.normal(0, 1e-3, 12))

    def weight(sq, sqrt, where):
        return where(sq > 4.0, 2.0 / sqrt(sq), 1.0)

    def make(pkg):
        if pkg == "jax":
            arr, proj, rot = jnp.asarray, jpm.project_points, jse3
            model, sqrt, where = jm, jnp.sqrt, jnp.where
        else:
            arr, proj, rot = _t, tpm.project_points, tse3
            model = convert.camera_model(jm, device="cpu")
            sqrt, where = torch.sqrt, torch.where
        d, tgt = arr(dirs), arr(target)

        def residual(state):
            params, q = state
            m = dataclasses.replace(model, params=params)
            return (proj(m, rot.quat_rotate(q, d))[0] - tgt).reshape(-1)

        def retract(state, delta):
            return (state[0] + delta[0],
                    rot.quat_mul(rot.quat_exp(delta[1]), state[1]))

        state0 = (arr(p0), arr(np.array([1.0, 0.0, 0.0, 0.0])))
        zeros = (arr(np.zeros(12)), arr(np.zeros(3)))
        return residual, retract, state0, zeros, \
            lambda sq: weight(sq, sqrt, where)

    for kw in (dict(max_iterations=3), dict(max_iterations=3, lam0=1000.0)):
        args_j, args_t = make("jax"), make("torch")
        rj = jgn.lm_solve(*args_j[:4], weight_fn=args_j[4], cg_iterations=30,
                          **kw)
        rt = tgn.lm_solve(*args_t[:4], weight_fn=args_t[4], cg_iterations=30,
                          **kw)
        assert rt.iterations == int(rj.iterations)
        for a, b in zip(rt.state, rj.state):
            _close(a, b, PARAM_TOL)
        _close(rt.cost, rj.cost, REL)
        _close(rt.lam, rj.lam, REL)


def _dense_field(jm, w=160, h=120, rotation=None):
    gt = jpm.replace(
        jm, params=jm.params.at[0].mul(w / jm.width).at[1].mul(w / jm.width)
        .at[2].set(0.5 * w).at[3].set(0.5 * h), width=w, height=h)
    yy, xx = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5,
                         indexing="ij")
    px = jnp.asarray(np.stack([xx, yy], -1).reshape(-1, 2))
    dirs, valid = jpm.unproject(gt, px, max_iterations=40)
    if rotation is not None:
        q = jse3.quat_exp(jnp.asarray(rotation))
        dirs = jse3.quat_rotate(jse3.quat_conj(q), dirs)
    return (gt, np.asarray(dirs).reshape(h, w, 3),
            np.asarray(valid).reshape(h, w))


@pytest.mark.parametrize("name,rotation,iters", [
    ("tpf_equidistant", None, 12), ("tpf_plain", None, 12),
    ("radial", None, 8), ("opencv", None, 8),
    ("tpf_equidistant", (0.0, 0.01, 0.03), 6)])
def test_fit_to_dense_matches_reference(name, rotation, iters):
    gt, dense, valid = _dense_field(MODELS[name](), rotation=rotation)
    zero = jpm.replace(gt, params=jnp.zeros_like(gt.params))
    # every 4th valid pixel of the 160×120 image: 4800 samples
    kw = dict(max_iterations=iters, co_estimate_rotation=rotation is not None,
              max_sample_count=4800)
    fj = jpm.fit_parametric_to_dense(zero, dense, valid, **kw)
    ft = tpm.fit_parametric_to_dense(convert.camera_model(zero, device="cpu"),
                                     dense, valid, device="cpu", **kw)
    if rotation is not None:
        (fj, qj), (ft, qt) = fj, ft
        # a unit quaternion: 1e-9 of its norm
        _close(qt, qj, dict(rtol=0, atol=1e-9))
    _close(ft.params, fj.params, PARAM_TOL)
    assert type(ft).__name__ == type(fj).__name__
    assert (ft.width, ft.height) == (fj.width, fj.height)

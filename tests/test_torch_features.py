"""The port's feature-side ops and corner refinement against the reference
package, on the CPU in float64.

The same NumPy inputs, made from seeds, go through the reference package's
function (JAX on the CPU, x64 on through the suite's conftest) and the
port's, and the outputs are compared:

- ``ops.linalg.cholesky_solve_small``, ``ops.interp`` (bilinear and
  bicubic, with Jacobians, one- and two-channel, ``in_bounds``) and
  ``ops.dlt``: to 1e-12 relative;
- ``patch_refinement.sample_patches``, with samples at 0, P−1 and outside
  the patch: to 1e-12 (the port's four-tap gather against the reference's
  hat-weight contraction);
- the three patch refinements (symmetry, matching, the fused two stages on
  a stacked image batch) and the two whole-image refinements (symmetry in
  intensity and gradient mode, matching) on 32 features of a rendered star
  pattern: the same ``converged`` flags, the median feature's position
  to 1e-9 px, and every position to 1e-9 px and cost to 1e-9 relative or,
  where the reference package itself moves further when its inputs are
  nudged by ±1e-14 relative, to twice its largest such move, which the
  test measures on six nudged runs of the reference (near a flat optimum
  a last-bit difference decides whether the LM loop's last tiny step is
  accepted: measured gaps of 1e-9 to 1e-8 px on a few features, as large
  as the reference's own moves);
- the copied host modules (pattern intensity, AprilTag detection) give the
  reference's outputs, and the port's own PDF writer draws the pattern's
  raster oracle.

The module runs with one intra-op thread (``tests/torch_threads.py``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camera_calibration_torch.features import apriltag as tat
from camera_calibration_torch.features import patch_refinement as tpr
from camera_calibration_torch.features import pattern as tpat
from camera_calibration_torch.features import refinement as tref
from camera_calibration_torch.ops import dlt as tdlt
from camera_calibration_torch.ops import interp as tinterp
from camera_calibration_torch.ops import linalg as tlinalg
from camera_calibration_tpu.features import apriltag as jat
from camera_calibration_tpu.features import patch_refinement as jpr
from camera_calibration_tpu.features import pattern as jpat
from camera_calibration_tpu.features import refinement as jref
from camera_calibration_tpu.ops import dlt as jdlt
from camera_calibration_tpu.ops import interp as jinterp
from camera_calibration_tpu.ops import linalg as jlinalg
from torch_threads import one_torch_thread  # noqa: F401

OPS_REL = 1e-12
POS_PX = 1e-9
COST_REL = 1e-9


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


# ----------------------------------- ops -----------------------------------


@pytest.mark.parametrize("k,batch", [(4, (50,)), (8, (7, 9)), (1, (3,))])
def test_cholesky_solve_small(k, batch):
    rng = np.random.default_rng(k)
    m = rng.normal(0, 1, batch + (k, k))
    a = m @ np.swapaxes(m, -1, -2) + 1e-2 * np.eye(k)
    b = rng.normal(0, 1, batch + (k,))
    want = np.asarray(jlinalg.cholesky_solve_small(jnp.asarray(a),
                                                   jnp.asarray(b)))
    got = tlinalg.cholesky_solve_small(_t(a), _t(b)).numpy()
    assert _rel(got, want) <= OPS_REL
    assert _rel(got, np.linalg.solve(a, b[..., None])[..., 0]) <= 1e-8


def test_cholesky_solve_small_clamps_the_pivot():
    """A singular or indefinite matrix: the pivot is clamped to
    sqrt(1e-30), as in the reference (and the step goes non-finite or huge
    in both alike)."""
    a = np.array([[[0.0, 0.0], [0.0, 1.0]], [[-1.0, 0.0], [0.0, 2.0]]])
    b = np.array([[1e-20, 1.0], [1e-20, 1.0]])
    want = np.asarray(jlinalg.cholesky_solve_small(jnp.asarray(a),
                                                   jnp.asarray(b)))
    got = tlinalg.cholesky_solve_small(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert _rel(got, want) <= OPS_REL


@pytest.mark.parametrize("channels", [None, 2])
def test_interpolation_matches_the_reference(channels):
    rng = np.random.default_rng(3)
    shape = (23, 31) if channels is None else (23, 31, channels)
    img = rng.uniform(0, 1, shape)
    xy = rng.uniform(-3, 34, (5, 40, 2))
    xy[0, :4] = [[0, 0], [30, 22], [29.5, 21.9999], [1, 1]]
    for name in ("bilinear", "bicubic"):
        want = getattr(jinterp, name)(jnp.asarray(img), jnp.asarray(xy))
        got = getattr(tinterp, name)(_t(img), _t(xy))
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) <= OPS_REL, name
        wv, wg = getattr(jinterp, name + "_with_jacobian")(jnp.asarray(img),
                                                           jnp.asarray(xy))
        gv, gg = getattr(tinterp, name + "_with_jacobian")(_t(img), _t(xy))
        assert gg.shape == wg.shape
        assert _rel(gv.numpy(), wv) <= OPS_REL, name
        assert _rel(gg.numpy(), wg) <= OPS_REL, name
    for margin in (0.0, 1.0):
        np.testing.assert_array_equal(
            tinterp.in_bounds(shape, _t(xy), margin).numpy(),
            np.asarray(jinterp.in_bounds(shape, jnp.asarray(xy), margin)))


@pytest.mark.parametrize("weighted", [False, True])
def test_homography_dlt_matches_the_reference(weighted):
    rng = np.random.default_rng(5)
    h_true = np.array([[1.2, 0.1, 30.0], [-0.05, 0.9, 12.0],
                       [1e-4, -2e-4, 1.0]])
    src = rng.uniform(0, 100, (12, 2))
    q = np.c_[src, np.ones(12)] @ h_true.T
    dst = q[:, :2] / q[:, 2:] + rng.normal(0, 0.3, (12, 2))
    w = (rng.uniform(0, 1, 12) > 0.3).astype(np.float64) if weighted else None
    want = np.asarray(jdlt.homography_dlt(
        jnp.asarray(src), jnp.asarray(dst),
        None if w is None else jnp.asarray(w)))
    got = tdlt.homography_dlt(_t(src), _t(dst),
                              None if w is None else _t(w)).numpy()
    assert _rel(got, want) <= OPS_REL
    # batched: every row as alone
    got_b = tdlt.homography_dlt(_t(np.stack([src, src[::-1]])),
                                _t(np.stack([dst, dst[::-1]])))
    alone = tdlt.homography_dlt(_t(src[::-1]), _t(dst[::-1]))
    assert _rel(got_b[1].numpy(), alone.numpy()) <= OPS_REL
    pts = rng.uniform(0, 100, (3, 7, 2))
    assert _rel(tdlt.apply_homography(_t(got), _t(pts)).numpy(),
                jdlt.apply_homography(jnp.asarray(want),
                                      jnp.asarray(pts))) <= OPS_REL


def test_sample_patches_matches_the_hat_contraction():
    """The four-tap gather against the reference's hat-weight matmuls:
    samples inside, at 0 and at P−1 exactly (where the hat derivative is
    −patch[P−1]), on the last row and column, and outside (clipped, with
    ``valid`` false)."""
    rng = np.random.default_rng(7)
    n, p = 3, 24
    patches = rng.uniform(0, 1, (n, p, p))
    xy = rng.uniform(-3, p + 2, (n, 300, 2))
    edge = [[0, 0], [p - 1, p - 1], [p - 1, 5.25], [7.5, p - 1], [0, 11.0],
            [12.0, 0], [p - 1.5, p - 1.0], [-0.0, 3.0], [p - 1, -2.0],
            [p + 5.0, p + 5.0], [-4.0, 2.5]]
    xy[:, :len(edge)] = edge
    want = jpr.sample_patches(jnp.asarray(patches), jnp.asarray(xy))
    got = tpr.sample_patches(_t(patches), _t(xy))
    assert _rel(got[0].numpy(), want[0]) <= OPS_REL
    assert _rel(got[1].numpy(), want[1]) <= OPS_REL
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1][:, 1, 0].numpy(),
                               -patches[:, p - 1, p - 1], rtol=1e-15)
    val, grad, valid = tpr.sample_patches(_t(patches), _t(xy),
                                          with_grad=False)
    assert grad is None and torch.equal(val, got[0])


def test_patch_extraction_and_origins():
    rng = np.random.default_rng(8)
    img = rng.uniform(0, 1, (3, 40, 50))
    centers = rng.uniform(-5, 55, (20, 2))
    centers[0] = [24.5, 20.5]  # rounds half to even in both
    centers[1] = [25.5, 19.5]
    patch = tpr.patch_size_for_window(4)
    assert patch == jpr.patch_size_for_window(4)
    x0, y0 = tpr.patch_origins_device((40, 50), _t(centers), patch)
    jx, jy = jpr._origins_in_jit((40, 50), jnp.asarray(centers), patch)
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y0.numpy(), np.asarray(jy))
    hx, hy = tpr.patch_origins((40, 50), centers, patch)
    np.testing.assert_array_equal(x0.numpy(), hx)
    idx = rng.integers(0, 3, 20).astype(np.int32)
    got = tpr.extract_patches_device(_t(img), torch.stack([y0, x0], -1),
                                     patch, _t(idx))
    want = jpr._extract_indexed(jnp.asarray(img), jnp.asarray(idx), jy, jx,
                                patch)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    host, _ = tpr.extract_patches_host(img[1], centers, patch)
    np.testing.assert_array_equal(
        tpr.extract_patches_device(_t(img[1]), torch.stack([y0, x0], -1),
                                   patch).numpy(), host)


# ------------------------------- refinement -------------------------------


def _render_case(n_feat=32, whs=6, seed=11, noise=0.01):
    """32 features of a rendered 16-segment star pattern seen through a
    perspective homography: the images (two, the second a shifted copy),
    predictions 0.3–1.5 px off the truth, local homographies, window
    samples in pattern space and the rendered templates, as the detector
    makes them."""
    rng = np.random.default_rng(seed)
    spec = jpat.PatternSpec(num_star_segments=16, squares_x=9, squares_y=9,
                            square_length_in_meters=0.02)
    sq = 20.0
    h_pp = np.array([[sq * np.cos(0.05), -sq * np.sin(0.05), 30.0],
                     [sq * np.sin(0.05), sq * np.cos(0.05), 28.0],
                     [8e-5, -6e-5, 1.0]])
    size = int(sq * 10)
    img = jpat.render_pattern(spec, np.linalg.inv(h_pp), (size, size),
                              supersample=3)
    img = np.clip(img + rng.normal(0, noise, img.shape), 0, 1)
    coords = [c for c in spec.valid_feature_coords()
              if 1 <= c[0] <= 6 and 1 <= c[1] <= 6][:n_feat]
    gt, h_loc = [], []
    for fx, fy in coords:
        t = np.eye(3)
        t[0, 2], t[1, 2] = fx, fy
        hl = h_pp @ t
        q = h_pp @ np.array([fx, fy, 1.0])
        gt.append(q[:2] / q[2] - 0.5)  # pixel-center convention
        hl = hl / hl[2, 2]
        hl[0:2, 2] = gt[-1]
        h_loc.append(hl)
    gt, h_loc = np.array(gt), np.array(h_loc)
    pred = gt + rng.uniform(0.3, 1.5, gt.shape) * rng.choice([-1, 1],
                                                             gt.shape)
    offs = jref.make_sample_offsets(rng, whs, 96) * whs
    h_rel = h_loc.copy()
    h_rel[:, 0:2, 2] = 0.0
    h_inv = np.linalg.inv(h_rel)
    q = np.einsum("nij,sj->nsi", h_inv[:, :, :2], offs) + h_inv[:, None, :, 2]
    samples = q[..., :2] / q[..., 2:3]
    rendered = spec.intensity(samples[:, :24])
    grad = np.stack(np.gradient(img)[::-1], -1)
    return dict(img=img, grad=grad, pred=pred, gt=gt, h=h_loc,
                samples=samples, rendered=rendered, whs=whs,
                stack=np.stack([img, np.roll(img, (2, 3), (0, 1))]))


@pytest.fixture(scope="module")
def case():
    return _render_case()


def _nudged(arrays, seed):
    """The float arrays scaled by 1 ± 1e-14 elementwise (random signs)."""
    rng = np.random.default_rng(seed)
    return [a * (1.0 + 1e-14 * rng.choice([-1.0, 1.0], a.shape))
            if a.dtype == np.float64 else a for a in arrays]


def _held(got, reference, args):
    """The port's (positions, cost, converged) against the reference's on
    ``args``: the same flags; the median feature's position within 1e-9 px;
    every position within max(1e-9 px, 2·spread) and every finite cost
    within max(1e-9, 2·spread) relative, the spreads being the most the
    reference's own results move, over all features, in six runs on
    ``_nudged(args, seed)``."""
    want = [np.asarray(v) for v in reference(args)]
    gp, gc, gok = (np.asarray(v) for v in got)
    wp, wc, wok = want
    np.testing.assert_array_equal(gok, wok)
    np.testing.assert_array_equal(np.isfinite(gc), np.isfinite(wc))
    fin = np.isfinite(wc)
    pos_spread = cost_spread = 0.0
    for seed in range(1, 7):
        np_, nc, _ = (np.asarray(v) for v in reference(_nudged(args, seed)))
        pos_spread = max(pos_spread, float(np.abs(np_ - wp).max()))
        ok = fin & np.isfinite(nc)
        cost_spread = max(cost_spread, float(
            (np.abs(nc[ok] - wc[ok]) / np.abs(wc[ok])).max()))
    gap = np.abs(gp - wp).max(axis=1)
    assert np.median(gap) <= POS_PX, np.median(gap)
    assert gap.max() <= max(POS_PX, 2 * pos_spread), (gap.max(), pos_spread)
    rel = np.abs(gc[fin] - wc[fin]) / np.abs(wc[fin])
    assert rel.max() <= max(COST_REL, 2 * cost_spread), (rel.max(),
                                                         cost_spread)
    return gok


def _jnp(args):
    return [jnp.asarray(a) for a in args]


def _tt(args):
    return [_t(a) for a in args]


def test_whole_image_symmetry_matches_the_reference(case):
    sv = np.ones(case["samples"].shape[:2], bool)
    for use_gradient, image in ((False, case["img"]), (True, case["grad"])):
        args = [image, case["pred"], case["h"], case["samples"], sv]

        def reference(a):
            return jref.refine_features_symmetry(
                *_jnp(a), case["whs"], use_gradient=use_gradient)

        got = tref.refine_features_symmetry(*_tt(args), case["whs"],
                                            use_gradient=use_gradient)
        ok = _held(got, reference, args)
        assert ok.sum() >= 20, use_gradient


def test_whole_image_matching_matches_the_reference(case):
    sv = np.ones(case["rendered"].shape, bool)
    pred = case["pred"].copy()
    pred[0] = [-40.0, -40.0]  # every sample and coarse offset out of bounds
    args = [case["img"], pred, case["h"], case["samples"][:, :24],
            case["rendered"], sv]

    def reference(a):
        return jref.refine_features_matching(*_jnp(a), case["whs"])

    got = tref.refine_features_matching(*_tt(args), case["whs"])
    ok = _held(got, reference, args)
    assert not ok[0] and not np.isfinite(got[1][0].item())
    assert ok.sum() >= 20


def test_patch_refinements_match_the_reference(case):
    patch = tpr.patch_size_for_window(case["whs"])
    patches, origins = jpr.extract_patches_host(case["img"], case["pred"],
                                                patch)
    sv = np.ones(case["samples"].shape[:2], bool)
    args = [patches, origins, case["pred"], case["h"], case["samples"], sv]

    def reference(a):
        return jpr.refine_symmetry_patches(*_jnp(a), case["whs"])

    got = tpr.refine_symmetry_patches(*_tt(args), case["whs"])
    assert _held(got, reference, args).sum() >= 20
    svm = np.ones(case["rendered"].shape, bool)
    pred = case["pred"].copy()
    pred[1] += 40.0  # the patch moves with it: every sample stays inside
    patches, origins = jpr.extract_patches_host(case["img"], pred, patch)
    args = [patches, origins, pred, case["h"], case["samples"][:, :24],
            case["rendered"], svm]

    def reference_m(a):
        return jpr.refine_matching_patches(*_jnp(a), case["whs"])

    got = tpr.refine_matching_patches(*_tt(args), case["whs"])
    assert _held(got, reference_m, args).sum() >= 20


def test_two_stage_patches_match_the_reference(case):
    """The fused two stages on the stacked two-image batch, features split
    between the images."""
    patch = tpr.patch_size_for_window(case["whs"])
    n = case["pred"].shape[0]
    idx = (np.arange(n) % 2).astype(np.int32)
    pred = case["pred"] + idx[:, None] * np.array([3.0, 2.0])
    svm = np.ones(case["rendered"].shape, bool)
    svs = np.ones(case["samples"].shape[:2], bool)
    args = [case["stack"], pred, case["h"], case["samples"][:, :24],
            case["rendered"], svm, case["samples"], svs, idx]

    def split(packed):
        packed = np.asarray(packed)
        return packed[:, :2], packed[:, 2], packed[:, 3]

    def reference(a):
        *rest, ix = _jnp(a)
        return split(jpr.refine_two_stage_patches(*rest, case["whs"], patch,
                                                  ix))

    *rest, ix = _tt(args)
    got = split(tpr.refine_two_stage_patches(*rest, case["whs"], patch, ix))
    ok = _held(got, reference, args) > 0.5
    assert ok.sum() >= 20
    truth = case["gt"] + idx[:, None] * np.array([3.0, 2.0])
    assert np.median(np.linalg.norm(got[0][ok] - truth[ok], axis=1)) < 0.05


def test_two_stage_rows_are_independent_of_the_batch(case):
    """The port refines every batch at its own size (no bucket padding): a
    feature refined alone gives the bits it gets inside the batch."""
    patch = tpr.patch_size_for_window(case["whs"])
    n = case["pred"].shape[0]
    idx = (np.arange(n) % 2).astype(np.int32)
    svm = np.ones(case["rendered"].shape, bool)
    svs = np.ones(case["samples"].shape[:2], bool)
    args = [case["pred"], case["h"], case["samples"][:, :24],
            case["rendered"], svm, case["samples"], svs]
    whole = tpr.refine_two_stage_patches(
        _t(case["stack"]), *(_t(a) for a in args), case["whs"], patch,
        _t(idx))
    for i in (0, 5, n - 1):
        alone = tpr.refine_two_stage_patches(
            _t(case["stack"]), *(_t(a[i:i + 1]) for a in args), case["whs"],
            patch, _t(idx[i:i + 1]))
        assert torch.equal(alone[0], whole[i]), i


# ------------------------------ host modules ------------------------------


def test_pattern_intensity_native_matches_numpy_and_the_reference():
    rng = np.random.default_rng(12)
    pts = rng.uniform(-2, 8, (20000, 2))
    pts[:4] = [[0, 0], [1.5, 2.5], [-0.5, 3.0], [2.0, 2.0]]
    spec = tpat.PatternSpec(16, 8, 8, 0.02)
    got = spec.intensity(pts)
    np.testing.assert_array_equal(got, spec.intensity_plain(pts))
    np.testing.assert_array_equal(
        got, jpat.PatternSpec(16, 8, 8, 0.02).intensity(pts))


def test_apriltag_detection_matches_the_reference():
    spec = jpat.PatternSpec(
        num_star_segments=16, squares_x=10, squares_y=10,
        square_length_in_meters=0.02,
        tags=[jpat.AprilTagInfo(x=3, y=3, width=3, height=3, index=5)])
    h_pp = np.array([[22.0, -1.5, 40.0], [1.2, 21.0, 35.0],
                     [5e-5, 4e-5, 1.0]])
    img = jpat.render_pattern(spec, np.linalg.inv(h_pp), (280, 270),
                              supersample=3,
                              tag_renderer=jpat.make_tag_renderer(spec))
    want = [jat.refine_tag_homography(img, t) for t in jat.detect_tags(img)]
    got = [tat.refine_tag_homography(img, t) for t in tat.detect_tags(img)]
    assert [t.tag_id for t in got] == [t.tag_id for t in want] == [5]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.corners, w.corners)
        np.testing.assert_array_equal(g.h_tag_to_image, w.h_tag_to_image)


def _pdf_fills(path):
    """(gray, polygon) fills of the port's one-page PDF, and the page size
    in points."""
    data = open(path, "rb").read()
    assert data.startswith(b"%PDF-1.4") and data.rstrip().endswith(b"%%EOF")
    # the cross-reference table points at every object
    start = int(re.search(rb"startxref\n(\d+)", data).group(1))
    offs = [int(m) for m in re.findall(rb"(\d{10}) 00000 n", data[start:])]
    for i, off in enumerate(offs, 1):
        assert data[off:].startswith(b"%d 0 obj" % i)
    box = re.search(rb"/MediaBox \[0 0 ([\d.]+) ([\d.]+)\]", data)
    stream = data[data.index(b"stream\n") + 7:data.index(b"\nendstream")]
    fills = []
    for part in stream.decode().split("h f")[:-1]:
        nums = part.split()
        gray = float(nums[0])
        xy = [(float(nums[i]), float(nums[i + 1]))
              for i in range(2, len(nums), 3)]
        fills.append((gray, xy))
    return fills, float(box.group(1)), float(box.group(2))


def test_pattern_pdf_draws_the_raster_oracle(tmp_path):
    """The port writes the PDF itself: its polygons, filled in order on a
    pixel grid, reproduce the intensity oracle (with the tags) away from
    black/white edges."""
    from matplotlib.path import Path
    from scipy.ndimage import maximum_filter, minimum_filter

    spec = tpat.PatternSpec(
        num_star_segments=16, squares_x=8, squares_y=6,
        square_length_in_meters=0.02,
        tags=[tpat.AprilTagInfo(x=3, y=2, width=2, height=2, index=0)])
    path = tmp_path / "pattern.pdf"
    tpat.save_pattern_pdf(spec, str(path))
    fills, w_pt, h_pt = _pdf_fills(path)
    margin, cell = 0.005, 0.02
    pt_per_m = 72.0 / 0.0254
    assert abs(w_pt - (8 * cell + 2 * margin) * pt_per_m) < 1e-3
    assert abs(h_pt - (6 * cell + 2 * margin) * pt_per_m) < 1e-3
    # pattern coords -> page points, on a grid of 0.02-cell pixels
    gx, gy = np.meshgrid(np.arange(-0.99, 6.99, 0.02),
                         np.arange(-0.99, 4.99, 0.02))
    px = (margin + (gx + 1.0) * cell) * pt_per_m
    py = h_pt - (margin + (gy + 1.0) * cell) * pt_per_m
    pts = np.stack([px.ravel(), py.ravel()], -1)
    drawn = np.ones(pts.shape[0])
    for gray, xy in fills:
        drawn[Path(np.asarray(xy)).contains_points(pts)] = gray
    drawn = drawn.reshape(gx.shape)
    ref = spec.intensity(np.stack([gx, gy], -1))
    ref = tpat.make_tag_renderer(spec)(np.stack([gx, gy], -1), ref)
    flat = minimum_filter(ref, 5) == maximum_filter(ref, 5)
    assert (np.abs(drawn[flat] - ref[flat]) < 0.5).mean() > 0.99

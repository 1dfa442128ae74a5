"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and the CUDA toolkit: the kernels have no
CPU mode.  They carry the ``gpu`` marker and skip (inside a fixture) where
``torch.cuda.is_available()`` is false.  They import no JAX, so on a
machine with a card they run without the suite's conftest:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda.py

The reductions past one block's shared memory run in bands of grid rows
(``ba/window_cuda.reduction_plan``); bands of any height give
bit-identical results, on random and on clustered windows (one view's
features a tile) at the 1080p grid 45x79.  All three window kernels also
read a bfloat16 j_win (the CG matvecs' copies for the two matvecs): held
against the float64 plain version of the same bf16 values, with N odd,
even but not a multiple of 8, and a j_win view that is not 4-byte aligned;
the two reductions on a bf16 j_win equal the float32 kernels on the
widened values bit for bit where both plans take the same block count
(one layout, one order), and the block diagonal agrees with them to 1e-6
in any case.

The detector and the fused corner refinement run in float32 on the card
against float64 on the CPU (the same features, positions within 1e-3 px
at the median or 95th percentile and 1e-2 px at most).

The live consumer runs on the card against the CPU, and so do the
visualizer's error arrays (through the ``project`` kernel against the
plain projection); one LM step on tables sharded over a one-rank NCCL
group equals the unsharded step bit for bit.

The calibration pipeline (dense initialization, ``build_ba_state``,
``calibrate``) runs on the small dataset of ``tests/test_e2e.py`` in
float32 on the card and on the CPU: the same outliers, medians within 1e-3
px.  The native densification builds with ``g++`` into ``_build/`` and
loads.

Tolerances: the window kernels to 1e-4 of the largest value of a float64
plain reference (the reference package's bar for its TPU kernels); the
projection kernels to 1e-3 px on points valid in both versions, with at
most 1% valid-mask flips (float32 rounding can flip an accept test where
the cost is flat), and p_px and j_win to 1e-3 of their largest value on
points valid in both with the same window base; one LM step to 1e-3 on
cost and points.
"""

import dataclasses

import numpy as np
import pytest
import torch

from camera_calibration_torch import _cuda, problems
from camera_calibration_torch.ba import lm_pcg
from camera_calibration_torch.ba import window_cuda as wc
from camera_calibration_torch.models import central_generic as cg
from camera_calibration_torch.models import central_generic_cuda as cgc
from camera_calibration_torch.ops import manifolds

pytestmark = pytest.mark.gpu

WINDOW_REL = 1e-4
PX_TOL = 1e-3
STEP_REL = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(got, ref):
    ref = ref.double()
    return float((got.double() - ref).abs().max() / ref.abs().max())


def _window_inputs(card, gh, gw, k, n, seed, bases="random"):
    """Seeded window inputs.  ``bases``: "random" (windows reach past every
    edge), "clustered" (views of 576 features, as a 24x24 board: each
    view's bases uniform in its own rectangle of about a quarter of the
    grid's width and height, somewhere on the grid or past an edge), "same"
    (every window at one base inside the grid) or "outside" (every window
    at (-10, -10), wholly off the grid)."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=card)

    j_win = f32(rng.normal(0, 1, (32 * k, n)))
    if bases == "random":
        xy = np.stack([rng.integers(-3, gw, n), rng.integers(-3, gh, n)], 1)
    elif bases == "clustered":
        views = -(-n // 576)
        size = np.array([max(2, gw // 4), max(2, gh // 4)])
        lo = np.stack([rng.integers(-3, gw - 1, views),
                       rng.integers(-3, gh - 1, views)], 1)
        xy = np.repeat(lo, 576, 0)[:n] + rng.integers(0, size, (n, 2))
    else:
        at = (gw // 3, gh // 3) if bases == "same" else (-10, -10)
        xy = np.tile(np.array(at), (n, 1))
    base = torch.as_tensor(xy, dtype=torch.int32, device=card)
    return (j_win, base, f32(rng.normal(0, 1, (gh, gw, k))),
            f32(rng.normal(0, 1, (n, 2))), f32(rng.uniform(0, 1, n)))


# A square grid just past the largest (56x56) whose K=5 block-diagonal
# reduction fits in one block's shared memory in one band
# (ba/window_cuda.reduction_plan): two bands of 29 rows.
K5_MAX_GRID = 58


@pytest.mark.parametrize("gh,gw,k,n,bases", [
    (16, 16, 2, 20000, "random"), (21, 28, 2, 5000, "random"),
    (21, 28, 5, 5000, "random"), (7, 9, 5, 33, "random"),
    # ragged last tile with N % 4 == 1: 4-byte copies, unaligned rows
    (16, 16, 2, 20001, "random"), (21, 28, 5, 5001, "random"),
    (16, 16, 2, 33, "random"),
    # one window hit by every observation of every tile
    (16, 16, 2, 20000, "same"), (21, 28, 5, 5000, "same"),
    # every window off the grid: the outputs are exactly zero
    (16, 16, 2, 5000, "outside"),
    # the pipeline's default grid for a 1080p camera (25 px cells)
    (45, 79, 2, 50000, "random"),
    # K=5 at 56x56 (the largest square K=5 block diagonal of one band) and
    # K=2 at 128x128, the largest square grids of the earlier single-stage
    # kernel, and the K=5 block diagonal just past one band
    (56, 56, 5, 20000, "random"), (128, 128, 2, 20000, "random"),
    (K5_MAX_GRID, K5_MAX_GRID, 5, 20001, "random"),
    # banded: the K=5 block diagonal at 45x79 (two bands), 59x59 (two
    # bands) and 107x107 (the largest square K=5 grid whose tangent fits
    # window_apply_j's block)
    (45, 79, 5, 50000, "random"), (59, 59, 5, 20001, "random"),
    (107, 107, 5, 20000, "random"), (45, 79, 5, 20000, "same"),
    # K=5 at 108x108: window_apply_j reads the tangent from device memory
    # (it no longer fits one block), the reductions run in bands
    (108, 108, 5, 20000, "random"),
    # the 1080p grid: clustered tiles (one view's features) and random
    # ones for K=2 and K=5, N past a whole number of tiles, a tile whose
    # windows all meet at one knot, and tiles wholly off the grid
    (45, 79, 2, 50000, "clustered"), (45, 79, 5, 50000, "clustered"),
    (45, 79, 5, 50001, "random"), (45, 79, 2, 20000, "same"),
    (45, 79, 2, 5000, "outside"), (45, 79, 5, 5000, "outside"),
])
def test_window_kernels_match_plain(card, gh, gw, k, n, bases):
    j_win, base, tangent, ws, w = _window_inputs(card, gh, gw, k, n, seed=k,
                                                 bases=bases)
    d = [t.double() for t in (j_win, tangent, ws, w)]
    cases = (
        ("window_apply_j", lambda: wc.window_apply_j(j_win, base, tangent),
         wc.window_apply_j_plain(d[0], base, d[1])),
        ("window_apply_jtw",
         lambda: wc.window_apply_jtw(j_win, base, ws, gh, gw, k),
         wc.window_apply_jtw_plain(d[0], base, d[2], gh, gw, k)),
        ("window_block_diag",
         lambda: wc.window_block_diag(j_win, base, w, gh, gw, k),
         wc.window_block_diag_plain(d[0], base, d[3], gh, gw, k)),
    )
    for name, kernel, ref in cases:
        before = _cuda.launches[name]
        got = kernel()
        again = kernel()
        torch.cuda.synchronize()
        assert _cuda.launches[name] == before + 2
        assert got.dtype == torch.float32 and got.shape == ref.shape
        if bases == "outside":
            assert torch.count_nonzero(got) == 0, name
        else:
            assert _rel(got, ref) <= WINDOW_REL, name
        assert torch.equal(got, again), f"{name} is not repeatable"


def _projection_case(card, gh, gw, seed, n=4000):
    model = problems.pinhole_model(640, 480, gw, gh, device=card)
    rng = np.random.default_rng(seed)
    pix = torch.as_tensor(rng.uniform([2, 2], [638, 478], (n, 2)),
                          dtype=torch.float32, device=card)
    dirs = cg.unproject(model, pix)[0].contiguous()
    warm = pix + torch.as_tensor(rng.normal(0, 2.0, (n, 2)),
                                 dtype=torch.float32, device=card)
    return model, dirs, warm


def _run_projections(model, dirs, g0, iters=8, blocks=True):
    """Both kernels and both plain versions on the same inputs:
    ((g, cost) kernel, (g, cost) plain, blocks kernel, blocks plain); the
    blocks pair is None unless ``blocks``."""
    lo, hi = cg._static_clamp_bounds(model)
    eps = cg.default_eps(torch.float32)
    sx, sy = cg.pixel_scale_to_grid_scale(model)
    t1, t2 = (t.contiguous() for t in manifolds.direction_tangents(model.grid))
    before = (_cuda.launches["project"], _cuda.launches["project_blocks"])
    pk = cgc.project_grid_coords(model.grid, dirs, g0, lo, hi, iters, eps)
    pp = cgc.project_grid_coords_plain(model.grid, dirs, g0, lo, hi, iters,
                                       eps)
    args = (model.grid, t1, t2, dirs, g0, lo, hi, (1 / sx, 1 / sy), iters, eps)
    bk = cgc.project_blocks(*args) if blocks else None
    bp = cgc.project_blocks_plain(*args) if blocks else None
    torch.cuda.synchronize()
    assert (_cuda.launches["project"], _cuda.launches["project_blocks"]) == (
        before[0] + 1, before[1] + int(blocks))
    return pk, pp, bk, bp


def _assert_projections_match(model, outs, n, min_valid=0.9):
    pk, pp, bk, bp = outs
    eps = cg.default_eps(torch.float32)
    sx, sy = cg.pixel_scale_to_grid_scale(model)
    pairs = [((pk[0], pk[1]), (pp[0], pp[1]))]
    if bk is not None:
        pairs.append(((bk[0], bk[1]), (bp[0], bp[1])))
    for (g_k, c_k), (g_p, c_p) in pairs:
        vk, vp = c_k < 1e4 * eps, c_p < 1e4 * eps
        assert int(vp.sum()) > min_valid * n
        assert int((vk != vp).sum()) <= 0.01 * n
        both = vk & vp
        dg = (g_k - g_p)[both].abs()
        assert float(dg[:, 0].max()) / sx <= PX_TOL
        assert float(dg[:, 1].max()) / sy <= PX_TOL
    if bk is None:
        return
    same = (bk[1] < 1e4 * eps) & (bp[1] < 1e4 * eps) & (bk[4] == bp[4]).all(1)
    assert _rel(bk[2][same], bp[2][same]) <= 1e-3
    assert _rel(bk[3][:, same], bp[3][:, same]) <= 1e-3


@pytest.mark.parametrize("gh,gw", [
    (16, 16), (21, 28),
    # the pipeline's default grid for a 1080p camera: project_blocks in
    # blocks of 1024 threads
    (45, 79),
    # the largest square grid project_blocks stages in shared memory
    (80, 80),
    # past it project_blocks reads its fields from device memory: one row
    # more, and the 84x100 grid of a 2448x2048 camera at 25 px a cell
    (81, 81), (84, 100),
    # the largest square grid project stages, in blocks of 1024 threads,
    # and one row more, read from device memory
    (139, 139), (140, 140)])
def test_projection_kernels_match_plain(card, gh, gw):
    model, dirs, warm = _projection_case(card, gh, gw, seed=gh)
    warm[:4] = torch.tensor([[-50.0, -50.0], [700.0, 240.0], [320.0, -40.0],
                             [320.0, 530.0]], device=card)
    g0 = cg.pixel_to_grid(model, warm).contiguous()
    _assert_projections_match(
        model, _run_projections(model, dirs, g0), dirs.shape[0])


@pytest.mark.parametrize("gh,gw", [(16, 16), (139, 139), (84, 100)])
def test_projection_windows_outside_the_grid(card, gh, gw):
    """Points whose warm start puts the whole window off the grid, on every
    side and far out, beside ordinary points in the same warps: the surface
    there is 0, so both versions leave the point where it is with a NaN
    cost (invalid), and the window base is floor(g) - 1 as in the plain
    version.  The ordinary points still match (both block sizes, and
    fields staged or read from device memory)."""
    model, dirs, warm = _projection_case(card, gh, gw, seed=5)
    g0 = cg.pixel_to_grid(model, warm).contiguous()
    out = torch.zeros(g0.shape[0], dtype=torch.bool, device=card)
    out[::3] = True
    far = torch.tensor([[-4.5, 3.0], [gw + 3.5, 3.0], [3.0, -4.5],
                        [3.0, gh + 3.5], [-7.0, -9.0], [-2e7, 5.0],
                        [5.0, 3e8], [gw + 40.0, gh + 40.0]], device=card)
    g0[out] = far[torch.arange(int(out.sum()), device=card) % far.shape[0]]
    pk, pp, bk, bp = _run_projections(model, dirs, g0)
    for g, c, *_ in (pk, pp, bk, bp):
        assert torch.equal(g[out], g0[out])
        assert bool(torch.isnan(c[out]).all())
    keep = ~out

    def kept(res):
        if res is None:
            return None
        return tuple(t[keep] if t.shape[0] == g0.shape[0] else t[:, keep]
                     for t in res)

    assert torch.equal(bk[4][out], bp[4][out])
    _assert_projections_match(model, tuple(kept(r) for r in (pk, pp, bk, bp)),
                              int(keep.sum()))


def test_projection_points_converging_at_different_iterations(card):
    """Lanes of one warp that leave the LM loop at different iterations:
    warm starts 0, 0.3, 3 and 30 px off in turn, so every warp mixes points
    that need one iteration with points that need several."""
    model = problems.pinhole_model(640, 480, 28, 21, device=card)
    rng = np.random.default_rng(9)
    n = 4096
    pix = torch.as_tensor(rng.uniform([2, 2], [638, 478], (n, 2)),
                          dtype=torch.float32, device=card)
    dirs = cg.unproject(model, pix)[0].contiguous()
    scale = torch.tensor([0.0, 0.3, 3.0, 30.0], device=card).repeat(n // 4)
    noise = torch.as_tensor(rng.normal(0, 1, (n, 2)), dtype=torch.float32,
                            device=card)
    g0 = cg.pixel_to_grid(model, pix + scale[:, None] * noise).contiguous()
    lo, hi = cg._static_clamp_bounds(model)
    _, iters = cgc.lm_loop_plain(model.grid, dirs, g0, lo, hi, 8,
                                 cg.default_eps(torch.float32))
    per_warp = iters.reshape(-1, 32)
    assert bool((per_warp.max(1).values > per_warp.min(1).values).all())
    _assert_projections_match(model, _run_projections(model, dirs, g0), n)


def test_window_apply_jtw_compact_layout(card):
    """J^T W s on a large grid that still fits one block in one band (K=2,
    160x160), where the block diagonal takes bands."""
    gh = gw = 160
    assert wc.reduction_bands("window_apply_jtw", gh, gw, 2)[1] == 1
    assert wc.reduction_bands("window_block_diag", gh, gw, 2)[1] > 1
    j_win, base, _, ws, _ = _window_inputs(card, gh, gw, 2, 20001, seed=3)
    ref = wc.window_apply_jtw_plain(j_win.double(), base, ws.double(), gh, gw, 2)
    got = wc.window_apply_jtw(j_win, base, ws, gh, gw, 2)
    again = wc.window_apply_jtw(j_win, base, ws, gh, gw, 2)
    assert _rel(got, ref) <= WINDOW_REL
    assert torch.equal(got, again)


@pytest.mark.parametrize("name,per_knot,elems", [
    ("window_apply_jtw", lambda k: k, (4, 2)),
    ("window_block_diag", lambda k: k * (k + 1) // 2, (4, 2))])
def test_reduction_smem_bytes_match_the_kernels(card, name, per_knot, elems):
    """The Python reckoning equals the library's own, with and without
    bands, for each j_win type a kernel reads (one layout for both):
    shared memory and rows per band; and every block of the plan's band
    fits on an SM."""
    entry = getattr(_cuda.lib(), f"cct_{name}_smem_bytes")
    rows = getattr(_cuda.lib(), f"cct_{name}_band_rows")
    for elem in elems:
        for k in wc.SUPPORTED_K:
            assert wc.per_knot(name, k) == per_knot(k)
            for gh, gw in ((16, 16), (25, 44), (34, 59), (45, 79), (48, 48),
                           (56, 56), (58, 58), (59, 59), (84, 84), (102, 102),
                           (127, 127), (128, 128), (160, 160), (10, 1000),
                           (400, 400)):
                assert entry(k, gh, gw, elem) == wc.reduction_smem_bytes(
                    name, gh, gw, k), (k, gh, gw)
                assert rows(k, gh, gw, elem) == wc.reduction_plan(
                    name, gh, gw, k), (k, gh, gw)
                assert wc._resident_blocks(name, k, gh, gw, card.index or 0,
                                           elem) >= 1
    # one grid row wider than fits one block: no band
    for k in wc.SUPPORTED_K:
        widest = wc.widest_row(name, k)
        assert rows(k, 2, widest, 4) == 1 and rows(k, 2, widest + 1, 4) == 0


@pytest.mark.parametrize("gh,gw,k,band_rows", [
    (16, 16, 2, 5), (16, 16, 2, 1), (16, 16, 5, 7), (21, 28, 5, 4),
    (45, 79, 5, 9)])
def test_narrower_bands_are_bit_identical(card, gh, gw, k, band_rows):
    """Every knot's sum runs over the same tiles in the same order whatever
    the band height: narrower bands than the plan's (here in the plan's
    layout) give bit-identical results, the untiled kernel included."""
    j_win, base, _, ws, w = _window_inputs(card, gh, gw, k, 30001, seed=11)
    for name, call in (("window_apply_jtw", lambda **kw: wc.window_apply_jtw(
            j_win, base, ws, gh, gw, k, **kw)),
            ("window_block_diag", lambda **kw: wc.window_block_diag(
                j_win, base, w, gh, gw, k, **kw))):
        rows, _ = wc.reduction_bands(name, gh, gw, k)
        assert band_rows < rows
        assert torch.equal(call(), call(band_rows=band_rows))


def _bf16_view(j_win, aligned):
    """A bfloat16 copy of ``j_win``; with ``aligned=False`` a contiguous
    view one element into a larger buffer, so no row is 4-byte aligned."""
    if aligned:
        return j_win.bfloat16()
    buf = torch.empty(j_win.numel() + 1, dtype=torch.bfloat16,
                      device=j_win.device)
    view = buf[1:].view(j_win.shape)
    view.copy_(j_win)
    assert view.is_contiguous() and view.data_ptr() % 4 == 2
    return view


@pytest.mark.parametrize("gh,gw,k,n,aligned", [
    (16, 16, 2, 20000, True), (16, 16, 5, 20000, True),
    # even N, not a multiple of 8
    (16, 16, 2, 20002, True), (21, 28, 5, 5006, True),
    # odd N
    (16, 16, 2, 20001, True), (21, 28, 5, 5001, True), (7, 9, 5, 33, True),
    # a j_win view 2 bytes past 4-byte alignment
    (16, 16, 2, 20000, False), (21, 28, 5, 5000, False),
    # the 1080p default grid, and JᵀW·s of K = 5 in bands of the float32
    # plan's height
    (45, 79, 2, 50000, True), (45, 79, 5, 50000, True)])
def test_bf16_window_kernels_match_plain(card, gh, gw, k, n, aligned):
    """window_apply_j and window_apply_jtw on a bfloat16 j_win: within 1e-4
    of the float64 plain version of the same bf16 values, repeatable, and
    counted as the bf16 variants (the float32 kernels do not launch)."""
    j32, base, tangent, ws, _ = _window_inputs(card, gh, gw, k, n, seed=k)
    j_win = _bf16_view(j32, aligned)
    j64 = j_win.double()
    cases = (
        ("window_apply_j", lambda: wc.window_apply_j(j_win, base, tangent),
         wc.window_apply_j_plain(j64, base, tangent.double())),
        ("window_apply_jtw",
         lambda: wc.window_apply_jtw(j_win, base, ws, gh, gw, k),
         wc.window_apply_jtw_plain(j64, base, ws.double(), gh, gw, k)),
    )
    for name, kernel, ref in cases:
        before = dict(_cuda.launches)
        got = kernel()
        again = kernel()
        torch.cuda.synchronize()
        assert _cuda.launches[name + "_bf16"] == before.get(name + "_bf16",
                                                            0) + 2
        assert _cuda.launches[name] == before.get(name, 0)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert _rel(got, ref) <= WINDOW_REL, name
        assert torch.equal(got, again), f"{name} is not repeatable"
        # the plain version widens bf16 itself
        plain = getattr(wc, name + "_plain")
        assert _rel(got, plain(j_win, base, *(
            (tangent,) if name == "window_apply_j" else (ws, gh, gw, k)))) \
            <= WINDOW_REL


@pytest.mark.parametrize("gh,gw,k,band_rows", [
    (16, 16, 2, 5), (16, 16, 5, 7), (45, 79, 5, 9), (45, 79, 2, 11)])
def test_bf16_jtw_narrower_bands_are_bit_identical(card, gh, gw, k,
                                                   band_rows):
    j32, base, _, ws, _ = _window_inputs(card, gh, gw, k, 30001, seed=12)
    j_win = j32.bfloat16()
    rows, _ = wc.reduction_bands("window_apply_jtw", gh, gw, k)
    assert band_rows < rows
    whole = wc.window_apply_jtw(j_win, base, ws, gh, gw, k)
    assert torch.equal(whole, wc.window_apply_jtw(j_win, base, ws, gh, gw, k,
                                                  band_rows=band_rows))


@pytest.mark.parametrize("gh,gw,k,n,aligned", [
    (16, 16, 2, 20000, True), (16, 16, 5, 20000, True),
    (16, 16, 2, 20002, True), (21, 28, 5, 5001, True),
    (16, 16, 2, 20000, False), (21, 28, 5, 5000, False),
    # the 1080p default grid: K = 5 in bands
    (45, 79, 2, 50000, True), (45, 79, 5, 50000, True)])
def test_bf16_block_diag_matches_plain(card, gh, gw, k, n, aligned):
    """window_block_diag on a bfloat16 j_win: within 1e-4 of the float64
    plain version of the same bf16 values, repeatable, counted as
    ``window_block_diag_bf16``, and within 1e-6 of the float32 kernel on
    the widened values (the same products; the partial sums split over the
    blocks the bf16 plan's occupancy gives)."""
    j32, base, _, _, w = _window_inputs(card, gh, gw, k, n, seed=20 + k)
    j_win = _bf16_view(j32, aligned)
    ref = wc.window_block_diag_plain(j_win.double(), base, w.double(), gh,
                                     gw, k)
    before = dict(_cuda.launches)
    got = wc.window_block_diag(j_win, base, w, gh, gw, k)
    again = wc.window_block_diag(j_win, base, w, gh, gw, k)
    torch.cuda.synchronize()
    assert _cuda.launches["window_block_diag_bf16"] == before.get(
        "window_block_diag_bf16", 0) + 2
    assert _cuda.launches["window_block_diag"] == before.get(
        "window_block_diag", 0)
    assert got.dtype == torch.float32 and got.shape == (gh, gw, k, k)
    assert _rel(got, ref) <= WINDOW_REL
    assert torch.equal(got, again)
    widened = wc.window_block_diag(j_win.float().contiguous(), base, w, gh,
                                   gw, k)
    assert _rel(got, widened) <= 1e-6
    assert _rel(got, wc.window_block_diag_plain(j_win, base, w, gh, gw, k)) \
        <= WINDOW_REL


@pytest.mark.parametrize("gh,gw,k,band_rows", [
    (16, 16, 2, 5), (16, 16, 5, 7), (45, 79, 5, 9)])
def test_bf16_block_diag_narrower_bands_are_bit_identical(card, gh, gw, k,
                                                          band_rows):
    j32, base, _, _, w = _window_inputs(card, gh, gw, k, 30001, seed=13)
    j_win = j32.bfloat16()
    rows, _ = wc.reduction_bands("window_block_diag", gh, gw, k)
    assert band_rows < rows
    whole = wc.window_block_diag(j_win, base, w, gh, gw, k)
    assert torch.equal(whole, wc.window_block_diag(j_win, base, w, gh, gw, k,
                                                   band_rows=band_rows))


@pytest.mark.parametrize("k,bases", [
    (2, "clustered"), (5, "clustered"), (2, "random"), (5, "random")])
def test_every_band_height_is_bit_identical_at_1080p(card, k, bases):
    """At the 1080p grid 45x79 both reductions give the same bits in bands
    of every height from 1 row to the plan's, on float32 and bf16 j_win:
    each knot sums the same tiles in the same order whatever the band,
    and the launch keeps the plan's block count and clusters of
    ``wc.CLUSTER`` (the one cluster size the plan takes)."""
    gh, gw = 45, 79
    j32, base, _, ws, w = _window_inputs(card, gh, gw, k, 40001, seed=30 + k,
                                         bases=bases)
    for j_win in (j32, j32.bfloat16()):
        for name, per_obs in (("window_apply_jtw", ws),
                              ("window_block_diag", w)):
            rows, _ = wc.reduction_bands(name, gh, gw, k)
            fn = getattr(wc, name)
            whole = fn(j_win, base, per_obs, gh, gw, k)
            for r in sorted({1, 2, 3, 4, 5, 9, 16, 22, 23, rows}):
                if r <= rows:
                    assert torch.equal(whole, fn(j_win, base, per_obs, gh, gw,
                                                 k, band_rows=r)), (name, r)


@pytest.mark.parametrize("gh,gw,k,bases", [
    (16, 16, 2, "random"), (16, 16, 5, "clustered"), (45, 79, 2, "clustered"),
    (45, 79, 5, "random")])
def test_bf16_reductions_equal_the_float32_kernels_on_the_widened_values(
        card, gh, gw, k, bases):
    """A bf16 j_win is widened as it is stored and then reduced as a
    float32 one: the same bits as the float32 kernel on the widened values
    where both take the same block count, else within 1e-6 (the sums split
    over other blocks)."""
    j32, base, _, ws, w = _window_inputs(card, gh, gw, k, 30001, seed=40 + k,
                                         bases=bases)
    j16 = j32.bfloat16()
    widened = j16.float().contiguous()
    for name, per_obs in (("window_apply_jtw", ws), ("window_block_diag", w)):
        fn = getattr(wc, name)
        got = fn(j16, base, per_obs, gh, gw, k)
        ref = fn(widened, base, per_obs, gh, gw, k)
        blocks = [wc._resident_blocks(name, k, gh, gw, card.index or 0, e)
                  for e in (2, 4)]
        if blocks[0] == blocks[1]:
            assert torch.equal(got, ref), name
        else:
            assert _rel(got, ref) <= 1e-6, name


def test_project_smem_bytes_match_the_kernels(card):
    """The Python reckoning of the staged-or-not choice, shared memory and
    block size equals the library's own for both kernels, and an SM holds
    at least 32 warps, staged or not."""
    lib = _cuda.lib()
    grids = ((16, 16), (21, 28), (45, 79), (68, 68), (69, 70), (80, 80),
             (81, 81), (84, 100), (139, 139), (140, 140))
    for blocks in (False, True):
        for gh, gw in grids:
            staged = cgc.project_staged(gh, gw, blocks)
            assert lib.cct_project_staged(int(blocks), gh, gw) == int(staged)
            nbytes = cgc.project_smem_bytes(gh, gw, blocks)
            assert lib.cct_project_smem_bytes(int(blocks), gh, gw) == nbytes
            assert nbytes <= _cuda.MAX_SMEM_BYTES
            threads = cgc.threads(gh, gw, blocks)
            assert lib.cct_project_threads(int(blocks), gh, gw) == threads
            per_sm, nblocks = cgc.launch_shape(blocks, 262_144, gh, gw, card)
            assert per_sm * threads >= 1024, (blocks, gh, gw)
            assert 1 <= nblocks <= per_sm * _cuda.num_sms(card)


def test_apply_j_staged_matches_the_kernel(card):
    """The Python reckoning of whether window_apply_j stages its tangent
    equals the library's own, on both sides of the limit."""
    lib = _cuda.lib()
    for k, gh, gw in ((2, 16, 16), (2, 170, 170), (2, 171, 171), (5, 45, 79),
                      (5, 107, 107), (5, 108, 108), (5, 11622, 1),
                      (5, 11623, 1)):
        staged = wc.apply_j_staged(gh, gw, k)
        assert lib.cct_window_apply_j_staged(k, gh, gw) == int(staged)
    assert not wc.apply_j_staged(108, 108, 5)
    assert wc.apply_j_staged(107, 107, 5)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    j_win, base, tangent, ws, w = _window_inputs(card, 16, 16, 2, 64, seed=0)
    with pytest.raises(TypeError):
        wc.window_apply_j(j_win.double(), base, tangent)
    # the block diagonal reads a bfloat16 j_win (its own bf16 variant);
    # the other inputs of every window kernel stay float32
    before = dict(_cuda.launches)
    wc.window_block_diag(j_win.bfloat16(), base, w, 16, 16, 2)
    assert _cuda.launches["window_block_diag_bf16"] == before.get(
        "window_block_diag_bf16", 0) + 1
    with pytest.raises(TypeError):
        wc.window_block_diag(j_win.bfloat16(), base, w.bfloat16(), 16, 16, 2)
    with pytest.raises(TypeError):
        wc.window_apply_jtw(j_win.bfloat16(), base, ws.bfloat16(), 16, 16, 2)
    with pytest.raises(ValueError):
        wc.window_block_diag(j_win, base.long(), w, 16, 16, 2)
    with pytest.raises(ValueError):
        wc.window_apply_j(j_win[:32], base, tangent)
    # No grid is refused for its size by the projections or J.v: one grid
    # row and column more than the largest square grid each projection
    # kernel stages (140x140 for project, 81x81 for project_blocks) and the
    # K=5 tangent at 108x108 launch the kernels that read from device memory.
    dirs = torch.tensor([[0.0, 0.0, 1.0]], device=card)
    before = dict(_cuda.launches)
    big = problems.pinhole_model(640, 480, 140, 140, device=card)
    assert not cgc.project_staged(140, 140)
    cgc.project_grid_coords(big.grid, dirs,
                            torch.tensor([[70.0, 70.0]], device=card),
                            (1, 1), (138, 138), 4, 1e-10)
    big = problems.pinhole_model(640, 480, 81, 81, device=card)
    assert not cgc.project_staged(81, 81, blocks=True)
    t1, t2 = (t.contiguous() for t in manifolds.direction_tangents(big.grid))
    cgc.project_blocks(big.grid, t1, t2, dirs,
                       torch.tensor([[40.0, 40.0]], device=card), (1, 1),
                       (79, 79), (1.0, 1.0), 4, 1e-10)
    j5, b5, t5, _, _ = _window_inputs(card, 108, 108, 5, 64, seed=0)
    assert not wc.apply_j_staged(108, 108, 5)
    wc.window_apply_j(j5, b5, t5)
    torch.cuda.synchronize()
    assert _cuda.launches["project"] == before.get("project", 0) + 1
    assert _cuda.launches["project_blocks"] == \
        before.get("project_blocks", 0) + 1
    assert _cuda.launches["window_apply_j"] == \
        before.get("window_apply_j", 0) + 1
    # a grid whose single row of K=5 blocks does not fit one block
    gh, gw = 2, 3264
    j5, b5, _, _, w5 = _window_inputs(card, gh, gw, 5, 64, seed=0)
    before = _cuda.launches["window_block_diag"]
    with pytest.raises(ValueError, match="shared memory"):
        wc.window_block_diag(j5, b5, w5, gh, gw, 5)
    with pytest.raises(ValueError, match="band_rows"):
        wc.window_block_diag(j5, b5, w5, 16, 16, 5, band_rows=17)
    assert _cuda.launches["window_block_diag"] == before


def test_lm_step_through_kernels_matches_plain(card, monkeypatch):
    state, data, _ = problems.make_bench_problem(n_points=128, n_poses=16,
                                                 device=card)
    options = lm_pcg.BAOptions(max_pcg_iterations=12, proj_iterations=8)
    warm = tuple(s.pixel for s in data)
    lam = torch.tensor(1e-2, dtype=torch.float32, device=card)
    _cuda.reset_launches()
    out_k = lm_pcg.lm_step(state, warm, lam, data, options)
    launched = dict(_cuda.launches)
    for name in ("project", "project_blocks", "window_apply_j",
                 "window_apply_jtw", "window_block_diag"):
        assert launched.get(name, 0) > 0, name
    for mod, name in ((cgc, "project_grid_coords"), (cgc, "project_blocks"),
                      (wc, "window_apply_j"), (wc, "window_apply_jtw"),
                      (wc, "window_block_diag")):
        monkeypatch.setattr(mod, name, getattr(mod, name + "_plain"))
    out_p = lm_pcg.lm_step(state, warm, lam, data, options)
    assert dict(_cuda.launches) == launched
    cost_k, cost_p = float(out_k[5]), float(out_p[5])
    assert abs(cost_k - cost_p) <= STEP_REL * abs(cost_p)
    dp = (out_k[0].points - out_p[0].points).abs().max()
    assert float(dp) <= STEP_REL * float(out_p[0].points.abs().max())

    # a short optimize in the cached-blocks form lowers the paired cost
    monkeypatch.undo()
    cached = dataclasses.replace(options, max_lm_iterations=2,
                                 lm_steps_per_call=2)
    _, info = lm_pcg.optimize(state, None, None, cached, data=data)
    hist = info["history"]
    assert hist[0]["accepted"] and hist[-1]["paired_new_cost"] < hist[0]["paired_cost"]


def test_bf16_cg_steps_through_kernels(card, monkeypatch):
    """cg_jacobian_dtype="bfloat16" on the card: one central and one
    noncentral LM step read the bf16 copies in the CG matvecs through the
    bf16 kernels (one launch of each per CG iteration; the float32 matvec
    kernels only outside CG), and match the same step through the plain
    versions to 1e-3 on the new cost and the points."""
    for make, lam0 in ((problems.make_bench_problem, 1e-2),
                       (problems.make_noncentral_bench_problem, -1.0)):
        state, data, _ = make(n_points=128, n_poses=16, device=card)
        options = lm_pcg.BAOptions(max_pcg_iterations=12, proj_iterations=6,
                                   cg_jacobian_dtype="bfloat16")
        warm = tuple(s.pixel for s in data)
        lam = torch.tensor(lam0, dtype=torch.float32, device=card)
        _cuda.reset_launches()
        out_k = lm_pcg.lm_step(state, warm, lam, data, options)
        launched = dict(_cuda.launches)
        iters = out_k[6]
        assert iters > 0
        assert launched["window_apply_j_bf16"] == iters
        assert launched["window_apply_jtw_bf16"] == iters
        # outside CG: the back-substitution's J·v, the gradient's and the
        # right-hand side's JᵀW·s
        assert launched["window_apply_j"] == 1
        assert launched["window_apply_jtw"] == 2
        with monkeypatch.context() as m:
            for name in ("window_apply_j", "window_apply_jtw",
                         "window_block_diag"):
                m.setattr(wc, name, getattr(wc, name + "_plain"))
            out_p = lm_pcg.lm_step(state, warm, lam, data, options)
        window = [n for n in launched if n.startswith("window_")]
        assert {n: _cuda.launches[n] for n in window} == {
            n: launched[n] for n in window}
        cost_k, cost_p = float(out_k[5]), float(out_p[5])
        assert abs(cost_k - cost_p) <= STEP_REL * abs(cost_p)
        dp = (out_k[0].points - out_p[0].points).abs().max()
        assert float(dp) <= STEP_REL * float(out_p[0].points.abs().max())


@pytest.mark.parametrize("kind", ["thin_prism_fisheye", "opencv", "radial"])
def test_parametric_optimize_on_the_card(card, kind):
    """A short optimize of a parametric camera on the card lowers the
    paired cost and launches no grid kernel; the bf16 run too."""
    state, data, _ = problems.make_parametric_bench_problem(
        kind, n_points=128, n_poses=16, device=card)
    for dtype in ("float32", "bfloat16"):
        options = lm_pcg.BAOptions(max_lm_iterations=2, max_pcg_iterations=12,
                                   cg_jacobian_dtype=dtype)
        _cuda.reset_launches()
        out, info = lm_pcg.optimize(state, None, None, options, data=data)
        torch.cuda.synchronize()
        assert not any(_cuda.launches.values()), dict(_cuda.launches)
        hist = info["history"]
        assert hist[0]["accepted"]
        assert hist[-1]["paired_new_cost"] < hist[0]["paired_cost"]
        assert out.intrinsics[0].params.is_cuda
        assert bool(torch.isfinite(out.intrinsics[0].params).all())


def test_noncentral_lm_step_through_kernels_matches_plain(card, monkeypatch):
    """One NoncentralGeneric LM step (K=5 window kernels; the projection is
    plain PyTorch) against the same step through the plain window
    versions, on the card; then a short run in both solver modes that use
    the kernels lowers the paired cost.  The step takes the λ of a first LM
    step (from the diagonal): at λ = 1e-2 the system is nearly undamped
    along the origin grid's ill-conditioned directions, where float32
    rounding in the window sums moves the new cost by about 1e-3."""
    state, data, _ = problems.make_noncentral_bench_problem(
        n_points=128, n_poses=16, device=card)
    options = lm_pcg.BAOptions(max_pcg_iterations=12, proj_iterations=6)
    warm = tuple(s.pixel for s in data)
    lam = torch.tensor(-1.0, dtype=torch.float32, device=card)
    _cuda.reset_launches()
    out_k = lm_pcg.lm_step(state, warm, lam, data, options)
    launched = dict(_cuda.launches)
    for name in ("window_apply_j", "window_apply_jtw", "window_block_diag"):
        assert launched.get(name, 0) > 0, name
    for name in ("window_apply_j", "window_apply_jtw", "window_block_diag"):
        monkeypatch.setattr(wc, name, getattr(wc, name + "_plain"))
    out_p = lm_pcg.lm_step(state, warm, lam, data, options)
    assert dict(_cuda.launches) == launched
    cost_k, cost_p = float(out_k[5]), float(out_p[5])
    assert abs(cost_k - cost_p) <= STEP_REL * abs(cost_p)
    dp = (out_k[0].points - out_p[0].points).abs().max()
    assert float(dp) <= STEP_REL * float(out_p[0].points.abs().max())
    monkeypatch.undo()
    for solver in ("schur", "pcg"):
        run = dataclasses.replace(options, max_lm_iterations=2, solver=solver)
        _, info = lm_pcg.optimize(state, None, None, run, data=data)
        hist = info["history"]
        assert hist[0]["accepted"]
        assert hist[-1]["paired_new_cost"] < hist[0]["paired_cost"]


def _small_pipeline_inputs():
    """The feature dataset and dense initialization of ``tests/test_e2e.py``
    (10 views of a 12×12 board by a 320×240 camera)."""
    from camera_calibration_torch.init.dense_init import (
        DenseInitializer, DenseInitOptions,
    )

    ds, _, _ = problems.make_calibration_dataset(seed=2, n_imagesets=10,
                                                 k=12, w=320, h=240)
    result = DenseInitializer(ds, 0, DenseInitOptions(
        max_initialization_attempts=100, seed=3,
        min_matched_area_accept=0.15)).run()
    return ds, result


def _small_pipeline(ds, result, device):
    from camera_calibration_torch import calibrate as cal
    from camera_calibration_torch.init.state_init import build_ba_state

    state, data, fid, _ = build_ba_state(ds, [result], (6, 6),
                                         dtype=torch.float32, device=device)
    options = cal.CalibrateOptions(
        num_pyramid_levels=2, approx_pixels_per_cell=40,
        outlier_removal_factor=8.0, final_iterations=30,
        pyramid_iterations=(8, 25))
    return cal.calibrate(state, data, options,
                         known_geometries=ds.known_geometries,
                         feature_id_to_point_index=fid, log=lambda *a: None)


def test_calibrate_on_the_card_matches_the_cpu(card):
    """The whole pipeline in float32 on the card (through the kernels) and
    on the CPU (the plain versions): the same outliers, medians within
    1e-3 px, both under the 0.02 px gate."""
    ds, result = _small_pipeline_inputs()
    _cuda.reset_launches()
    st_k, _, rep_k = _small_pipeline(ds, result, card)
    launched = dict(_cuda.launches)
    st_c, _, rep_c = _small_pipeline(ds, result, "cpu")
    assert st_k.points.device.type == "cuda"
    assert st_k.points.dtype == torch.float32
    for name in ("project", "project_blocks", "window_apply_jtw",
                 "window_block_diag"):
        assert launched.get(name, 0) > 0, (name, launched)
    assert rep_k["outliers_removed"] == rep_c["outliers_removed"]
    assert abs(rep_k["reprojection_error_median"]
               - rep_c["reprojection_error_median"]) <= 1e-3
    assert rep_k["reprojection_error_median"] < 0.02, rep_k


def test_native_densify_builds_and_loads(card):
    from camera_calibration_torch import native

    so = native.build()
    assert so.exists() and so.parent.parent == native.BUILD_ROOT
    native.lib()
    native.reset_calls()
    pts = np.full((4, 4, 3), np.nan)
    valid = np.zeros((4, 4), np.uint8)
    corners = np.array([[[0.0, 0.0], [4.0, 0.0], [4.0, 4.0], [0.0, 4.0]]])
    n = native.densify_matches_native(corners, np.array([[0, 0]]), 0.5,
                                      np.eye(3), np.zeros(3), 4, 4, 1.0, 1.0,
                                      pts, valid)
    assert n == 16 and valid.all() and native.calls["densify_matches"] == 1
    np.testing.assert_allclose(pts[0, 0], [0.0625, 0.0625, 0.0])


def _tagged_board(seed=4, noise=0.02, n=12, square_px=26.0):
    """The tagged 12×12 board of ``tests/test_detector.py``, rendered with
    the port's pattern module: (spec, image, pattern-to-pixel homography)."""
    from camera_calibration_torch.features import pattern as pat

    rng = np.random.default_rng(seed)
    spec = pat.PatternSpec(
        num_star_segments=16, squares_x=n, squares_y=n,
        square_length_in_meters=0.02,
        tags=[pat.AprilTagInfo(x=4, y=4, width=3, height=3, index=0)])
    c, s = np.cos(0.04), np.sin(0.04)
    h_pp = np.array([[square_px * c, -square_px * s, 2.2 * square_px],
                     [square_px * s, square_px * c, 2.0 * square_px],
                     [2e-5, -2e-5, 1.0]])
    size = int(square_px * (n + 3))
    img = pat.render_pattern(spec, np.linalg.inv(h_pp), (size, size),
                             supersample=4,
                             tag_renderer=pat.make_tag_renderer(spec))
    return spec, np.clip(img + rng.normal(0, noise, img.shape), 0, 1), h_pp


def test_detector_on_the_card_matches_the_cpu(card):
    """detect_batch with the images and the refinement on the card in
    float32 against the CPU in float64: at least 98% of the features in
    common, their positions within 1e-3 px at the median and 1e-2 px at
    most (float32 cannot follow the symmetry cost's flat valleys as far
    as float64), and within 0.1 px of the truth at the median."""
    from camera_calibration_torch.features import detector as fdet
    from camera_calibration_torch.features import pattern as pat

    boards = [_tagged_board(seed) for seed in (4, 5)]
    spec = boards[0][0]
    images = [b[1] for b in boards]
    got = fdet.FeatureDetector([spec], device=card).detect_batch(images)
    want = fdet.FeatureDetector([spec], device="cpu",
                                dtype=torch.float64).detect_batch(images)
    corner_map = pat.corners_for_patterns([spec])[0]
    for (gf, _), (wf, _), (_, _, h_pp) in zip(got, want, boards):
        g = {f.feature_id: f.xy for f in gf}
        w = {f.feature_id: f.xy for f in wf}
        common = sorted(set(g) & set(w))
        assert len(common) >= 0.98 * max(len(g), len(w)) > 0
        gaps = np.array([np.abs(g[k] - w[k]).max() for k in common])
        assert np.median(gaps) <= 1e-3 and gaps.max() <= 1e-2, gaps.max()
        truth = []
        for k in common:
            q = h_pp @ np.array([*corner_map[k], 1.0])
            truth.append(np.linalg.norm(g[k] - q[:2] / q[2]))
        assert np.median(truth) < 0.1


def test_corner_refinement_on_the_card_matches_the_cpu(card):
    """The fused two-stage refinement on a rendered board batch, float32 on
    the card against float64 on the CPU: the same converged flags but for
    1%, positions within 1e-3 px at the 95th percentile and 1e-2 px at
    most, and near the truth."""
    from camera_calibration_torch.features import patch_refinement as pref
    from camera_calibration_torch.features import pattern as pat
    from camera_calibration_torch.features import refinement as fref

    spec, img, h_pp = _tagged_board(seed=7, noise=0.01)
    rng = np.random.default_rng(3)
    coords = [c for c in spec.valid_feature_coords()][:160]
    gt, h_loc = [], []
    for fx, fy in coords:
        t = np.eye(3)
        t[0, 2], t[1, 2] = fx, fy
        hl = h_pp @ t
        hl = hl / hl[2, 2]
        q = h_pp @ np.array([fx, fy, 1.0])
        gt.append(q[:2] / q[2] - 0.5)
        hl[0:2, 2] = gt[-1]
        h_loc.append(hl)
    gt, h_loc = np.array(gt), np.array(h_loc)
    pred = gt + rng.uniform(-1.0, 1.0, gt.shape)
    whs = 10
    offs = fref.make_sample_offsets(rng, whs, 512) * whs
    h_rel = h_loc.copy()
    h_rel[:, 0:2, 2] = 0.0
    h_inv = np.linalg.inv(h_rel)
    q = np.einsum("nij,sj->nsi", h_inv[:, :, :2], offs) + h_inv[:, None, :, 2]
    samples = q[..., :2] / q[..., 2:3]
    rendered = pat.PatternSpec(16, 12, 12, 0.02).intensity(samples[:, :64])
    n = len(coords)

    def run(device, dtype):
        def t(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=device)
        return pref.refine_two_stage_patches(
            t(img[None]), t(pred), t(h_loc), t(samples[:, :64]),
            t(rendered), t(np.ones((n, 64)), torch.bool), t(samples),
            t(np.ones((n, 512)), torch.bool), whs,
            pref.patch_size_for_window(whs),
            t(np.zeros(n), torch.int32)).double().cpu().numpy()

    got = run(card, torch.float32)
    want = run("cpu", torch.float64)
    ok_g, ok_w = got[:, 3] > 0.5, want[:, 3] > 0.5
    assert int((ok_g != ok_w).sum()) <= max(1, 0.01 * n)
    both = ok_g & ok_w
    assert both.sum() >= 0.9 * n
    gaps = np.abs(got[both, :2] - want[both, :2]).max(axis=1)
    assert np.percentile(gaps, 95) <= 1e-3 and gaps.max() <= 1e-2, gaps.max()
    assert np.median(np.linalg.norm(got[both, :2] - gt[both], axis=1)) < 0.05


def _stereo_scene(card, w=240, h=136, baseline=0.2):
    """A float32 rig of two ``problems.pinhole_model`` cameras (8×12 grid)
    ``baseline`` apart, both views of the textured slanted plane
    z = 2 + 0.6·x (the reference stereo tests' texture at periods of
    about 10 px) and PatchMatch options of the command line's window."""
    from camera_calibration_torch.stereo import patch_match as pms

    model = problems.pinhole_model(w, h, 12, 8, device=card)
    d = pms.pixel_directions(
        problems.pinhole_model(w, h, 12, 8, device="cpu",
                               dtype=torch.float64), h, w, torch.float64,
        "cpu").numpy()
    views = []
    for cx in (0.0, baseline):
        c = np.array([cx, 0.0, 0.0])
        s = (2.0 - (c[2] - 0.6 * c[0])) / (d[..., 2] - 0.6 * d[..., 0])
        p = c + s[..., None] * d
        u, v = p[..., 0] * 1.1 * w / 160, p[..., 1] * 1.1 * w / 160
        tex = (0.5 + 0.2 * np.sin(37.0 * u) * np.cos(29.0 * v)
               + 0.15 * np.sin(11.0 * u + 23.0 * v)
               + 0.15 * np.cos(53.0 * u - 17.0 * v))
        views.append(torch.as_tensor(np.clip(tex, 0, 1), dtype=torch.float32,
                                     device=card))
    r = torch.eye(3, device=card)
    t = torch.tensor([-baseline, 0.0, 0.0], device=card)
    return model, views, r, t


def test_projection_at_the_stereo_shape(card):
    """``project`` at the shape of a 1080p stereo warp: all 2,073,600
    pixel rays of one camera of a 0.2 m rig on a plane at 2 m, projected
    into the other camera (45×79 grid, 6 iterations), warm-started from
    the kernel's projections of the level before (1.9 m), against the
    plain version: valid-mask flips on at most 0.1% of the points, the
    points valid in both within 1e-3 px at the 99.9th percentile and
    5e-2 px at most, and the kernel bitwise repeatable.  Not PX_TOL for
    every point: at the warp's 6 iterations the points that stop at the
    cap are not converged, and the two versions' rounding takes their LM
    paths apart there (2e-2 px at most, measured on the H100)."""
    from camera_calibration_torch.stereo import patch_match as pms

    model = problems.pinhole_model(1920, 1080, 79, 45, device=card)
    dirs = pms.pixel_directions(model, 1080, 1920, torch.float32,
                                card).reshape(-1, 3)
    t = torch.tensor([-0.2, 0.0, 0.0], device=card)
    lo, hi = cg._static_clamp_bounds(model)
    eps = cg.default_eps(torch.float32)
    warm, _, _ = cg.project_points(model, dirs * 1.9 + t, max_iterations=6)
    x = dirs * 2.0 + t
    d = (x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)).contiguous()
    g0 = cg.pixel_to_grid(model, warm).contiguous()
    n = d.shape[0]
    (gk, ck), (gp, cp), _, _ = _run_projections(model, d, g0, iters=6,
                                                blocks=False)
    vk, vp = ck < 1e4 * eps, cp < 1e4 * eps
    assert int(vp.sum()) > 0.85 * n
    assert int((vk != vp).sum()) <= 1e-3 * n
    sx, sy = cg.pixel_scale_to_grid_scale(model)
    dg = (gk - gp)[vk & vp].abs()
    err = torch.maximum(dg[:, 0] / sx, dg[:, 1] / sy).double()
    print(f"stereo shape: {int((vk != vp).sum())} flips, |dpx| p99.9 "
          f"{float(torch.quantile(err, 0.999)):.3e}, max {float(err.max()):.3e}")
    assert float(torch.quantile(err, 0.999)) <= 1e-3
    assert float(err.max()) <= 5e-2
    again = cgc.project_grid_coords(model.grid, d, g0, lo, hi, 6, eps)
    assert torch.equal(again[0], gk) and torch.equal(again[1], ck)


def _stereo_inputs(card):
    from camera_calibration_torch.stereo import patch_match as pms

    model, (left, right), r, t = _stereo_scene(card)
    h, w = left.shape
    opts = pms.PatchMatchOptions(min_depth=0.8, max_depth=6.0, seed=3)
    dirs = pms.pixel_directions(model, h, w, torch.float32, card)
    inv0 = torch.full((h, w), 0.5, device=card)
    return left, right, dirs, r, t, model, inv0, opts


def test_slanted_cost_on_the_card_matches_plain(card, monkeypatch):
    """``_slanted_cost`` with the 7×7 window through ``project`` against
    the same cost with the plain projection: validity flips on at most
    0.5% of the pixels, costs within 1e-3 elsewhere (the kernel and the
    plain LM differ by rounding, ~1e-4 px)."""
    from camera_calibration_torch.stereo import patch_match as pms

    args = _stereo_inputs(card)
    before = _cuda.launches["project"]
    evaluate, (n_f, c_f, cost_k, warm_k) = pms._patch_match_setup(*args)
    assert _cuda.launches["project"] == before + 1
    monkeypatch.setattr(cgc, "project_grid_coords",
                        cgc.project_grid_coords_plain)
    _, (_, _, cost_p, _) = pms._patch_match_setup(*args)
    fk, fp = torch.isfinite(cost_k), torch.isfinite(cost_p)
    assert float(fk.float().mean()) > 0.5
    assert int((fk != fp).sum()) <= 0.005 * fk.numel()
    both = fk & fp
    assert float((cost_k - cost_p)[both].abs().max()) <= 1e-3


def test_patch_match_round_on_the_card_matches_plain(card, monkeypatch):
    """One PatchMatch round with the same draws through ``project`` (13
    launches with the round's set-up) and through the plain projection.
    The round's accept tests compare candidate costs that can lie within
    the two projections' rounding (~1e-6) of each other, so a few
    pixels keep another candidate: the same plane at 95% of the pixels
    (96.3% measured on the H100), the same finite-cost pixels but for
    0.5%, and the resulting costs within 1e-3 at 99% of the pixels
    finite in both."""
    from camera_calibration_torch.stereo import patch_match as pms

    args = _stereo_inputs(card)
    opts = args[-1]
    h, w = args[0].shape
    gen = torch.Generator(device=card)
    gen.manual_seed(opts.seed)
    draws = pms._draws(gen, opts, h, w, args[0])

    def one_round():
        evaluate, state = pms._patch_match_setup(*args)
        return pms._patch_match_round(evaluate, args[2], state, *draws, opts)

    before = _cuda.launches["project"]
    nk, ck, costk, _ = one_round()
    assert _cuda.launches["project"] == before + 1 + 8 + 2 * opts.mutation_count
    monkeypatch.setattr(cgc, "project_grid_coords",
                        cgc.project_grid_coords_plain)
    np_, cp, costp, _ = one_round()
    same = ((nk - np_).abs().max(-1).values <= 1e-4) & (
        (ck - cp).abs() <= 1e-4 * cp.abs().clamp_min(1))
    fk, fp = torch.isfinite(costk), torch.isfinite(costp)
    fin = fk & fp
    close = (costk - costp)[fin].abs() <= 1e-3
    print(f"round: same plane {float(same.float().mean()):.4f}, finite "
          f"flips {int((fk != fp).sum())} of {fk.numel()}, costs within "
          f"1e-3 {float(close.float().mean()):.4f}")
    assert float(same.float().mean()) >= 0.95
    assert int((fk != fp).sum()) <= 0.005 * fk.numel()
    assert float(close.float().mean()) >= 0.99


def test_live_consumer_on_the_card_matches_the_cpu(card, tmp_path):
    """``LiveImageConsumer`` over a ``dir:`` input of two tagged boards and
    a blank frame, detecting on the card and on the CPU (float32 both):
    the same kept frames and feature ids, positions within 1e-3 px at the
    median and 1e-2 px at most (the detector test's bars)."""
    import cv2

    from camera_calibration_torch.ba.dataset import Dataset
    from camera_calibration_torch.features import detector as fdet
    from camera_calibration_torch.io.image_input import create_image_input
    from camera_calibration_torch.ui import live_capture as lc

    boards = [_tagged_board(seed) for seed in (4, 5)]
    spec = boards[0][0]
    frames = [(b[1] * 255).astype(np.uint8) for b in boards]
    frames.append(np.full_like(frames[0], 255))
    (tmp_path / "cam0").mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(tmp_path / "cam0" / f"img{i:03d}.png"), f)

    def consume(device):
        ds = Dataset(num_cameras=1, image_sizes=[])
        consumer = lc.LiveImageConsumer(
            ds, fdet.FeatureDetector([spec], device=device),
            lc.LiveCaptureOptions(), log=lambda *a: None)
        with create_image_input(f"dir:{tmp_path / 'cam0'}") as inp:
            kept = lc.run_live_capture(inp, consumer)
        return kept, ds

    (k_card, on_card), (k_cpu, on_cpu) = consume(card), consume("cpu")
    assert k_card == k_cpu == 2
    for a, b in zip(on_card.imagesets, on_cpu.imagesets):
        g = {f.feature_id: f.xy for f in a.features[0]}
        w = {f.feature_id: f.xy for f in b.features[0]}
        assert sorted(g) == sorted(w) and len(g) > 30
        gaps = np.array([np.abs(g[k] - w[k]).max() for k in w])
        assert np.median(gaps) <= 1e-3 and gaps.max() <= 1e-2, gaps.max()


def test_visualizer_arrays_on_the_card_match_the_cpu(card):
    """The histogram and direction hooks' arrays of a float32 bench-shaped
    state whose measured pixels lie 0.05 px (σ) off its own projections,
    through the ``project`` kernel on the card against the plain
    projection on the CPU: the same observations, error vectors within
    the projection tolerance (1e-3 px), histogram counts apart only where
    an error moved across a bin edge (1% of the counts), the direction
    colours within 0.05 where the error is over 0.05 px."""
    from camera_calibration_torch.ba.dataset import ObservationTable
    from camera_calibration_torch.ba.state import transform_to_camera
    from camera_calibration_torch.models import protocol
    from camera_calibration_torch.models.base import cast_floating
    from camera_calibration_torch.ui import calibration_visualizer as cv

    state, data, _ = problems.make_bench_problem(device=card, n_points=256,
                                                 n_poses=32)
    seg = data[0]
    x_cam, _ = transform_to_camera(state, seg.imageset, seg.camera,
                                   state.points[seg.point])
    px, _, ok = protocol.project_points(state.intrinsics[0], x_cam,
                                        init_xy=seg.pixel, max_iterations=30)
    rng = np.random.default_rng(0)
    noise = torch.as_tensor(rng.normal(0, 0.05, tuple(seg.pixel.shape)),
                            dtype=torch.float32, device=card)
    data = (ObservationTable(seg.imageset, seg.camera, seg.point,
                             torch.where(ok[:, None], px, seg.pixel) + noise,
                             seg.valid & ok, seg.grid_shape),)
    before = _cuda.launches["project"]
    (pix_k, e_k), = cv.error_vectors(state, data)
    assert _cuda.launches["project"] > before
    (pix_p, e_p), = cv.error_vectors(cast_floating(state, device="cpu"),
                                     cast_floating(data, device="cpu"))
    assert pix_k.shape == pix_p.shape and np.array_equal(pix_k, pix_p)
    assert np.abs(e_k - e_p).max() <= PX_TOL
    h_k = cv.error_histogram_counts(e_k, 0.2)
    h_p = cv.error_histogram_counts(e_p, 0.2)
    assert h_k.sum() == h_p.sum() > 0.9 * len(e_k)
    assert np.abs(h_k - h_p).sum() <= 0.01 * h_p.sum()
    far = np.abs(e_p).max(axis=1) > 0.05  # the hue moves < 0.02 rad there
    np.testing.assert_allclose(cv.error_direction_rgb(e_k[far]),
                               cv.error_direction_rgb(e_p[far]),
                               rtol=0, atol=0.05)


def test_one_rank_nccl_step_is_the_unsharded_step(card):
    """One LM step of a bench-shaped problem on tables sharded over a
    one-rank NCCL group equals the unsharded step bit for bit (an
    all-reduce over one rank is a copy), with an all-reduce for every CG
    iteration."""
    import socket

    import torch.distributed as dist

    from camera_calibration_torch.parallel import distributed, sharding

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert distributed.initialize(f"127.0.0.1:{port}", 1, 0, device=card)
    try:
        assert dist.get_backend() == "nccl"
        state, data, _ = problems.make_bench_problem(device=card,
                                                     n_points=256, n_poses=32)
        options = lm_pcg.BAOptions(max_pcg_iterations=20)
        warm = tuple(s_.pixel for s_ in data)
        lam = torch.tensor(-1.0, device=card)
        plain = lm_pcg.lm_step(state, warm, lam, data, options)
        sharding.reset_collectives()
        sharded = lm_pcg.lm_step(state, warm, lam,
                                 sharding.shard_observations(data), options)
        assert sharding.collectives["all_reduce"] >= sharded[6] > 0
        assert plain[3] == sharded[3] and plain[6] == sharded[6]
        for a, b in zip(plain[4:6] + plain[7:9], sharded[4:6] + sharded[7:9]):
            assert torch.equal(a, b)
        for name in ("rig_q_global", "rig_t_global", "points"):
            assert torch.equal(getattr(plain[0], name),
                               getattr(sharded[0], name))
        assert torch.equal(plain[0].intrinsics[0].grid,
                           sharded[0].intrinsics[0].grid)
    finally:
        dist.destroy_process_group()

"""Port parity: the grid-intrinsics window ops.

``intr_apply_j`` (J_intr·v), ``intr_apply_jtw`` (J_intrᵀ(W·s) scattered
onto the knot grid) and the per-knot K×K blocks of diag(JᵀWJ), for K = 2
(central models) and K = 5 (noncentral), on square and non-square grids.
Window bases reach past every edge of the grid, where knots must
contribute nothing.

The same float64 inputs, drawn from a numpy seed, go through the JAX
package's XLA forms on the CPU (``residuals.intr_apply_j``,
``residuals.intr_apply_jtw`` and the block-diagonal contraction of
``lm_pcg.jtwj_block_diag``) and through the port's wrappers, which take the
plain PyTorch versions for CPU tensors.  Tolerance: 1e-12 relative to the
largest value, since both sides sum the same float64 products in another
order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camera_calibration_torch import _cuda
from camera_calibration_torch.ba import residuals as tres
from camera_calibration_torch.ba import window_cuda as wc
from camera_calibration_tpu.ba import residuals as jres
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-12


def _inputs(gh, gw, k, n=300, seed=0):
    rng = np.random.default_rng(seed)
    j_win = rng.normal(0, 1, (32 * k, n))
    base = np.stack([rng.integers(-3, gw, n), rng.integers(-3, gh, n)],
                    1).astype(np.int32)
    tangent = rng.normal(0, 1, (gh, gw, k))
    ws = rng.normal(0, 1, (n, 2))
    w = rng.uniform(0, 1, n)
    return j_win, base, tangent, ws, w


def _block_diag_reference(j_win, base, w, gh, gw, k):
    """The XLA form of the per-knot blocks in lm_pcg.jtwj_block_diag."""
    n = j_win.shape[1]
    oy, ox = jres._window_onehots(jnp.asarray(base), gh, gw, jnp.float64)
    oy_s = jnp.stack(oy) * jnp.asarray(w)[None, :, None]
    ox_s = jnp.stack(ox)
    jw = jnp.asarray(j_win).reshape(2, 4, 4, k, n)
    prod = jnp.einsum("iyxjn,iyxln->yxjln", jw, jw)
    t = jnp.einsum("xnw,yxjln->ynwjl", ox_s, prod)
    return np.asarray(jnp.einsum("ynh,ynwjl->hwjl", oy_s, t))


def _assert_rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-300)
    assert float(np.abs(got - ref).max()) <= REL * scale


CASES = [(7, 7, 2), (7, 9, 2), (16, 16, 2), (7, 9, 5), (9, 7, 5)]


@pytest.mark.parametrize("gh,gw,k", CASES)
def test_intr_apply_j(gh, gw, k):
    j_win, base, tangent, _, _ = _inputs(gh, gw, k)
    ref = jres.intr_apply_j(
        jres.GridIntr(j_win=jnp.asarray(j_win), base_xy=jnp.asarray(base),
                      k_tangent=k), jnp.asarray(tangent))
    got = tres.intr_apply_j(
        tres.GridIntr(j_win=torch.as_tensor(j_win),
                      base_xy=torch.as_tensor(base), k_tangent=k),
        torch.as_tensor(tangent))
    _assert_rel(got, ref)


@pytest.mark.parametrize("gh,gw,k", CASES)
def test_intr_apply_jtw(gh, gw, k):
    j_win, base, tangent, ws, _ = _inputs(gh, gw, k, seed=1)
    ref = jres.intr_apply_jtw(
        jres.GridIntr(j_win=jnp.asarray(j_win), base_xy=jnp.asarray(base),
                      k_tangent=k), jnp.asarray(ws), jnp.asarray(tangent))
    got = tres.intr_apply_jtw(
        tres.GridIntr(j_win=torch.as_tensor(j_win),
                      base_xy=torch.as_tensor(base), k_tangent=k),
        torch.as_tensor(ws), torch.as_tensor(tangent))
    _assert_rel(got, ref)


@pytest.mark.parametrize("gh,gw,k", CASES)
def test_window_block_diag(gh, gw, k):
    j_win, base, _, _, w = _inputs(gh, gw, k, seed=2)
    ref = _block_diag_reference(j_win, base, w, gh, gw, k)
    got = wc.window_block_diag(torch.as_tensor(j_win), torch.as_tensor(base),
                               torch.as_tensor(w), gh, gw, k)
    _assert_rel(got, ref)
    np.testing.assert_array_equal(got, np.swapaxes(got.numpy(), -1, -2))


@pytest.mark.parametrize("k", [2, 5])
def test_plain_block_diag_widens_bf16(k):
    """The plain block diagonal reads a bfloat16 j_win as the reference's
    kernel does (``window_pallas.py:113``): widened to float32, the
    products and sums in float32."""
    j_win, base, _, _, w = _inputs(9, 11, k, seed=4)
    j16 = torch.as_tensor(j_win, dtype=torch.float32).bfloat16()
    base, w = torch.as_tensor(base), torch.as_tensor(w, dtype=torch.float32)
    got = wc.window_block_diag(j16, base, w, 9, 11, k)
    assert got.dtype == torch.float32
    assert torch.equal(got, wc.window_block_diag(j16.float(), base, w, 9, 11,
                                                 k))


def test_window_base_as_strided_view():
    """The projection kernel hands the window base over as a (2, N) buffer
    seen as (N, 2); the window ops take that strided view as it is."""
    gh, gw, k = 7, 9, 2
    j_win, base, tangent, ws, w = _inputs(gh, gw, k, seed=3)
    view = torch.as_tensor(np.ascontiguousarray(base.T)).T
    assert not view.is_contiguous()
    jt = torch.as_tensor(j_win)
    flat = torch.as_tensor(base)
    for fn, args in (
        (wc.window_apply_j, (torch.as_tensor(tangent),)),
        (wc.window_apply_jtw, (torch.as_tensor(ws), gh, gw, k)),
        (wc.window_block_diag, (torch.as_tensor(w), gh, gw, k)),
    ):
        torch.testing.assert_close(fn(jt, view, *args), fn(jt, flat, *args),
                                   rtol=0, atol=0)


def test_windows_outside_the_grid_contribute_nothing():
    gh, gw, k = 7, 9, 2
    n = 4
    j_win = torch.ones((32 * k, n), dtype=torch.float64)
    base = torch.tensor([[-4, 0], [gw, 0], [0, -4], [0, gh]], dtype=torch.int32)
    tangent = torch.ones((gh, gw, k), dtype=torch.float64)
    assert torch.count_nonzero(wc.window_apply_j(j_win, base, tangent)) == 0
    ws = torch.ones((n, 2), dtype=torch.float64)
    assert torch.count_nonzero(wc.window_apply_jtw(j_win, base, ws, gh, gw, k)) == 0
    w = torch.ones(n, dtype=torch.float64)
    assert torch.count_nonzero(wc.window_block_diag(j_win, base, w, gh, gw, k)) == 0


# Shared memory of one reduction block, counted by hand from the layout of
# csrc/window_reduce.cuh: the stage, prep rows of 64 + 1 floats (JᵀW·s 16K
# with ws folded in; the K=2 block diagonal its 16 * 3 products; the K=5
# one the 32K values and the weight, 161) and two int rows of 64 window
# bases; on grids of at most 256 knots (the knot-owner scheme) the row and
# column masks, (rows + gw) * 2 words; the band's accumulator, rows * gw
# knots of per_knot floats.  Four bytes each.
SMEM_CASES = [
    # 16x16, K=2, window_apply_jtw, owners: 32*65 + 128 + 32*2 + 256*2
    ("window_apply_jtw", 16, 16, 2, 4 * (32 * 65 + 128 + 64 + 256 * 2),
     11136),
    # 16x16, K=2, window_block_diag (3 values per knot, 48 prep rows)
    ("window_block_diag", 16, 16, 2, 4 * (48 * 65 + 128 + 64 + 256 * 3),
     16320),
    # 45x79 (the 1080p default grid), K=2, both ops
    ("window_apply_jtw", 45, 79, 2, 4 * (32 * 65 + 128 + 3555 * 2), 37272),
    ("window_block_diag", 45, 79, 2, 4 * (48 * 65 + 128 + 3555 * 3), 55652),
    # K=5 block diagonal at 48x48 and 49x49, one band
    ("window_block_diag", 48, 48, 5, 4 * (161 * 65 + 128 + 2304 * 15),
     180612),
    ("window_block_diag", 49, 49, 5, 4 * (161 * 65 + 128 + 2401 * 15),
     186432),
    # ... and at 56x56, the largest square grid of one band
    ("window_block_diag", 56, 56, 5, 4 * (161 * 65 + 128 + 3136 * 15),
     230532),
    # K=2 block diagonal at 128x128, one band
    ("window_block_diag", 128, 128, 2, 4 * (48 * 65 + 128 + 16384 * 3),
     209600),
]


@pytest.mark.parametrize("name,gh,gw,k,formula,total", SMEM_CASES)
def test_reduction_smem_bytes(name, gh, gw, k, formula, total):
    assert formula == total
    assert wc.reduction_bands(name, gh, gw, k) == (gh, 1)
    assert wc.reduction_smem_bytes(name, gh, gw, k) == total
    _cuda.check_smem(total, name)


# A bfloat16 j_win is widened as it is stored: the stage holds the same
# float32 rows as for a float32 j_win (the kernels' ``kPrepRows``: JᵀW·s
# 16K, the block diagonal 48 folded products at K=2 and 32K values and the
# weight at K=5), so one plan serves both element types.
BF16_SMEM_CASES = [
    ("window_apply_jtw", 16, 16, 2, 32,
     4 * (32 * 65 + 128 + 64 + 256 * 2), 11136),
    ("window_block_diag", 16, 16, 2, 48,
     4 * (48 * 65 + 128 + 64 + 256 * 3), 16320),
    ("window_block_diag", 16, 16, 5, 161,
     4 * (161 * 65 + 128 + 64 + 256 * 15), 57988),
]


@pytest.mark.parametrize("name,gh,gw,k,prep,formula,total", BF16_SMEM_CASES)
def test_bf16_reduction_smem_bytes(name, gh, gw, k, prep, formula, total):
    assert formula == total
    assert wc.prep_rows(name, k) == prep
    assert wc.reduction_smem_bytes(name, gh, gw, k) == total
    # JᵀW·s of K=5 folds ws into its 16K rows: half of the 32K it reads
    assert wc.prep_rows("window_apply_jtw", 5) == 80


# (name, gh, gw, k): grids where one grid row does not fit one block
# (one row: 4 * (prep * 65 + 128 + gw * per_knot) bytes), the only grids
# the banded reduction refuses.
TOO_WIDE = [("window_block_diag", 2, 3168, 5),
            ("window_block_diag", 1, 3168, 5),
            ("window_block_diag", 45, 18289, 2),
            ("window_apply_jtw", 3, 10557, 5)]


@pytest.mark.parametrize("name,gh,gw,k", TOO_WIDE)
def test_reduction_past_the_block_limit_is_refused(name, gh, gw, k):
    prep = {("window_block_diag", 5): 161, ("window_block_diag", 2): 48,
            ("window_apply_jtw", 5): 80}[name, k]
    per_knot = {"window_block_diag": k * (k + 1) // 2,
                "window_apply_jtw": k}[name]
    row = 4 * (prep * 65 + 128 + gw * per_knot)
    assert row > _cuda.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        wc.reduction_plan(name, gh, gw, k)
    # one column fewer fits, in bands of one row where it must
    assert gw - 1 == wc.widest_row(name, k)
    assert wc.reduction_plan(name, gh, gw - 1, k) == 1
    assert wc.reduction_smem_bytes(name, gh, gw - 1, k) \
        <= _cuda.MAX_SMEM_BYTES


# Bands of the reduction's partial pass, counted by hand: (name, gh, gw,
# k, band rows, bands, bytes of one block).
BAND_CASES = [
    # the 1080p default grid, K=5 block diagonal: the whole grid needs
    # 4 * (161 * 65 + 128 + 3555 * 15) = 255,672 B; two bands of 23 and 22
    # rows fit
    ("window_block_diag", 45, 79, 5, 23, 2,
     4 * (161 * 65 + 128 + 23 * 79 * 15)),
    # ... and its JtW takes one band
    ("window_apply_jtw", 45, 79, 5, 45, 1, 4 * (80 * 65 + 128 + 3555 * 5)),
    # one row past the largest square grid of one band
    ("window_block_diag", 59, 59, 5, 30, 2,
     4 * (161 * 65 + 128 + 30 * 59 * 15)),
    ("window_block_diag", 84, 84, 5, 28, 3,
     4 * (161 * 65 + 128 + 28 * 84 * 15)),
    # large grids
    ("window_block_diag", 160, 160, 5, 18, 9,
     4 * (161 * 65 + 128 + 18 * 160 * 15)),
    ("window_block_diag", 400, 400, 2, 45, 9,
     4 * (48 * 65 + 128 + 45 * 400 * 3)),
    # bands that do not divide the rows evenly: 10 rows in 4 bands of 3
    ("window_block_diag", 10, 1000, 5, 3, 4,
     4 * (161 * 65 + 128 + 3 * 1000 * 15)),
]


@pytest.mark.parametrize("name,gh,gw,k,rows,bands,nbytes", BAND_CASES)
def test_reduction_bands(name, gh, gw, k, rows, bands, nbytes):
    assert wc.reduction_plan(name, gh, gw, k) == rows
    assert wc.reduction_bands(name, gh, gw, k) == (rows, bands)
    assert wc.reduction_smem_bytes(name, gh, gw, k) == nbytes
    _cuda.check_smem(nbytes, name)
    # the fewest bands: one band fewer does not fit
    if bands > 1:
        wider = -(-gh // (bands - 1))
        assert wc._band_smem_bytes(name, wider, gw, k) > _cuda.MAX_SMEM_BYTES


REDUCTION_KS = [("window_apply_jtw", 2), ("window_block_diag", 2),
                ("window_apply_jtw", 5), ("window_block_diag", 5)]


@pytest.mark.parametrize("name,k", REDUCTION_KS)
def test_reduction_takes_every_grid_with_a_row_that_fits(name, k):
    """Every square grid up to 600x600, and the widest single rows, get a
    plan whose bands cover the grid and whose block fits; a grid that fits
    one block keeps one band."""
    for g in range(4, 601, 7):
        rows = wc.reduction_plan(name, g, g, k)
        bands = -(-g // rows)
        assert bands * rows >= g > (bands - 1) * rows
        assert wc.reduction_smem_bytes(name, g, g, k) \
            <= _cuda.MAX_SMEM_BYTES
        whole = wc._band_smem_bytes(name, g, g, k)
        assert (rows == g) == (whole <= _cuda.MAX_SMEM_BYTES)
    widest = wc.widest_row(name, k)
    assert wc.reduction_plan(name, 7, widest, k) == 1
    with pytest.raises(ValueError, match="shared memory"):
        wc.reduction_plan(name, 7, widest + 1, k)


@pytest.mark.parametrize("name,k", REDUCTION_KS)
def test_reduction_takes_every_grid_of_the_single_stage_layout(name, k):
    """Every grid that fitted the earlier single-stage kernel (tiles of 128
    observations for K=2 and 64 for K=5, j_win rows padded by one, no
    masks) gets a plan whose block fits one SM."""
    tile = 128 if k == 2 else 64
    per_knot = wc.per_knot(name, k)
    for gh in range(1, 200):
        for gw in range(gh, 2000):
            old = 4 * (gh * gw * per_knot + 32 * k * (tile + 1) + 4 * tile)
            if old > _cuda.MAX_SMEM_BYTES:
                break
            nbytes = wc.reduction_smem_bytes(name, gh, gw, k)
            assert nbytes <= _cuda.MAX_SMEM_BYTES, (gh, gw)


@pytest.mark.parametrize("n,per_sm,sms,bands,blocks", [
    (262_144, 2, 132, 1, 256),  # 4096 tiles: 16 per block
    (262_144, 1, 132, 2, 66),  # two bands share the SMs: 63 tiles a block
    (33, 2, 132, 1, 2),  # one tile: one cluster, one block without tiles
    (64 * 264 + 1, 2, 132, 1, 134),  # a tile past one wave: 133, 2 each
    (13_413, 2, 132, 1, 210),  # the image cell's 13,413 features
])
def test_reduction_blocks(n, per_sm, sms, bands, blocks):
    assert wc.reduction_blocks(n, per_sm, sms, bands) == blocks
    tiles = -(-n // wc.TILE)
    per_block = -(-tiles // blocks)
    # whole clusters, every band's blocks resident at once, each block
    # holding tiles but for the last cluster
    assert blocks % wc.CLUSTER == 0
    assert blocks * bands <= max(per_sm * sms, wc.CLUSTER * bands)
    assert (blocks - wc.CLUSTER) * per_block < tiles


# Blocks of 512 threads (16 warps) that one SM's 233,472 bytes of shared
# memory hold at the 1080p grid 45x79, each with 1,024 bytes reserved,
# at most 4 (2,048 threads): JᵀW·s K=2 37,272 B, block diagonal K=2
# 55,652 B, JᵀW·s K=5 92,412 B, the block diagonal K=5 in bands of 23
# rows 151,392 B.
@pytest.mark.parametrize("name,k,nbytes,blocks", [
    ("window_apply_jtw", 2, 37272, 4), ("window_block_diag", 2, 55652, 4),
    ("window_apply_jtw", 5, 92412, 2), ("window_block_diag", 5, 151392, 1)])
def test_reduction_blocks_per_sm_by_smem_at_1080p(name, k, nbytes, blocks):
    assert wc.reduction_smem_bytes(name, 45, 79, k) == nbytes
    assert min(233472 // (nbytes + 1024), 4) == blocks
    assert wc.smem_blocks_per_sm(name, 45, 79, k) == blocks
    # at least 16 warps an SM
    assert blocks * wc.THREADS // 32 >= 16


@pytest.mark.parametrize("gh,gw,owners", [
    (16, 16, True), (8, 32, True), (1, 256, True), (16, 17, False),
    (21, 28, False), (25, 44, False), (45, 79, False)])
def test_reduction_visit_scheme_by_grid(gh, gw, owners):
    """Grids of at most 256 knots (the bench's 16x16) take the knot-owner
    scheme with its masks; larger ones (the pipeline's 25x44 and up) the
    slot classes, whose block holds no masks."""
    assert wc.OWNER_KNOTS == 256
    assert wc.uses_owners(gh, gw) == owners
    for name, k in REDUCTION_KS:
        rows = wc.reduction_plan(name, gh, gw, k)
        masks = 4 * (rows + gw) * 2 if owners else 0
        assert wc.reduction_smem_bytes(name, gh, gw, k) == 4 * (
            wc.prep_rows(name, k) * 65 + 128
            + rows * gw * wc.per_knot(name, k)) + masks


def test_reduction_clusters_halve_the_partial_rows():
    """Blocks come in clusters of two that sum their accumulators into one
    partial row: the bench problem's 262,144 rows at two blocks an SM
    write 128 partial rows of the grid, not 256."""
    assert wc.CLUSTER == 2 and wc.THREADS == 16 * 32 and wc.TILE == 64
    blocks = wc.reduction_blocks(262_144, 2, 132)
    assert blocks // wc.CLUSTER == 128





def test_apply_j_plan_shape():
    """window_apply_j's blocks: 256 threads, an observation split over four
    warps (one per window row, both outputs) at K=2 and K=5, so 64
    observations a block."""
    assert wc.APPLY_J_THREADS == 256
    assert wc.APPLY_J_PARTS == 4
    assert wc.APPLY_J_OBS_PER_BLOCK == 64


# window_apply_j's blocks, counted by hand: one per 64 observations at any
# K and grid (the tangent is read through L1, so no grid size enters the
# plan).
@pytest.mark.parametrize("n,blocks", [
    (262_144, 4_096),  # the bench problem (16x16), and 108x108 at K=5
    (57_600, 900),  # [7]'s pyramid grids, 25x44 to 45x79
    (9_500, 149),  # [9b]'s 45x79: 148 full blocks and 28 observations
    (1, 1), (64, 1), (65, 2),
])
def test_apply_j_plan(n, blocks):
    assert wc.apply_j_blocks(n) == blocks

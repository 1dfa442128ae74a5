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


# Shared memory of one reduction block, counted by hand from the layouts of
# csrc/window_reduce.cuh.  Ring: two stages of 32K j_win rows of 64 + 4
# floats plus 4 * 64 floats of weights and bases, and (gh + gw) lines of 2
# mask words.  Compact: one stage of 32K rows of 32 + 4 floats plus 4 * 32,
# and (gh + gw) lines of 1 mask word.  Both: gh * gw * per_knot accumulator
# floats.  Four bytes each.
SMEM_CASES = [
    # 16x16, K=2, window_apply_jtw: 2*(64*68 + 256) + 32*2 + 256*2 floats
    (16, 16, 2, 2, wc.RING, 4 * (2 * (64 * 68 + 256) + 32 * 2 + 256 * 2), 39168),
    # 16x16, K=2, window_block_diag (3 values per knot)
    (16, 16, 2, 3, wc.RING, 4 * (2 * (64 * 68 + 256) + 32 * 2 + 256 * 3), 40192),
    # 45x79 (the 1080p default grid), K=2, both ops
    (45, 79, 2, 2, wc.RING, 4 * (2 * (64 * 68 + 256) + 124 * 2 + 3555 * 2), 66296),
    (45, 79, 2, 3, wc.RING, 4 * (2 * (64 * 68 + 256) + 124 * 2 + 3555 * 3), 80516),
    # K=5 block diagonal at 48x48, the largest square grid of the ring
    (48, 48, 5, 15, wc.RING, 4 * (2 * (160 * 68 + 256) + 96 * 2 + 2304 * 15), 228096),
    # ... and at 49x49 and 58x58 (the largest square grid of all), compact
    (49, 49, 5, 15, wc.COMPACT, 4 * (160 * 36 + 128 + 98 + 2401 * 15), 168004),
    (58, 58, 5, 15, wc.COMPACT, 4 * (160 * 36 + 128 + 116 + 3364 * 15), 225856),
    # K=2 block diagonal at 128x128: past the ring, compact
    (128, 128, 2, 3, wc.COMPACT, 4 * (64 * 36 + 128 + 256 + 16384 * 3), 207360),
]


@pytest.mark.parametrize("gh,gw,k,per_knot,layout,formula,total", SMEM_CASES)
def test_reduction_smem_bytes(gh, gw, k, per_knot, layout, formula, total):
    assert formula == total
    assert wc.reduction_layout(gh, gw, k, per_knot) == layout
    assert wc.reduction_smem_bytes(gh, gw, k, per_knot) == total
    _cuda.check_smem(total, "window_block_diag")


@pytest.mark.parametrize("gh,gw,k,per_knot", [
    (59, 59, 5, 15), (136, 136, 2, 3), (103, 103, 5, 5), (167, 167, 2, 2)])
def test_reduction_past_the_block_limit_is_refused(gh, gw, k, per_knot):
    nbytes = wc.reduction_smem_bytes(gh, gw, k, per_knot)
    assert nbytes > _cuda.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.check_smem(nbytes, "window_block_diag")
    _cuda.check_smem(_cuda.MAX_SMEM_BYTES, "window_block_diag")


@pytest.mark.parametrize("k,per_knot", [(2, 2), (2, 3), (5, 5), (5, 15)])
def test_reduction_takes_every_grid_of_the_single_stage_layout(k, per_knot):
    """Every grid that fitted the earlier single-stage kernel (tiles of 128
    observations for K=2 and 64 for K=5, j_win rows padded by one, no
    masks) still fits one block."""
    tile = 128 if k == 2 else 64
    for gh in range(1, 200):
        for gw in range(gh, 2000):
            old = 4 * (gh * gw * per_knot + 32 * k * (tile + 1) + 4 * tile)
            if old > _cuda.MAX_SMEM_BYTES:
                break
            nbytes = wc.reduction_smem_bytes(gh, gw, k, per_knot)
            assert nbytes <= _cuda.MAX_SMEM_BYTES, (gh, gw)


@pytest.mark.parametrize("n,tile,per_sm,sms,blocks", [
    (262_144, 64, 4, 132, 512),  # 4096 tiles: 8 per block
    (262_144, 64, 3, 132, 373),  # 11 per block, the last block 4
    (33, 64, 4, 132, 1),
    (64 * 132 * 4 + 1, 64, 4, 132, 265),  # a tile past one wave: 2 each
    (262_144, 32, 1, 132, 131),  # compact: 8192 tiles, 63 per block
])
def test_reduction_blocks(n, tile, per_sm, sms, blocks):
    assert wc.reduction_blocks(n, tile, per_sm, sms) == blocks
    tiles = -(-n // tile)
    per_block = -(-tiles // blocks)
    assert blocks <= per_sm * sms and (blocks - 1) * per_block < tiles

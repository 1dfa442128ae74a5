"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and the CUDA toolkit: the kernels have no
CPU mode.  They carry the ``gpu`` marker and skip (inside a fixture) where
``torch.cuda.is_available()`` is false.  They import no JAX, so on a
machine with a card they run without the suite's conftest:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda.py

Tolerances: the window kernels to 1e-4 of the largest value of a float64
plain reference (the reference package's bar for its TPU kernels); the
projection kernels to 1e-3 px on points valid in both versions, with at
most 1% valid-mask flips (float32 rounding can flip an accept test where
the cost is flat); one LM step to 1e-3 on cost and points.
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
    edge), "same" (every window at one base inside the grid) or "outside"
    (every window at (-10, -10), wholly off the grid)."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=card)

    j_win = f32(rng.normal(0, 1, (32 * k, n)))
    if bases == "random":
        xy = np.stack([rng.integers(-3, gw, n), rng.integers(-3, gh, n)], 1)
    else:
        at = (gw // 3, gh // 3) if bases == "same" else (-10, -10)
        xy = np.tile(np.array(at), (n, 1))
    base = torch.as_tensor(xy, dtype=torch.int32, device=card)
    return (j_win, base, f32(rng.normal(0, 1, (gh, gw, k))),
            f32(rng.normal(0, 1, (n, 2))), f32(rng.uniform(0, 1, n)))


# The largest square grid whose K=5 block-diagonal reduction fits in one
# block's shared memory (ba/window_cuda.reduction_smem_bytes): the compact
# layout.  The ring's largest is 48.
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
    # block diagonals in the compact layout (past the ring): K=5 at 56x56
    # and K=2 at 128x128, the largest square grids of the earlier
    # single-stage kernel, and K=5 at the largest of all
    (56, 56, 5, 20000, "random"), (128, 128, 2, 20000, "random"),
    (K5_MAX_GRID, K5_MAX_GRID, 5, 20001, "random"),
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


@pytest.mark.parametrize("gh,gw", [(16, 16), (21, 28)])
def test_projection_kernels_match_plain(card, gh, gw):
    model = problems.pinhole_model(640, 480, gw, gh, device=card)
    rng = np.random.default_rng(gh)
    n = 4000
    pix = torch.as_tensor(rng.uniform([2, 2], [638, 478], (n, 2)),
                          dtype=torch.float32, device=card)
    dirs = cg.unproject(model, pix)[0].contiguous()
    warm = pix + torch.as_tensor(rng.normal(0, 2.0, (n, 2)),
                                 dtype=torch.float32, device=card)
    warm[:4] = torch.tensor([[-50.0, -50.0], [700.0, 240.0], [320.0, -40.0],
                             [320.0, 530.0]], device=card)
    g0 = cg.pixel_to_grid(model, warm).contiguous()
    lo, hi = cg._static_clamp_bounds(model)
    eps = cg.default_eps(torch.float32)
    sx, sy = cg.pixel_scale_to_grid_scale(model)
    t1, t2 = (t.contiguous() for t in manifolds.direction_tangents(model.grid))

    gk, ck = cgc.project_grid_coords(model.grid, dirs, g0, lo, hi, 8, eps)
    gp, cp = cgc.project_grid_coords_plain(model.grid, dirs, g0, lo, hi, 8, eps)
    args = (model.grid, t1, t2, dirs, g0, lo, hi, (1 / sx, 1 / sy), 8, eps)
    bk = cgc.project_blocks(*args)
    bp = cgc.project_blocks_plain(*args)
    torch.cuda.synchronize()
    for (g_k, c_k), (g_p, c_p) in (((gk, ck), (gp, cp)),
                                   ((bk[0], bk[1]), (bp[0], bp[1]))):
        vk, vp = c_k < 1e4 * eps, c_p < 1e4 * eps
        assert int(vp.sum()) > 0.9 * n
        assert int((vk != vp).sum()) <= 0.01 * n
        both = vk & vp
        dg = (g_k - g_p)[both].abs()
        assert float(dg[:, 0].max()) / sx <= PX_TOL
        assert float(dg[:, 1].max()) / sy <= PX_TOL
    same = (bk[1] < 1e4 * eps) & (bp[1] < 1e4 * eps) & (bk[4] == bp[4]).all(1)
    assert _rel(bk[2][same], bp[2][same]) <= 1e-3
    assert _rel(bk[3][:, same], bp[3][:, same]) <= 1e-3


def test_window_apply_jtw_compact_layout(card):
    """J^T W s on a grid past its ring (K=2, 160x160), where the block
    diagonal does not fit at all."""
    gh = gw = 160
    assert wc.reduction_layout(gh, gw, 2, 2) == wc.COMPACT
    j_win, base, _, ws, _ = _window_inputs(card, gh, gw, 2, 20001, seed=3)
    ref = wc.window_apply_jtw_plain(j_win.double(), base, ws.double(), gh, gw, 2)
    got = wc.window_apply_jtw(j_win, base, ws, gh, gw, 2)
    again = wc.window_apply_jtw(j_win, base, ws, gh, gw, 2)
    assert _rel(got, ref) <= WINDOW_REL
    assert torch.equal(got, again)


@pytest.mark.parametrize("name,per_knot", [("window_apply_jtw", lambda k: k),
                                           ("window_block_diag",
                                            lambda k: k * (k + 1) // 2)])
def test_reduction_smem_bytes_match_the_kernels(card, name, per_knot):
    """The Python reckoning equals the library's own, in both layouts."""
    entry = getattr(_cuda.lib(), f"cct_{name}_smem_bytes")
    for k in wc.SUPPORTED_K:
        for gh, gw in ((16, 16), (45, 79), (48, 48), (56, 56), (58, 58),
                       (84, 84), (102, 102), (127, 127), (128, 128), (160, 160)):
            assert entry(k, gh, gw) == wc.reduction_smem_bytes(
                gh, gw, k, per_knot(k)), (k, gh, gw)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    j_win, base, tangent, ws, w = _window_inputs(card, 16, 16, 2, 64, seed=0)
    with pytest.raises(TypeError):
        wc.window_apply_j(j_win.double(), base, tangent)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        wc.window_apply_jtw(j_win.bfloat16(), base, ws, 16, 16, 2)
    with pytest.raises(ValueError):
        wc.window_block_diag(j_win, base.long(), w, 16, 16, 2)
    with pytest.raises(ValueError):
        wc.window_apply_j(j_win[:32], base, tangent)
    # 150·150·3 floats need more than a block's 227 KB of shared memory
    big = problems.pinhole_model(640, 480, 150, 150, device=card)
    dirs = torch.tensor([[0.0, 0.0, 1.0]], device=card)
    g0 = torch.tensor([[75.0, 75.0]], device=card)
    with pytest.raises(ValueError, match="shared memory"):
        cgc.project_grid_coords(big.grid, dirs, g0, (1, 1), (148, 148), 4, 1e-10)
    # one grid row and column more than the K=5 block diagonal takes
    g = K5_MAX_GRID + 1
    j5, b5, _, _, w5 = _window_inputs(card, g, g, 5, 64, seed=0)
    before = _cuda.launches["window_block_diag"]
    with pytest.raises(ValueError, match="shared memory"):
        wc.window_block_diag(j5, b5, w5, g, g, 5)
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

"""Grid-intrinsics window ops: CUDA kernels and their plain PyTorch versions.

Per observation ``n``, the intrinsics Jacobian has 2·16·K values that touch
the 4×4 knot window at base (bx, by).  ``j_win`` holds them as a
(2·16·K, N) array with rows ``[i, y, x, j]`` (row ``i·16K + (y·4+x)·K + j``)
and N contiguous.  Three ops read it:

- :func:`window_apply_j`: J_intr·v, ``out[n, i] = Σ_{y,x,j} j_win[i,y,x,j, n]
  · v[by+y, bx+x, j]`` (``csrc/window_apply_j.cu``);
- :func:`window_apply_jtw`: J_intrᵀ(W·s) scattered into (gh, gw, K)
  (``csrc/window_apply_jtw.cu``);
- :func:`window_block_diag`: the per-knot K×K blocks of diag(JᵀWJ)
  (``csrc/window_block_diag.cu``).

A knot outside the grid contributes nothing.  A tensor on the CPU goes to
the plain version; a CUDA float32 ``j_win`` with an int32 ``base_xy`` goes to
the kernel; anything else raises.  The kernels take K = 2 (central) and
K = 5 (noncentral).
"""

from __future__ import annotations

import functools

import torch

from camera_calibration_torch import _cuda

SUPPORTED_K = (2, 5)


# The two tile layouts of a reduction block (``cct::Tile<K, kRing>`` in
# ``csrc/window_reduce.cuh``), as (observations per tile, stages): a ring
# of two 64-observation stages wherever it fits in one block's shared
# memory, else one compact stage of 32.
RING = (64, 2)
COMPACT = (32, 1)


def _layout_smem_bytes(gh, gw, k, per_knot, layout):
    tile, stages = layout
    stage = 32 * k * (tile + 4) + 4 * tile
    return 4 * (stages * stage + (gh + gw) * (tile // 32) + gh * gw * per_knot)


def reduction_layout(gh: int, gw: int, k: int, per_knot: int) -> tuple:
    """The layout (:data:`RING` or :data:`COMPACT`) of the reduction
    kernels' block at this grid (``cct::use_ring``)."""
    fits = _layout_smem_bytes(gh, gw, k, per_knot, RING) <= _cuda.MAX_SMEM_BYTES
    return RING if fits else COMPACT


def reduction_smem_bytes(gh: int, gw: int, k: int, per_knot: int) -> int:
    """Shared memory of one block of the reduction kernels
    (``cct::partial_smem_bytes`` in ``csrc/window_reduce.cuh``): the
    layout's stages, each 32K j_win rows of ``tile + 4`` floats plus two
    floats and two ints per observation; one 32-bit mask word per 32
    observations of a tile for every grid row and column; and the
    (gh, gw, per_knot) accumulator grid."""
    return _layout_smem_bytes(gh, gw, k, per_knot,
                              reduction_layout(gh, gw, k, per_knot))


def reduction_blocks(n: int, tile: int, blocks_per_sm: int,
                     num_sms: int) -> int:
    """Blocks of the reduction's partial pass for N observations in tiles
    of ``tile``: at most as many as are resident on the card at once, and
    no more than it takes to give every block the same number of tiles (but
    for the last few)."""
    tiles = -(-n // tile)
    per_block = -(-tiles // (blocks_per_sm * num_sms))
    return -(-tiles // per_block)


@functools.cache
def _resident_blocks(name, k, gh, gw, device_index):
    """Partial-pass blocks of kernel ``name`` that one SM holds at once
    (the kernel's occupancy at this grid and K)."""
    with torch.cuda.device(device_index):
        per_sm = getattr(_cuda.lib(), f"cct_{name}_blocks_per_sm")(k, gh, gw)
    if per_sm <= 0:
        raise RuntimeError(f"{name}: no block of the reduction fits on an SM "
                           f"at {gh}x{gw}, K={k}")
    return per_sm


# ------------------------------ plain versions ------------------------------


def _window_index(base_xy, gh, gw):
    """Flat knot index (N, 4, 4) [y, x] (clamped into the grid) and the mask
    of knots inside the grid."""
    off = torch.arange(4, device=base_xy.device)
    kx = base_xy[:, 0].long()[:, None] + off
    ky = base_xy[:, 1].long()[:, None] + off
    mask = ((ky >= 0) & (ky < gh))[:, :, None] & ((kx >= 0) & (kx < gw))[:, None, :]
    flat = ky.clamp(0, gh - 1)[:, :, None] * gw + kx.clamp(0, gw - 1)[:, None, :]
    return flat, mask


def window_apply_j_plain(j_win, base_xy, tangent):
    """J_intr·v in plain PyTorch: (N, 2)."""
    gh, gw, k = tangent.shape
    n = j_win.shape[-1]
    flat, mask = _window_index(base_xy, gh, gw)
    vals = tangent.reshape(-1, k)[flat]  # (N, 4, 4, K)
    vals = torch.where(mask[..., None], vals, 0.0)
    wv = vals.reshape(n, 16 * k).T  # (16K, N)
    out0 = torch.sum(j_win[:16 * k] * wv, dim=0)
    out1 = torch.sum(j_win[16 * k:] * wv, dim=0)
    return torch.stack([out0, out1], dim=-1)


def window_apply_jtw_plain(j_win, base_xy, ws, gh, gw, k):
    """J_intrᵀ(W·s) scattered into (gh, gw, K) in plain PyTorch."""
    n = j_win.shape[-1]
    flat, mask = _window_index(base_xy, gh, gw)
    c = j_win[:16 * k] * ws[:, 0] + j_win[16 * k:] * ws[:, 1]  # (16K, N)
    c = c.reshape(4, 4, k, n).permute(3, 0, 1, 2)
    c = torch.where(mask[..., None], c, 0.0)
    out = torch.zeros((gh * gw, k), dtype=c.dtype, device=c.device)
    out.index_add_(0, flat.reshape(-1), c.reshape(-1, k))
    return out.reshape(gh, gw, k)


def window_block_diag_plain(j_win, base_xy, w, gh, gw, k):
    """Per-knot K×K blocks of diag(JᵀWJ) in plain PyTorch: (gh, gw, K, K)."""
    n = j_win.shape[-1]
    flat, mask = _window_index(base_xy, gh, gw)
    jw = j_win.reshape(2, 4, 4, k, n)
    prod = torch.einsum("iyxjn,iyxln->nyxjl", jw, jw) * w[:, None, None, None, None]
    prod = torch.where(mask[..., None, None], prod, 0.0)
    out = torch.zeros((gh * gw, k, k), dtype=prod.dtype, device=prod.device)
    out.index_add_(0, flat.reshape(-1), prod.reshape(-1, k, k))
    return out.reshape(gh, gw, k, k)


# --------------------------------- kernels ---------------------------------


def _check(name, j_win, base_xy, k):
    if j_win.dtype == torch.bfloat16:
        raise NotImplementedError(
            f"{name}: bfloat16 j_win is not ported yet (ROADMAP.md queue 1, "
            "item 9: cg_jacobian_dtype='bfloat16' in the window kernels)")
    _cuda.require_cuda_f32(name, j_win=j_win)
    if k not in SUPPORTED_K:
        raise ValueError(f"{name}: K={k} not in {SUPPORTED_K}")
    n = j_win.shape[1]
    if j_win.dim() != 2 or j_win.shape[0] != 32 * k:
        raise ValueError(f"{name}: j_win must be ({32 * k}, N), got "
                         f"{tuple(j_win.shape)}")
    if (base_xy.shape != (n, 2) or base_xy.dtype != torch.int32
            or base_xy.device != j_win.device):
        raise ValueError(f"{name}: base_xy must be int32 (N, 2) on the card")
    return n


def window_apply_j(j_win, base_xy, tangent):
    """J_intr·v: (N, 2)."""
    if j_win.device.type == "cpu":
        return window_apply_j_plain(j_win, base_xy, tangent)
    name = "window_apply_j"
    gh, gw, k = tangent.shape
    n = _check(name, j_win, base_xy, k)
    _cuda.require_cuda_f32(name, tangent=tangent)
    _cuda.check_smem(gh * gw * k * 4, name)
    out = torch.empty((n, 2), dtype=torch.float32, device=j_win.device)
    if n:
        _cuda.launch(name, j_win.data_ptr(), base_xy.data_ptr(),
                     base_xy.stride(0), base_xy.stride(1), tangent.data_ptr(),
                     n, gh, gw, k, out.data_ptr())
    return out


def _reduction_launch(name, j_win, base_xy, per_obs, gh, gw, k, cells_per_knot,
                      out_shape):
    n = _check(name, j_win, base_xy, k)
    _cuda.require_cuda_f32(name, per_obs=per_obs)
    _cuda.check_smem(reduction_smem_bytes(gh, gw, k, cells_per_knot), name)
    out = torch.empty(out_shape, dtype=torch.float32, device=j_win.device)
    if n == 0:
        return out.zero_()
    dev = j_win.device
    tile, _ = reduction_layout(gh, gw, k, cells_per_knot)
    nblocks = reduction_blocks(n, tile,
                               _resident_blocks(name, k, gh, gw, dev.index),
                               _cuda.num_sms(dev))
    partial = torch.empty((nblocks, gh * gw * cells_per_knot),
                          dtype=torch.float32, device=j_win.device)
    _cuda.launch(name, j_win.data_ptr(), base_xy.data_ptr(),
                 base_xy.stride(0), base_xy.stride(1), per_obs.data_ptr(),
                 n, gh, gw, k, partial.data_ptr(), nblocks, out.data_ptr())
    return out


def window_apply_jtw(j_win, base_xy, ws, gh, gw, k):
    """J_intrᵀ(W·s) scattered into (gh, gw, K); ws (N, 2)."""
    if j_win.device.type == "cpu":
        return window_apply_jtw_plain(j_win, base_xy, ws, gh, gw, k)
    if ws.shape != (j_win.shape[1], 2):
        raise ValueError("window_apply_jtw: ws must be (N, 2)")
    return _reduction_launch("window_apply_jtw", j_win, base_xy, ws, gh, gw,
                             k, k, (gh, gw, k))


def window_block_diag(j_win, base_xy, w, gh, gw, k):
    """Per-knot K×K blocks of diag(JᵀWJ): (gh, gw, K, K); w (N,)."""
    if j_win.device.type == "cpu":
        return window_block_diag_plain(j_win, base_xy, w, gh, gw, k)
    if w.shape != (j_win.shape[1],):
        raise ValueError("window_block_diag: w must be (N,)")
    return _reduction_launch("window_block_diag", j_win, base_xy, w, gh, gw,
                             k, k * (k + 1) // 2, (gh, gw, k, k))

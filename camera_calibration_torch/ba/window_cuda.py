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

All three also read a bfloat16 ``j_win`` (the CG matvecs' copies,
``cg_jacobian_dtype="bfloat16"``, for the two matvecs): the kernel widens
it to float32 on load and sums in float32 (its launches are counted as
``<name>_bf16``); the plain version widens it to float32 first.  Every
other tensor stays float32.  No caller of the LM step passes a bfloat16
``j_win`` to :func:`window_block_diag`: it builds the preconditioner from
the float32 blocks, as the reference package's step does.
"""

from __future__ import annotations

import functools

import torch

from camera_calibration_torch import _cuda

SUPPORTED_K = (2, 5)


# The two tile layouts of a reduction block (``cct::Tile<K, kRing, E>`` in
# ``csrc/window_reduce.cuh``), as (observations per tile, stages): a ring
# of two 64-observation stages wherever it fits in one block's shared
# memory, else one compact stage of 32.
RING = (64, 2)
COMPACT = (32, 1)


def prep_rows(name: str, k: int) -> int:
    """The float32 rows a bfloat16 tile of reduction kernel ``name`` is
    prepared into, as its C++ Op declares them (``kPrepRows``): ``JtwOp``
    keeps 16K, ``BlockDiagOp`` widens all 32K."""
    return {"window_apply_jtw": 16, "window_block_diag": 32}[name] * k


def _layout_smem_bytes(rows, gw, k, per_knot, layout, elem_bytes=4,
                       prep_rows=0):
    """One block's bytes: the stages (32K j_win rows of ``tile + 16 /
    elem_bytes`` elements, two floats and two ints per observation), for a
    bfloat16 j_win the float32 area its ``prep_rows`` prepared rows of
    ``tile + 4`` floats go to, the masks and the accumulator grid."""
    tile, stages = layout
    if elem_bytes != 4 and prep_rows <= 0:
        raise ValueError("a bfloat16 reduction plan needs the kernel's "
                         "prep_rows (window_cuda.prep_rows)")
    rows_floats = 32 * k * (tile + 16 // elem_bytes) * elem_bytes // 4
    prep = 0 if elem_bytes == 4 else prep_rows * (tile + 4)
    return 4 * (stages * (rows_floats + 4 * tile) + prep
                + (rows + gw) * (tile // 32) + rows * gw * per_knot)


def _fits(nbytes):
    return nbytes <= _cuda.MAX_SMEM_BYTES


@functools.cache
def reduction_plan(gh: int, gw: int, k: int, per_knot: int,
                   elem_bytes: int = 4, *, prep_rows: int = 0) -> tuple:
    """(layout, band rows) of the reduction kernels' blocks at this grid
    for a j_win of ``elem_bytes``-byte elements (``cct::band_rows`` and
    ``cct::use_ring``); a bfloat16 j_win also needs the kernel's
    :func:`prep_rows`.

    A block keeps ``band rows`` grid rows of the (gh, gw, per_knot)
    accumulator: all gh where the compact layout of the whole grid fits one
    block, else ``ceil(gh / nb)`` for the fewest bands ``nb`` that fit.
    The layout is :data:`RING` where it fits at those rows, else
    :data:`COMPACT`.  Raises where one grid row does not fit."""
    def nbytes(rows, layout):
        return _layout_smem_bytes(rows, gw, k, per_knot, layout, elem_bytes,
                                  prep_rows)

    for nb in range(1, gh + 1):
        rows = -(-gh // nb)
        if _fits(nbytes(rows, COMPACT)):
            return (RING if _fits(nbytes(rows, RING)) else COMPACT), rows
    raise ValueError(
        f"window reduction: one grid row of {gw} knots x {per_knot} values "
        f"needs {nbytes(1, COMPACT)} bytes of shared memory, above the "
        f"{_cuda.MAX_SMEM_BYTES}-byte limit of one Hopper block")


def reduction_layout(gh: int, gw: int, k: int, per_knot: int,
                     elem_bytes: int = 4, *, prep_rows: int = 0) -> tuple:
    """The layout (:data:`RING` or :data:`COMPACT`) of the reduction
    kernels' blocks at this grid."""
    return reduction_plan(gh, gw, k, per_knot, elem_bytes,
                          prep_rows=prep_rows)[0]


def reduction_bands(gh: int, gw: int, k: int, per_knot: int,
                    elem_bytes: int = 4, *, prep_rows: int = 0) -> tuple:
    """(band rows, bands): the second dimension of the partial pass's
    launch grid (1 band where the whole grid fits one block)."""
    rows = reduction_plan(gh, gw, k, per_knot, elem_bytes,
                          prep_rows=prep_rows)[1]
    return rows, -(-gh // rows)


def reduction_smem_bytes(gh: int, gw: int, k: int, per_knot: int,
                         band_rows: int | None = None,
                         elem_bytes: int = 4, *, prep_rows: int = 0) -> int:
    """Shared memory of one block of the reduction kernels
    (``cct::partial_smem_bytes`` in ``csrc/window_reduce.cuh``): the
    layout's stages, each 32K j_win rows plus two floats and two ints per
    observation, and for a bfloat16 j_win the float32 area it is prepared
    into (:func:`_layout_smem_bytes`); one 32-bit mask word per 32
    observations of a tile for each of the band's grid rows and for every
    grid column; and the band's (rows, gw, per_knot) accumulator grid.
    ``band_rows`` other than the plan's gives the block of such bands."""
    layout, rows = reduction_plan(gh, gw, k, per_knot, elem_bytes,
                                  prep_rows=prep_rows)
    if band_rows is not None:
        rows = band_rows
        ring = _fits(_layout_smem_bytes(rows, gw, k, per_knot, RING,
                                        elem_bytes, prep_rows))
        layout = RING if ring else COMPACT
    return _layout_smem_bytes(rows, gw, k, per_knot, layout, elem_bytes,
                              prep_rows)


def reduction_blocks(n: int, tile: int, blocks_per_sm: int,
                     num_sms: int) -> int:
    """Blocks of the reduction's partial pass for N observations in tiles
    of ``tile`` (:func:`_cuda.persistent_blocks`), in each band."""
    return _cuda.persistent_blocks(n, tile, blocks_per_sm, num_sms)


@functools.cache
def _resident_blocks(name, k, gh, gw, device_index, elem_bytes=4):
    """Partial-pass blocks of kernel ``name`` that one SM holds at once
    (the kernel's occupancy at this grid's band, K and j_win type)."""
    with torch.cuda.device(device_index):
        per_sm = getattr(_cuda.lib(), f"cct_{name}_blocks_per_sm")(
            k, gh, gw, elem_bytes)
    if per_sm <= 0:
        raise RuntimeError(f"{name}: no block of the reduction fits on an SM "
                           f"at {gh}x{gw}, K={k}")
    return per_sm


def apply_j_staged(gh: int, gw: int, k: int) -> bool:
    """Whether :func:`window_apply_j`'s kernel stages the (gh, gw, K)
    tangent in shared memory (``cct_window_apply_j_staged``): where it fits
    one block.  Elsewhere the same kernel (``kStaged = false``) reads it
    from device memory."""
    return 4 * gh * gw * k <= _cuda.MAX_SMEM_BYTES


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


def _widened(j_win):
    """A bfloat16 ``j_win`` as float32, so the sums are float32 (the
    reference package's fallback does the same); other types as they
    are."""
    return j_win.float() if j_win.dtype == torch.bfloat16 else j_win


def window_apply_j_plain(j_win, base_xy, tangent):
    """J_intr·v in plain PyTorch: (N, 2)."""
    j_win = _widened(j_win)
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
    j_win = _widened(j_win)
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
    j_win = _widened(j_win)
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
    """Raise unless the kernel takes these inputs; returns N."""
    _cuda.require_cuda_f32(name, (torch.float32, torch.bfloat16),
                           j_win=j_win)
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
    out = torch.empty((n, 2), dtype=torch.float32, device=j_win.device)
    if n:
        elem = j_win.element_size()
        _cuda.launch(name, j_win.data_ptr(), base_xy.data_ptr(),
                     base_xy.stride(0), base_xy.stride(1), tangent.data_ptr(),
                     n, gh, gw, k, elem, out.data_ptr(),
                     counted=_counted(name, j_win))
    return out


def _counted(name, j_win):
    """The launch-count key of the kernel variant that reads ``j_win``."""
    return name + "_bf16" if j_win.dtype == torch.bfloat16 else name


def _reduction_launch(name, j_win, base_xy, per_obs, gh, gw, k, cells_per_knot,
                      out_shape, band_rows):
    n = _check(name, j_win, base_xy, k)
    _cuda.require_cuda_f32(name, per_obs=per_obs)
    elem = j_win.element_size()
    prep = prep_rows(name, k) if elem == 2 else 0
    layout, rows = reduction_plan(gh, gw, k, cells_per_knot, elem,
                                  prep_rows=prep)
    if band_rows is not None:
        if not 1 <= band_rows <= gh:
            raise ValueError(f"{name}: band_rows must be in 1..{gh}")
        rows = band_rows
    _cuda.check_smem(reduction_smem_bytes(gh, gw, k, cells_per_knot, rows,
                                          elem, prep_rows=prep), name)
    out = torch.empty(out_shape, dtype=torch.float32, device=j_win.device)
    if n == 0:
        return out.zero_()
    dev = j_win.device
    tile, _ = layout
    # the plan's occupancy sets the block count, so bands of other heights
    # sum the same partial rows
    nblocks = reduction_blocks(
        n, tile, _resident_blocks(name, k, gh, gw, dev.index, elem),
        _cuda.num_sms(dev))
    partial = torch.empty((nblocks, gh * gw * cells_per_knot),
                          dtype=torch.float32, device=j_win.device)
    _cuda.launch(name, j_win.data_ptr(), base_xy.data_ptr(),
                 base_xy.stride(0), base_xy.stride(1), per_obs.data_ptr(),
                 n, gh, gw, k, elem, rows, partial.data_ptr(), nblocks,
                 out.data_ptr(), counted=_counted(name, j_win))
    return out


def window_apply_jtw(j_win, base_xy, ws, gh, gw, k, *, band_rows=None):
    """J_intrᵀ(W·s) scattered into (gh, gw, K); ws (N, 2).

    ``band_rows`` (kernel only): grid rows per band of the partial pass in
    place of :func:`reduction_plan`'s; the result is the same, bit for
    bit, as long as the layout is."""
    if j_win.device.type == "cpu":
        return window_apply_jtw_plain(j_win, base_xy, ws, gh, gw, k)
    if ws.shape != (j_win.shape[1], 2):
        raise ValueError("window_apply_jtw: ws must be (N, 2)")
    return _reduction_launch("window_apply_jtw", j_win, base_xy, ws, gh, gw,
                             k, k, (gh, gw, k), band_rows)


def window_block_diag(j_win, base_xy, w, gh, gw, k, *, band_rows=None):
    """Per-knot K×K blocks of diag(JᵀWJ): (gh, gw, K, K); w (N,).
    ``band_rows`` as for :func:`window_apply_jtw`."""
    if j_win.device.type == "cpu":
        return window_block_diag_plain(j_win, base_xy, w, gh, gw, k)
    if w.shape != (j_win.shape[1],):
        raise ValueError("window_block_diag: w must be (N,)")
    return _reduction_launch("window_block_diag", j_win, base_xy, w, gh, gw,
                             k, k * (k + 1) // 2, (gh, gw, k, k), band_rows)

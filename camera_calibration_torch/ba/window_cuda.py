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


# The layout of a reduction block (``csrc/window_reduce.cuh``): THREADS
# threads; tiles of TILE observations, staged as float32 rows of STRIDE;
# thread-block clusters of CLUSTER blocks that sum their accumulators into
# one partial row.  Grids of at most OWNER_KNOTS knots take the knot-owner
# scheme (two owner threads a knot, row and column masks of WORDS words);
# larger grids the slot-class scheme (one warp per slot class of knots).
TILE = 64
THREADS = 512
STRIDE = TILE + 1
CLUSTER = 2
WORDS = TILE // 32
OWNER_KNOTS = THREADS // WORDS
REDUCTIONS = ("window_apply_jtw", "window_block_diag")


def per_knot(name: str, k: int) -> int:
    """Values per knot of reduction kernel ``name``: K for JᵀW·s, the
    K(K+1)/2 upper pairs of a block for the block diagonal."""
    return {"window_apply_jtw": k, "window_block_diag": k * (k + 1) // 2}[name]


def prep_rows(name: str, k: int) -> int:
    """Float32 rows of one observation in the stage of reduction kernel
    ``name``, as its C++ Op declares them (``kPrepRows``), for either
    element type: ``JtwOp`` keeps 16K (ws folded in); ``BlockDiagOp`` the
    16 slots' K(K+1)/2 products where they take no more rows than a slot's
    2K values (K = 2), else the 32K values and the weight."""
    if name == "window_apply_jtw":
        return 16 * k
    pk = per_knot(name, k)
    return 16 * pk if pk <= 2 * k else 32 * k + 1


def uses_owners(gh: int, gw: int) -> bool:
    """Whether the reductions take the knot-owner scheme at this grid
    (``cct::use_owners``): at most OWNER_KNOTS knots.  Larger grids take
    the slot-class scheme."""
    return gh * gw <= OWNER_KNOTS


def _band_smem_bytes(name, rows, gw, k, owners=False):
    """One block's bytes: the stage (``prep_rows`` rows of STRIDE floats,
    two int rows of TILE window bases), in the owner scheme the masks
    ((rows + gw) × WORDS words), and the band's accumulator of rows × gw
    knots."""
    return 4 * (prep_rows(name, k) * STRIDE + 2 * TILE
                + (rows + gw) * WORDS * owners
                + rows * gw * per_knot(name, k))


def _fits(nbytes):
    return nbytes <= _cuda.MAX_SMEM_BYTES


@functools.cache
def reduction_plan(name: str, gh: int, gw: int, k: int) -> int:
    """Grid rows per band of reduction kernel ``name``'s blocks at this
    grid (``cct::band_rows``), for either element type.

    A block keeps ``band rows`` grid rows of the accumulator: all gh where
    the whole grid fits one block, else ``ceil(gh / nb)`` for the fewest
    bands ``nb`` that fit.  Raises where one grid row does not fit."""
    owners = uses_owners(gh, gw)
    for nb in range(1, gh + 1):
        rows = -(-gh // nb)
        if _fits(_band_smem_bytes(name, rows, gw, k, owners)):
            return rows
    raise ValueError(
        f"{name}: one grid row of {gw} knots x {per_knot(name, k)} values "
        f"needs {_band_smem_bytes(name, 1, gw, k)} bytes of shared memory, "
        f"above the {_cuda.MAX_SMEM_BYTES}-byte limit of one Hopper block "
        f"(rows of at most {widest_row(name, k)} knots fit)")


def reduction_bands(name: str, gh: int, gw: int, k: int) -> tuple:
    """(band rows, bands): the second dimension of the partial pass's
    launch grid (1 band where the whole grid fits one block)."""
    rows = reduction_plan(name, gh, gw, k)
    return rows, -(-gh // rows)


def reduction_smem_bytes(name: str, gh: int, gw: int, k: int,
                         band_rows: int | None = None) -> int:
    """Shared memory of one block of reduction kernel ``name``
    (``cct::partial_smem_bytes`` in ``csrc/window_reduce.cuh``), for either
    element type: the stage, :func:`prep_rows` float rows of STRIDE and two
    int rows of TILE window bases; in the owner scheme (:func:`uses_owners`)
    the masks, WORDS words for each of the band's rows and the grid's
    columns; and the band's accumulator of rows × gw knots.  ``band_rows``
    other than the plan's gives the block of such bands."""
    rows = reduction_plan(name, gh, gw, k) if band_rows is None else band_rows
    return _band_smem_bytes(name, rows, gw, k, uses_owners(gh, gw))


def widest_row(name: str, k: int) -> int:
    """The widest grid row one block of reduction kernel ``name`` holds (a
    band of one row); past it the plan raises."""
    room = (_cuda.MAX_SMEM_BYTES // 4 - prep_rows(name, k) * STRIDE
            - 2 * TILE)
    return room // per_knot(name, k)


def smem_blocks_per_sm(name: str, gh: int, gw: int, k: int) -> int:
    """Blocks of reduction kernel ``name`` at this grid's band that one
    SM's shared memory holds (each also takes the SM's per-block
    reservation), at most as many as its threads allow; registers may
    allow fewer (``cct_<name>_blocks_per_sm`` says how many run)."""
    nbytes = reduction_smem_bytes(name, gh, gw, k)
    return min(_cuda.SM_SMEM_BYTES // (nbytes + _cuda.BLOCK_RESERVED_SMEM),
               _cuda.SM_THREADS // THREADS)


def reduction_blocks(n: int, blocks_per_sm: int, num_sms: int,
                     bands: int = 1) -> int:
    """Blocks of the reduction's partial pass in each band for N
    observations: every band's blocks resident at once (the card's
    ``blocks_per_sm * num_sms`` shared among the bands), each block given
    the same number of tiles but for the last few
    (:func:`_cuda.persistent_blocks`), rounded up to whole clusters."""
    per_band = max(1, blocks_per_sm * num_sms // bands)
    blocks = _cuda.persistent_blocks(n, TILE, 1, per_band)
    return -(-blocks // CLUSTER) * CLUSTER


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


def _reduction_launch(name, j_win, base_xy, per_obs, gh, gw, k, out_shape,
                      band_rows):
    n = _check(name, j_win, base_xy, k)
    _cuda.require_cuda_f32(name, per_obs=per_obs)
    elem = j_win.element_size()
    rows, bands = reduction_bands(name, gh, gw, k)
    if band_rows is not None:
        if not 1 <= band_rows <= gh:
            raise ValueError(f"{name}: band_rows must be in 1..{gh}")
        rows = band_rows
    _cuda.check_smem(reduction_smem_bytes(name, gh, gw, k, rows), name)
    out = torch.empty(out_shape, dtype=torch.float32, device=j_win.device)
    if n == 0:
        return out.zero_()
    dev = j_win.device
    # the plan's bands and occupancy set the block count, so bands of other
    # heights sum the same partial rows
    nblocks = reduction_blocks(
        n, _resident_blocks(name, k, gh, gw, dev.index, elem),
        _cuda.num_sms(dev), bands)
    partial = torch.empty((nblocks // CLUSTER, gh * gw * per_knot(name, k)),
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
    bit."""
    if j_win.device.type == "cpu":
        return window_apply_jtw_plain(j_win, base_xy, ws, gh, gw, k)
    if ws.shape != (j_win.shape[1], 2):
        raise ValueError("window_apply_jtw: ws must be (N, 2)")
    return _reduction_launch("window_apply_jtw", j_win, base_xy, ws, gh, gw,
                             k, (gh, gw, k), band_rows)


def window_block_diag(j_win, base_xy, w, gh, gw, k, *, band_rows=None):
    """Per-knot K×K blocks of diag(JᵀWJ): (gh, gw, K, K); w (N,).
    ``band_rows`` as for :func:`window_apply_jtw`."""
    if j_win.device.type == "cpu":
        return window_block_diag_plain(j_win, base_xy, w, gh, gw, k)
    if w.shape != (j_win.shape[1],):
        raise ValueError("window_block_diag: w must be (N,)")
    return _reduction_launch("window_block_diag", j_win, base_xy, w, gh, gw,
                             k, (gh, gw, k, k), band_rows)

"""Joint bundle adjustment: Levenberg-Marquardt with block elimination.

- Per-observation residual + Jacobian blocks are computed once per LM
  iteration (closed form, batched) and kept on the device; with
  ``block_chunk`` they are computed in chunks of observations.
- The normal equations (JᵀWJ + λI) δ = −g are solved by one of the solver
  modes: matrix-free block-Jacobi PCG on the full system (``pcg``) or on
  the system reduced by eliminating the points (``schur``) or the imageset
  poses (``schur_poses``); or a dense Cholesky solve of the explicitly
  assembled reduced system (``schur_direct``: poses eliminated,
  ``schur_direct_points``: points).  ``auto`` picks ``schur_direct`` while
  the reduced system is small, ``schur`` beyond.  A Schur mode whose
  eliminated group is frozen falls back to ``pcg``.
- The intrinsics legs of every matvec and the block-Jacobi blocks of a
  grid model's intrinsics go through the window kernels
  (``ba/window_cuda.py``); the CentralGeneric projections go through the
  projection kernels (``models/central_generic_cuda.py``).  A parametric
  model's dense (2, P) blocks are contracted by einsums.  On grid tables
  the pose and point legs of the point-eliminated Schur solve (every
  matvec, the right-hand side, the back-substitution) go through two
  kernels (``ba/schur_cuda.py``), for any camera model.
- An LM step is judged on the observations valid in both states (paired
  cost comparison); λ is halved on accept and doubled on reject.
- Projections warm-start from the previous converged pixels.

Both step forms are ported: the two-pass step (blocks pass + cost-only
pass, :func:`lm_step` without ``blocks``) and the cached-blocks step (the
test-state blocks pass doubles as the accept test and the next iteration's
cache, :func:`make_lm_scan`).  With ``cg_jacobian_dtype="bfloat16"`` the
CG matvecs read bfloat16 copies of the Jacobian blocks, made once per
solve (:func:`_cg_cast_blocks`); the gradient, the right-hand side, the
back-substitution, the preconditioner and the accept test keep the
float32 blocks.

Tables sharded over a process group (``parallel/sharding.py``) hold this
rank's observations; every sum over observations is then summed across
the ranks (:func:`_reduce`): the tangent of each JᵀW·s, the block
diagonal, the paired and full costs, and the normal equations of
:func:`schur_direct_solve`.  Plain tables call no collective.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings

import numpy as np
import torch

from camera_calibration_torch import tracing
from camera_calibration_torch.ba import residuals as res
from camera_calibration_torch.ba import schur_cuda, window_cuda
from camera_calibration_torch.ba.dataset import (
    ObservationTable, split_by_camera, to_grid_layout,
)
from camera_calibration_torch.ba.state import (
    BAState, BATangent, apply_freeze, fix_gauge_mask, retract,
    transform_to_camera, zero_tangent,
)
from camera_calibration_torch.models import protocol
from camera_calibration_torch.models.central_generic import CentralGenericModel
from camera_calibration_torch.ops import linalg, manifolds
from camera_calibration_torch.ops.segsum import onehot_segment_sum
from camera_calibration_torch.parallel import sharding


@dataclasses.dataclass(frozen=True)
class BAOptions:
    max_lm_iterations: int = 30
    max_pcg_iterations: int = 50
    # "schur": eliminate the 3×3 point blocks, PCG on the reduced
    # rig+camera+intrinsics system; "schur_poses": eliminate the 6×6
    # imageset pose blocks, PCG on cameras+points+intrinsics;
    # "schur_direct" / "schur_direct_points": the same eliminations (poses /
    # points) and a dense Cholesky solve of the assembled reduced system
    # (memory ∝ reduced dim²); "pcg": PCG on the full system; "auto":
    # resolved by optimize() from the problem size (resolve_solver).
    solver: str = "schur"
    # Inexact-Newton forcing: stop CG when the residual drops below this
    # fraction of ||b||.
    pcg_rel_tolerance: float = 0.03
    huber_px: float = 1.0
    # Projection LM iterations per blocks sweep (warm-started).
    proj_iterations: int = 4
    lambda_initial_factor: float = 1e-4  # × mean diag
    lambda_min: float = 1e-10
    cost_reduction_threshold: float = 1e-5  # relative
    max_consecutive_rejects: int = 3
    # variable groups to freeze ("poses", "extrinsics", "points",
    # "intrinsics")
    freeze: tuple = ()
    # 1 = the two-pass step; k > 1 = k cached-blocks steps per call.
    lm_steps_per_call: int = 1
    # Run verify_cost() once before optimizing.
    debug_verify: bool = False
    # "auto" re-lays each per-camera table into dense (imagesets × points)
    # grid layout when M·P ≤ grid_layout_max_expand × valid observations;
    # "flat" keeps the given tables.
    table_layout: str = "auto"
    grid_layout_max_expand: float = 1.6
    # Blocks and costs in chunks of this many observations (flat layout
    # within a chunk) where it divides a table's row count; None = one
    # evaluation per table.
    block_chunk: int | None = None
    # optimize() runs its LM loop under torch.profiler and writes the trace
    # (``lm_trace.json``) into this directory.
    profile_dir: str | None = None
    # Warm-start each PCG solve from the previous cached-blocks step.
    cg_warm_start: bool = False
    # Jacobian-block dtype inside the CG matvecs: "float32" or "bfloat16".
    cg_jacobian_dtype: str = "float32"
    # "halve_double" (accept → λ/2, reject → λ×2) or "gain_ratio"
    # (accept → λ·max(1/3, 1−(2ρ−1)³) with ρ = actual/predicted reduction).
    lambda_schedule: str = "halve_double"


SOLVERS = ("auto", "schur", "schur_poses", "schur_direct",
           "schur_direct_points", "pcg")


def check_options(options: BAOptions) -> None:
    """Raise for options this port does not implement or does not know."""
    if options.solver not in SOLVERS:
        raise ValueError(f"unknown solver {options.solver!r}")
    if options.cg_jacobian_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"unknown cg_jacobian_dtype {options.cg_jacobian_dtype!r}")
    if options.lambda_schedule not in ("halve_double", "gain_ratio"):
        raise ValueError(f"unknown lambda_schedule {options.lambda_schedule!r}")


@dataclasses.dataclass
class OptimizationReport:
    """Per-run solver metrics: host wall clock of the first step and of the
    steady-state steps after it."""

    iterations: int = 0
    accepted: int = 0
    rejected: int = 0
    initial_cost: float = float("nan")
    final_cost: float = float("nan")
    pcg_iterations_total: int = 0
    first_call_seconds: float = 0.0
    step_seconds: float = 0.0
    total_seconds: float = 0.0

    def as_dict(self):
        return dataclasses.asdict(self)


# --------------------- pose/point legs (grid or flat) ---------------------
#
# A Jacobian block may be a bfloat16 copy (the CG matvecs'): each leg takes
# it to the dtype of the vector it meets (res.as_dtype_of).


def _grid_mp(seg, m=None, p=None):
    """The (M, P) grid shape if this segment is in grid layout and matches
    the given imageset/point counts (else None)."""
    gs = seg.grid_shape
    if gs is None:
        return None
    if m is not None and gs[0] != m:
        return None
    if p is not None and gs[1] != p:
        return None
    return gs


def _jv_imageset(seg, j, arr):
    """einsum('nik,nk->ni', j, arr[seg.imageset]) without the gather."""
    gs = _grid_mp(seg, m=arr.shape[0])
    if gs is not None:
        return schur_cuda.grid_jv_imageset(j, arr, gs)
    return torch.einsum("nik,nk->ni", res.as_dtype_of(j, arr),
                        arr[seg.imageset])


def _jv_point(seg, j, arr):
    """einsum('nik,nk->ni', j, arr[seg.point]) without the gather."""
    gs = _grid_mp(seg, p=arr.shape[0])
    if gs is not None:
        return schur_cuda.grid_jv_point(j, arr, gs)
    return torch.einsum("nik,nk->ni", res.as_dtype_of(j, arr),
                        arr[seg.point])


def _jtw_imageset(seg, j, ws, m):
    """segment_sum(einsum('nik,ni->nk', j, ws), seg.imageset, m)."""
    gs = _grid_mp(seg, m=m)
    if gs is not None:
        return schur_cuda.grid_jtw_imageset(j, ws, gs)
    return onehot_segment_sum(
        torch.einsum("nik,ni->nk", res.as_dtype_of(j, ws), ws), seg.imageset,
        m)


def _jtw_point(seg, j, ws, p):
    """segment_sum(einsum('nik,ni->nk', j, ws), seg.point, p)."""
    gs = _grid_mp(seg, p=p)
    if gs is not None:
        return schur_cuda.grid_jtw_point(j, ws, gs)
    return onehot_segment_sum(
        torch.einsum("nik,ni->nk", res.as_dtype_of(j, ws), ws), seg.point, p)


def _jtwj_diag_imageset(seg, j, w, m):
    """segment_sum(einsum('nij,nik,n->njk', j, j, w), seg.imageset, m)."""
    gs = _grid_mp(seg, m=m)
    if gs is not None:
        jg = j.reshape(gs + j.shape[1:])
        return torch.einsum("mpij,mpik,mp->mjk", jg, jg, w.reshape(gs))
    return onehot_segment_sum(
        torch.einsum("nij,nik,n->njk", j, j, w), seg.imageset, m)


def _jtwj_diag_point(seg, j, w, p):
    """segment_sum(einsum('nij,nik,n->njk', j, j, w), seg.point, p)."""
    gs = _grid_mp(seg, p=p)
    if gs is not None:
        jg = j.reshape(gs + j.shape[1:])
        return torch.einsum("mpij,mpik,mp->pjk", jg, jg, w.reshape(gs))
    return onehot_segment_sum(
        torch.einsum("nij,nik,n->njk", j, j, w), seg.point, p)


def _valid_grid_shape(seg, state):
    """The segment's (M, P) grid shape when consistent with the state and
    the table's row count (else None — flat gather path)."""
    gs = seg.grid_shape
    if gs is None:
        return None
    m, p = gs
    if (m != state.rig_q_global.shape[0] or p != state.points.shape[0]
            or m * p != seg.imageset.shape[0]):
        return None
    return gs


def _masked(tangent: BATangent, mask: BATangent) -> BATangent:
    return tangent.map(lambda t, m: t * m, mask)


def _reduce(data, *tensors):
    """The tensors summed over the ranks that hold shards of ``data`` (one
    all-reduce); as they are for plain tables.  Returns a list."""
    shard = sharding.shard_of(data)
    if shard is None:
        return list(tensors)
    return sharding.all_reduce_sum(shard, tensors)


def _reduce_tangent(data, t: BATangent) -> BATangent:
    if sharding.shard_of(data) is None:
        return t
    return t.unravel(_reduce(data, t.ravel())[0])


# ------------------------------ linear solver ------------------------------


def _flat_cg(matvec_flat, precond_flat, b_flat, options, x0=None):
    """Preconditioned CG on flat tangent vectors.  Returns (x, iterations).

    The loop test ``|r| > tol`` is read on the host, so each iteration syncs
    the host with the device once.
    """
    def matvec(v):
        with tracing.span("cg.matvec"):
            return matvec_flat(v)

    def precond(v):
        with tracing.span("cg.precond"):
            return precond_flat(v)

    if x0 is None:
        x = torch.zeros_like(b_flat)
        r = b_flat
    else:
        # Guarded warm start: after a large accepted step the previous
        # delta can be a worse iterate than zero; then start cold.
        r0 = b_flat - matvec(x0)
        if tracing.read("cg.warm_guard",
                        torch.dot(r0, r0) <= torch.dot(b_flat, b_flat)):
            x, r = x0, r0
        else:
            x, r = torch.zeros_like(b_flat), b_flat
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    tol = options.pcg_rel_tolerance * torch.sqrt(torch.dot(b_flat, b_flat))
    k = 0
    while (k < options.max_pcg_iterations
           and tracing.read("cg.stop", torch.sqrt(torch.dot(r, r)) > tol)):
        ap = matvec(p)
        alpha = rz / torch.clamp_min(torch.dot(p, ap), 1e-35)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.clamp_min(rz, 1e-35)
        p = z + beta * p
        rz = rz_new
        k += 1
    return x, k


def _chunks(seg, options):
    """Row slices of ``options.block_chunk`` observations when the chunk
    divides the table's rows (lm_pcg.py:375 of the reference package), else
    None."""
    chunk = options.block_chunk
    n_obs = seg.count
    if chunk and n_obs > chunk and n_obs % chunk == 0:
        return [slice(i, i + chunk) for i in range(0, n_obs, chunk)]
    return None


def _slice_table(seg, rows):
    """Rows of a table as a flat table (chunks break the (M, P) layout)."""
    return ObservationTable(
        imageset=seg.imageset[rows], camera=seg.camera[rows],
        point=seg.point[rows], pixel=seg.pixel[rows], valid=seg.valid[rows])


def _cat_blocks(parts):
    """Blocks of consecutive chunks as one: rows on the observation axis,
    ``j_win`` columns (rows ``[i, y, x, j]`` kept)."""
    def cat(name):
        return torch.cat([getattr(b, name) for b in parts])

    if isinstance(parts[0].intr, res.DenseIntr):
        intr = res.DenseIntr(
            j_params=torch.cat([b.intr.j_params for b in parts]))
    else:
        intr = res.GridIntr(
            j_win=torch.cat([b.intr.j_win for b in parts], dim=1),
            base_xy=torch.cat([b.intr.base_xy for b in parts]),
            k_tangent=parts[0].intr.k_tangent)
    return res.ObsBlocks(r=cat("r"), j_rig=cat("j_rig"), j_cam=cat("j_cam"),
                         j_point=cat("j_point"), intr=intr,
                         weight=cat("weight"), valid=cat("valid"),
                         cost=cat("cost"))


def compute_blocks(data, state: BAState, warm_xy, options: BAOptions):
    """Residual/Jacobian blocks for all cameras.

    data: tuple of per-camera ObservationTable; warm_xy: tuple of (n_c, 2).
    With ``options.block_chunk`` each table is evaluated in chunks
    (reference package ``lm_pcg.py:336-418``).  Returns (blocks list, new
    warm tuple).
    """
    blocks, new_warm = [], []
    for ci, seg in enumerate(data):
        model = state.intrinsics[ci]
        protocol.require_supported(model)
        frames = (manifolds.direction_tangents(model.grid)
                  if isinstance(model, CentralGenericModel) else None)

        def eval_blocks(tbl, warm, gs):
            return res.segment_blocks(
                model, state, tbl.imageset, tbl.camera, tbl.point, tbl.pixel,
                tbl.valid, warm,
                huber_px=options.huber_px,
                max_proj_iterations=options.proj_iterations,
                tangent_frames=frames,
                grid_shape=gs,
            )

        chunks = _chunks(seg, options)
        if chunks is None:
            b, w = eval_blocks(seg, warm_xy[ci], _valid_grid_shape(seg, state))
        else:
            parts = [eval_blocks(_slice_table(seg, rows), warm_xy[ci][rows],
                                 None) for rows in chunks]
            b = _cat_blocks([p[0] for p in parts])
            w = torch.cat([p[1] for p in parts])
        blocks.append(b)
        new_warm.append(w)
    return blocks, tuple(new_warm)


def _add_row(arr, i, val):
    out = arr.clone()
    out[i] += val
    return out


def _apply_j_subset(data, blocks, tangent: BATangent, *, rig=True, cam=True,
                    points=True, intr=True):
    """J·v restricted to a subset of the variable groups: one (n, 2) array
    per camera."""
    outs = []
    for ci, seg in enumerate(data):
        b = blocks[ci]
        s = torch.zeros_like(b.r)
        if rig:
            s = s + _jv_imageset(seg, b.j_rig, tangent.rig)
        if cam:
            s = s + torch.einsum("nik,k->ni",
                                 res.as_dtype_of(b.j_cam, tangent.cam),
                                 tangent.cam[ci])
        if points:
            s = s + _jv_point(seg, b.j_point, tangent.points)
        if intr:
            s = s + res.intr_apply_j(b.intr, tangent.intr[ci])
        outs.append(s)
    return outs


def _apply_jt_subset(data, blocks, s_list, state: BAState, *, rig=True,
                     cam=True, points=True, intr=True) -> BATangent:
    """JᵀW·s restricted to a subset of groups (others left zero)."""
    t = zero_tangent(state)
    rig_t, cam_t, pts_t = t.rig, t.cam, t.points
    intr_t = list(t.intr)
    for ci, seg in enumerate(data):
        b = blocks[ci]
        ws = s_list[ci] * b.weight[:, None]
        if rig:
            rig_t = rig_t + _jtw_imageset(seg, b.j_rig, ws, rig_t.shape[0])
        if cam:
            cam_t = _add_row(cam_t, ci, torch.einsum(
                "nik,ni->k", res.as_dtype_of(b.j_cam, ws), ws))
        if points:
            pts_t = pts_t + _jtw_point(seg, b.j_point, ws, pts_t.shape[0])
        if intr:
            intr_t[ci] = intr_t[ci] + res.intr_apply_jtw(b.intr, ws, intr_t[ci])
    return _reduce_tangent(
        data, BATangent(rig=rig_t, cam=cam_t, points=pts_t, intr=tuple(intr_t)))


def apply_j(data, blocks, tangent: BATangent):
    """J·v: list of per-observation 2-vectors, one entry per camera."""
    return _apply_j_subset(data, blocks, tangent)


def apply_jtw(data, blocks, s_list, state: BAState) -> BATangent:
    """JᵀW·s: scatter-add per-observation contributions into the tangent."""
    return _apply_jt_subset(data, blocks, s_list, state)


def jtwj_block_diag(data, blocks, state: BAState):
    """Variable-block diagonal of JᵀWJ: 6×6 rig/cam, 3×3 point, and per
    camera the per-knot K×K blocks of a grid model or the whole P×P block
    of a parametric one."""
    dtype, dev = state.points.dtype, state.points.device
    m = state.rig_q_global.shape[0]
    c = state.cam_q_rig.shape[0]
    p_n = state.points.shape[0]
    rig = torch.zeros((m, 6, 6), dtype=dtype, device=dev)
    cam = torch.zeros((c, 6, 6), dtype=dtype, device=dev)
    pts = torch.zeros((p_n, 3, 3), dtype=dtype, device=dev)
    intr = []
    for ci, seg in enumerate(data):
        b = blocks[ci]
        w = b.weight
        rig = rig + _jtwj_diag_imageset(seg, b.j_rig, w, m)
        cam = _add_row(cam, ci, torch.einsum("nij,nik,n->jk", b.j_cam, b.j_cam, w))
        pts = pts + _jtwj_diag_point(seg, b.j_point, w, p_n)
        bi = b.intr
        if isinstance(bi, res.DenseIntr):
            intr.append(torch.einsum("nij,nik,n->jk", bi.j_params,
                                     bi.j_params, w))
            continue
        model = state.intrinsics[ci]
        gh, gw = model.grid_height, model.grid_width
        intr.append(window_cuda.window_block_diag(
            bi.j_win, bi.base_xy, w, gh, gw, bi.k_tangent))
    rig, cam, pts, *intr = _reduce(data, rig, cam, pts, *intr)
    return rig, cam, pts, tuple(intr)


def _damped_inv(a, lam):
    k = a.shape[-1]
    return linalg.inv_spd_blocks(
        a + lam * torch.eye(k, dtype=a.dtype, device=a.device))


def make_block_preconditioner(block_diag, lam, state, shard=None):
    """Invert damped diagonal blocks; returns an apply(r)->z function.

    With a ``shard`` whose ``grid_blocks`` is set
    (``parallel.sharding.shard_grid_blocks``) each rank inverts and applies
    the per-knot blocks of its band of knot rows, and the bands are
    all-gathered."""
    rig_inv, cam_inv, pts_inv = (_damped_inv(x, lam) for x in block_diag[:3])
    banded = shard is not None and shard.grid_blocks

    def band(gh):
        return sharding.knot_band(gh, shard) if banded else None

    intr_inv = []
    for x in block_diag[3]:
        b = band(x.shape[0]) if x.dim() == 4 else None
        intr_inv.append(_damped_inv(x if b is None else x[b[0]:b[1]], lam))

    def apply_intr(inv, ri):
        if inv.dim() == 4:  # (gh, gw, K, K) per-knot blocks
            b = band(ri.shape[0])
            if b is None:
                return torch.einsum("hwjk,hwk->hwj", inv, ri)
            z = torch.einsum("hwjk,hwk->hwj", inv, ri[b[0]:b[1]])
            return sharding.all_gather_rows(shard, z, b[2])[:ri.shape[0]]
        return inv @ ri  # one (P, P) parametric block

    def apply(r: BATangent) -> BATangent:
        return BATangent(
            rig=torch.einsum("mjk,mk->mj", rig_inv, r.rig),
            cam=torch.einsum("cjk,ck->cj", cam_inv, r.cam),
            points=torch.einsum("pjk,pk->pj", pts_inv, r.points),
            intr=tuple(apply_intr(inv, ri)
                       for inv, ri in zip(intr_inv, r.intr)),
        )

    return apply


def _cg_cast_blocks(blocks, options):
    """The blocks the CG matvecs read: with ``cg_jacobian_dtype="bfloat16"``
    bfloat16 copies of the Jacobian blocks (made once per solve), the
    residuals, weights and validity as they are; else the blocks
    themselves."""
    if options.cg_jacobian_dtype != "bfloat16":
        return blocks

    def cast(x):
        return x.to(torch.bfloat16)

    out = []
    for b in blocks:
        bi = b.intr
        if isinstance(bi, res.GridIntr):
            bi = res.GridIntr(j_win=cast(bi.j_win), base_xy=bi.base_xy,
                              k_tangent=bi.k_tangent)
        else:
            bi = res.DenseIntr(j_params=cast(bi.j_params))
        out.append(dataclasses.replace(
            b, j_rig=cast(b.j_rig), j_cam=cast(b.j_cam),
            j_point=cast(b.j_point), intr=bi))
    return out


def _grid_rows(data, state):
    """(first imageset, imagesets) of the rows that every camera's table
    holds in grid layout over all points: every imageset for a plain table,
    the rank's band for a sharded one (``Shard.band_starts``).  None where a
    table is flat or the tables hold different rows: then the per-group
    legs run.  Every rank of a group gets the same answer."""
    shard = sharding.shard_of(data)
    m, p = state.rig_q_global.shape[0], state.points.shape[0]
    rows = set()
    for ci, seg in enumerate(data):
        gs = seg.grid_shape
        if shard is None:
            m0 = 0 if gs is not None and gs[0] == m else None
        else:
            starts = shard.band_starts
            m0 = starts[ci] if ci < len(starts) else None
        if (gs is None or m0 is None or gs[1] != p or m0 + gs[0] > m
                or gs[0] * gs[1] != seg.imageset.shape[0]):
            return None
        rows.add((m0, gs[0]))
    return rows.pop() if len(rows) == 1 else None


def _point_legs(data, blocks, rows, x: BATangent, s_intr):
    """Bᵀx = Σ over the cameras' grid tables of J_pointᵀ W (J_keep x), summed
    over the ranks: (P, 3).  ``rows`` = :func:`_grid_rows`; ``s_intr[c]``
    = J_intr·x_intr of camera c."""
    m0, mm = rows
    t = None
    for ci, seg in enumerate(data):
        if mm == 0:  # a rank with no imagesets adds nothing
            break
        b = blocks[ci]
        t = schur_cuda.point_leg(b.j_rig, b.j_cam, b.j_point, b.weight,
                                 s_intr[ci], x.rig[m0:m0 + mm], x.cam[ci],
                                 seg.grid_shape, t_in=t)
    if t is None:
        t = torch.zeros_like(x.points)
    return _reduce(data, t)[0]


def _pose_legs(data, blocks, rows, x, s_intr, t, d_inv, out_flat,
               out: BATangent):
    """J_keepᵀ W (J_keep x − J_point D⁻¹ t) over the cameras' grid tables,
    written into ``out``, the rig, camera and intrinsics views of the flat
    tangent ``out_flat``, and summed over the ranks; returns the flat
    vector.  Only the band's rig rows are written: the points, and on a
    shard the other rig rows, keep the zeros ``out_flat`` starts with.
    ``x`` None: J_keep x = 0."""
    m0, mm = rows
    rig_out = out.rig[m0:m0 + mm]
    for ci, seg in enumerate(data):
        if mm == 0:
            break
        b = blocks[ci]
        xs = (None, None, None) if x is None else (
            s_intr[ci], x.rig[m0:m0 + mm], x.cam[ci])
        ws = schur_cuda.pose_leg(b.j_rig, b.j_cam, b.j_point, b.weight, *xs,
                                 t, d_inv, seg.grid_shape, rig_out,
                                 out.cam[ci], accumulate=ci > 0)
        res.intr_apply_jtw(b.intr, ws, out.intr[ci], out=out.intr[ci])
    return _reduce(data, out_flat)[0]


def schur_pcg_solve(data, blocks, state, grad, block_diag, lam, mask, options,
                    eliminate: str = "points", x0=None):
    """Solve (JᵀWJ + λI) δ = −grad by block elimination + PCG.

    eliminate="points" eliminates the 3×3 point blocks (PCG on rig, cameras
    and intrinsics); eliminate="poses" eliminates the 6×6 imageset pose
    blocks (PCG on cameras, points and intrinsics).  The reduced matvec
    stays matrix-free and reads :func:`_cg_cast_blocks`; the right-hand side
    and the back-substitution read ``blocks``.  With the points eliminated
    and every table in grid layout (on a shard, its band of imagesets) the
    legs go through :func:`_point_legs` and :func:`_pose_legs` (kernels on
    the card); otherwise through the per-group J·v and JᵀW·s.  Returns (δ,
    CG iterations).
    """
    rig_b, cam_b, pts_b, intr_b = block_diag
    el_points = eliminate == "points"
    keep = dict(rig=el_points, cam=True, points=not el_points, intr=True)
    elim = dict(rig=not el_points, cam=False, points=el_points, intr=False)
    d_inv = _damped_inv(pts_b if el_points else rig_b, lam)

    def get_elim(t: BATangent):
        return t.points if el_points else t.rig

    def with_elim(t: BATangent, val):
        if el_points:
            return dataclasses.replace(t, points=val)
        return dataclasses.replace(t, rig=val)

    def zero_elim(t: BATangent) -> BATangent:
        return with_elim(t, torch.zeros_like(get_elim(t)))

    precond = make_block_preconditioner(
        (torch.zeros_like(rig_b) if not el_points else rig_b, cam_b,
         torch.zeros_like(pts_b) if el_points else pts_b, intr_b),
        lam, state, shard=sharding.shard_of(data),
    )
    mask_keep = zero_elim(mask)
    mask_keep_flat = mask_keep.ravel()

    def apply_elim_block(t_e):
        return torch.einsum("pjk,pk->pj", d_inv, t_e)

    blocks_mv = _cg_cast_blocks(blocks, options)
    g_e = get_elim(grad)
    rows = _grid_rows(data, state) if el_points else None
    if rows is not None:
        d_inv = d_inv.contiguous()
        g_e = g_e.contiguous()
        # the flat output of every pass B: its points (and on a shard the
        # rig rows of the other bands) stay 0, the rest is written whole by
        # each call
        out_flat = torch.zeros_like(mask_keep_flat)
        out = mask_keep.unravel(out_flat)

        def intr_j(blks, x):
            return [res.intr_apply_j(b.intr, x.intr[ci]).contiguous()
                    for ci, b in enumerate(blks)]

        def matvec_flat(vf):
            v = mask_keep.unravel(vf * mask_keep_flat)
            s_intr = intr_j(blocks_mv, v)
            t = _point_legs(data, blocks_mv, rows, v, s_intr)
            return (_pose_legs(data, blocks_mv, rows, v, s_intr, t, d_inv,
                               out_flat, out) + lam * vf) * mask_keep_flat

        # reduced RHS: b_keep = −g_keep + B D⁻¹ g_elim; pass B with x = 0
        # gives −B D⁻¹ g_elim
        corr = _pose_legs(data, blocks, rows, None, None, g_e, d_inv,
                          out_flat, out)
        b_flat = -(grad.ravel() + corr) * mask_keep_flat
    else:
        def matvec_flat(vf):
            v = mask_keep.unravel(vf * mask_keep_flat)
            u = _apply_j_subset(data, blocks_mv, v, **keep)
            t_e = get_elim(_apply_jt_subset(data, blocks_mv, u, state,
                                            **elim))
            u2 = _apply_j_subset(
                data, blocks_mv,
                with_elim(zero_tangent(state), apply_elim_block(t_e)), **elim)
            diff = [a - b_ for a, b_ in zip(u, u2)]
            out = _apply_jt_subset(data, blocks_mv, diff, state,
                                   **keep).ravel()
            return (out + lam * vf) * mask_keep_flat

        # reduced RHS: b_keep = −g_keep + B D⁻¹ g_elim
        u2 = _apply_j_subset(
            data, blocks,
            with_elim(zero_tangent(state), apply_elim_block(g_e)), **elim)
        corr = _apply_jt_subset(data, blocks, u2, state, **keep)
        b_flat = grad.map(lambda g, c: -g + c, corr).ravel() * mask_keep_flat

    def precond_flat(rf):
        return precond(mask_keep.unravel(rf * mask_keep_flat)).ravel() \
            * mask_keep_flat

    x0_flat = (zero_elim(x0).ravel() * mask_keep_flat
               if x0 is not None else None)
    x_flat, iters = _flat_cg(matvec_flat, precond_flat, b_flat, options,
                             x0=x0_flat)
    x = mask_keep.unravel(x_flat * mask_keep_flat)

    # back-substitution: δ_e = D⁻¹ (−g_e − Bᵀ δ_keep)
    if rows is not None:
        bt_x = _point_legs(data, blocks, rows, x, intr_j(blocks, x))
    else:
        u = _apply_j_subset(data, blocks, x, **keep)
        bt_x = get_elim(_apply_jt_subset(data, blocks, u, state, **elim))
    x = with_elim(x, apply_elim_block(-g_e - bt_x))
    return _masked(x, mask), iters


def _flat_offsets(state):
    """Offsets of each tangent group in the flat vector (the order of
    :meth:`BATangent.ravel`, reference package ``lm_pcg.py:761-783``).

    Returns ({key: (offset, size, shape)}, total) with key 'rig', 'cam',
    'points' or ('intr', camera index).
    """
    zt = zero_tangent(state)
    keys = ["rig", "cam", "points"] + [("intr", i) for i in range(len(zt.intr))]
    offsets, off = {}, 0
    for key, leaf in zip(keys, zt.leaves()):
        offsets[key] = (off, leaf.numel(), tuple(leaf.shape))
        off += leaf.numel()
    return offsets, off


def _grid_band(seg, state, shard):
    """(first imageset, M, P) of a grid-layout table: the whole grid of a
    plain table, or a shard's band of whole imagesets (rows m-major from
    its first imageset); None when the table is not in grid layout."""
    if shard is None:
        gs = _valid_grid_shape(seg, state)
        return None if gs is None else (0,) + tuple(gs)
    gs = seg.grid_shape
    if (gs is None or gs[1] != state.points.shape[0]
            or gs[0] * gs[1] != seg.count):
        return None
    m0 = int(seg.imageset[0]) if seg.count else 0
    return (m0,) + tuple(gs)


def _dense_intr_j(bi, gh, gw, k):
    """The per-observation dense intrinsics Jacobian (n, 2, gh·gw·k) of the
    4×4-window form (reference package ``lm_pcg.py:786-807``), by one index
    scatter; knots outside the grid add nothing."""
    n = bi.base_xy.shape[0]
    flat, inside = window_cuda._window_index(bi.base_xy, gh, gw)  # (n, 4, 4)
    cols = flat[..., None] * k + torch.arange(k, device=flat.device)
    vals = bi.j_win.reshape(2, 4, 4, k, n).permute(4, 0, 1, 2, 3)
    vals = torch.where(inside[:, None, :, :, None], vals, 0.0)
    out = vals.new_zeros((n, 2, gh * gw * k))
    # a clamped outside knot can share a column with an inside one; it adds
    # an exact 0 there
    out.scatter_add_(2, cols[:, None].expand(n, 2, 4, 4, k).reshape(n, 2, -1),
                     vals.reshape(n, 2, -1))
    return out


def schur_direct_solve(data, blocks, state, grad, block_diag, lam, mask,
                       options, eliminate: str = "poses"):
    """Solve (JᵀWJ + λI) δ = −grad by block elimination and a dense
    Cholesky solve of the explicitly assembled reduced system (reference
    package ``lm_pcg.py:810-966``): per-block D⁻¹, the cross blocks B, the
    Schur complement H_keep − B D⁻¹ Bᵀ, Cholesky, back-substitution.

    eliminate="poses" reduces onto [cam, points, intrinsics];
    eliminate="points" onto [poses, cam, intrinsics].  Needs grid-layout
    tables (on a shard, a band of imagesets); memory grows with the square
    of the reduced dimension.  A reduced system that is not positive
    definite gives a NaN step (which the LM step rejects), as the
    reference's Cholesky does.  Returns (δ, 0).
    """
    rig_b, cam_b, pts_b, _ = block_diag
    dtype, dev = state.points.dtype, state.points.device
    offs, f_dim = _flat_offsets(state)
    m_n = state.rig_q_global.shape[0]
    p_n = state.points.shape[0]
    rig_off = offs["rig"][0]
    cam_off = offs["cam"][0]
    pt_off = offs["points"][0]
    poses = eliminate == "poses"
    if poses:
        elim_b, k_el, n_el, elim_off = rig_b, 6, m_n, rig_off
    else:
        elim_b, k_el, n_el, elim_off = pts_b, 3, p_n, pt_off
    d_inv = _damped_inv(elim_b, lam)

    h = torch.zeros((f_dim, f_dim), dtype=dtype, device=dev)
    c_mat = torch.zeros((n_el, f_dim, k_el), dtype=dtype, device=dev)
    # On shards the observation sums of h and c_mat are all-reduced below;
    # the (already summed) diagonal blocks enter on rank 0 only.
    shard = sharding.shard_of(data)

    def add_sym(r0, rn, c0, cn, blk):
        """Add a cross block and its transpose."""
        h[r0:r0 + rn, c0:c0 + cn] += blk
        h[c0:c0 + cn, r0:r0 + rn] += blk.T

    def add_block_diag(off, blk):
        """Blocks (B, k, k) on the diagonal from ``off``."""
        nb, kk = blk.shape[0], blk.shape[-1]
        idx = off + kk * torch.arange(nb, device=dev)[:, None] \
            + torch.arange(kk, device=dev)
        h[idx[:, :, None], idx[:, None, :]] += blk

    # Within-group diagonal blocks of the kept variables.
    if shard is None or shard.rank == 0:
        if poses:
            add_block_diag(pt_off, pts_b)
        else:
            add_block_diag(rig_off, rig_b)
        add_block_diag(cam_off, cam_b)

    for ci, seg in enumerate(data):
        band = _grid_band(seg, state, shard)
        if band is None:
            raise ValueError(
                "schur_direct requires grid-layout observation tables "
                "(options.table_layout='auto' on calibration-shaped "
                "problems); use the PCG solver modes otherwise")
        m0, mm, pp = band
        b = blocks[ci]
        w = b.weight.reshape(mm, pp, 1, 1)
        jr = b.j_rig.reshape(mm, pp, 2, 6)
        jc = b.j_cam.reshape(mm, pp, 2, 6)
        jp = b.j_point.reshape(mm, pp, 2, 3)
        i_off, i_size, i_shape = offs[("intr", ci)]
        if isinstance(b.intr, res.DenseIntr):
            jd = b.intr.j_params.reshape(mm, pp, 2, i_size)
        else:
            jd = _dense_intr_j(b.intr, *i_shape).reshape(mm, pp, 2, i_size)
        jdw, jcw = jd * w, jc * w
        co = cam_off + 6 * ci

        # Kept-variable blocks (intrinsics dense; cross-group off-diagonals).
        h[i_off:i_off + i_size, i_off:i_off + i_size] += \
            jdw.reshape(-1, i_size).T @ jd.reshape(-1, i_size)
        add_sym(co, 6, i_off, i_size,
                jcw.reshape(-1, 6).T @ jd.reshape(-1, i_size))
        if poses:
            h_pi = torch.einsum("mpia,mpig->pag", jp, jdw)
            add_sym(pt_off, 3 * p_n, i_off, i_size, h_pi.reshape(3 * pp, i_size))
            h_cp = torch.einsum("mpia,mpib->pab", jcw, jp)
            add_sym(co, 6, pt_off, 3 * p_n,
                    h_cp.permute(1, 0, 2).reshape(6, 3 * pp))
            # Elimination cross blocks B = H_keep,pose(m).
            jrw = jr * w
            c_band = c_mat[m0:m0 + mm]
            c_band[:, pt_off:pt_off + 3 * p_n, :] += torch.einsum(
                "mpia,mpib->mpab", jp, jrw).reshape(mm, 3 * pp, 6)
            c_band[:, co:co + 6, :] += torch.einsum("mpia,mpib->mab", jc, jrw)
            c_band[:, i_off:i_off + i_size, :] += torch.einsum(
                "mpig,mpib->mgb", jd, jrw)
        else:
            jrw = jr * w
            r0 = rig_off + 6 * m0
            h_ri = torch.einsum("mpia,mpig->mag", jrw, jd)
            add_sym(r0, 6 * mm, i_off, i_size, h_ri.reshape(6 * mm, i_size))
            h_rc = torch.einsum("mpia,mpib->mab", jrw, jc)
            add_sym(r0, 6 * mm, co, 6, h_rc.reshape(6 * mm, 6))
            # Elimination cross blocks B = H_keep,point(p).
            jpw = jp * w
            c_mat[:, r0:r0 + 6 * mm, :] += torch.einsum(
                "mpia,mpib->pmab", jr, jpw).reshape(pp, 6 * mm, 3)
            c_mat[:, co:co + 6, :] += torch.einsum("mpia,mpib->pab", jc, jpw)
            c_mat[:, i_off:i_off + i_size, :] += torch.einsum(
                "mpig,mpib->pgb", jd, jpw)

    h, c_mat = _reduce(data, h, c_mat)

    # Schur complement S = H_keep − B D⁻¹ Bᵀ.
    cd = torch.einsum("eFa,eab->eFb", c_mat, d_inv)
    h -= cd.permute(1, 0, 2).reshape(f_dim, -1) \
        @ c_mat.permute(1, 0, 2).reshape(f_dim, -1).T

    mask_flat = mask.ravel()
    keep = mask_flat.clone()
    keep[elim_off:elim_off + k_el * n_el] = 0.0
    g_e = grad.rig if poses else grad.points

    # Reduced RHS: −g_keep + B D⁻¹ g_elim.
    y_e = torch.einsum("eab,eb->ea", d_inv, g_e)
    b_vec = (-grad.ravel() + torch.einsum("eFa,ea->F", c_mat, y_e)) * keep

    # λ damping; dead rows (eliminated group, gauge/freeze mask) pinned to
    # the identity so the factorization stays positive definite.
    h = h * keep[:, None] * keep[None, :]
    h.diagonal().add_(lam * keep + (1.0 - keep))
    chol, info = torch.linalg.cholesky_ex(h)
    x_flat = torch.cholesky_solve(b_vec[:, None], chol)[:, 0]
    # a failed factorization gives NaN, with no host sync
    x_flat = torch.where(info == 0, x_flat, float("nan")) * keep

    # Back-substitution: δ_e = D⁻¹ (−g_e − Bᵀ δ_keep).
    bt_x = torch.einsum("eFa,F->ea", c_mat, x_flat)
    delta_e = torch.einsum("eab,eb->ea", d_inv, -g_e - bt_x)
    x = mask.unravel(x_flat)
    x = dataclasses.replace(x, **{"rig" if poses else "points": delta_e})
    return _masked(x, mask), 0


def pcg_solve(data, blocks, state, grad, block_diag, lam, mask, options,
              x0=None):
    """Solve (JᵀWJ + λI) δ = −grad by block-Jacobi PCG on the full system
    (reference package ``lm_pcg.py:969-992``); the matvecs read
    :func:`_cg_cast_blocks`.  Returns (δ, CG iterations).
    """
    mask_flat = mask.ravel()
    precond = make_block_preconditioner(block_diag, lam, state,
                                        shard=sharding.shard_of(data))
    blocks_mv = _cg_cast_blocks(blocks, options)

    def matvec_flat(vf):
        v = mask.unravel(vf * mask_flat)
        hv = apply_jtw(data, blocks_mv, apply_j(data, blocks_mv, v),
                       state).ravel()
        return (hv + lam * vf) * mask_flat

    def precond_flat(rf):
        return precond(mask.unravel(rf * mask_flat)).ravel() * mask_flat

    b_flat = -grad.ravel() * mask_flat
    x0_flat = x0.ravel() * mask_flat if x0 is not None else None
    x_flat, iters = _flat_cg(matvec_flat, precond_flat, b_flat, options,
                             x0=x0_flat)
    return mask.unravel(x_flat * mask_flat), iters


def total_cost(data, state, warm_xy, options):
    """Robust per-obs costs, validity and warm pixels for every camera (in
    chunks with ``options.block_chunk``, reference package
    ``lm_pcg.py:995-1035``)."""
    costs, valids, warms = [], [], []
    for ci, seg in enumerate(data):
        def eval_cost(tbl, warm, gs):
            return res.segment_cost(
                state.intrinsics[ci], state, tbl.imageset, tbl.camera,
                tbl.point, tbl.pixel, tbl.valid, warm,
                huber_px=options.huber_px,
                max_proj_iterations=options.proj_iterations,
                grid_shape=gs,
            )

        chunks = _chunks(seg, options)
        if chunks is None:
            cost, valid, w = eval_cost(seg, warm_xy[ci],
                                       _valid_grid_shape(seg, state))
        else:
            parts = [eval_cost(_slice_table(seg, rows), warm_xy[ci][rows], None)
                     for rows in chunks]
            cost, valid, w = (torch.cat(x) for x in zip(*parts))
        costs.append(cost)
        valids.append(valid)
        warms.append(w)
    return costs, valids, tuple(warms)


# --------------------------------- LM step ---------------------------------


def _solve_step(data, blocks, state, lam, options, x0=None):
    """Gradient, block diagonal, λ initialisation and the Schur-PCG solve.

    Returns (delta, pcg_iters, lam, grad)."""
    check_options(options)
    with tracing.span("lm.solve"):
        with tracing.span("solve.rhs"):
            mask = fix_gauge_mask(state, options.freeze)
            grad = _masked(apply_jtw(data, blocks, [b.r for b in blocks],
                                     state), mask)
            block_diag = jtwj_block_diag(data, blocks, state)

            # λ init from the mean scalar diagonal of the blocks
            rig_b, cam_b, pts_b, intr_b = block_diag
            diag_sum = sum(torch.diagonal(x, dim1=-2, dim2=-1).sum()
                           for x in (rig_b, cam_b, pts_b) + tuple(intr_b))
            n_params = sum(x.numel() for x in zero_tangent(state).leaves())
            lam = torch.where(
                lam < 0, options.lambda_initial_factor * diag_sum / n_params,
                lam)

        # Block elimination needs the eliminated group free; with it frozen
        # the full-system solve runs (reference package lm_pcg.py:1079-1104).
        args = (data, blocks, state, grad, block_diag, lam, mask, options)
        frozen = set(options.freeze)
        with tracing.span("solve.pcg"):
            if options.solver == "schur" and "points" not in frozen:
                delta, pcg_iters = schur_pcg_solve(*args, eliminate="points",
                                                   x0=x0)
            elif options.solver == "schur_poses" and "poses" not in frozen:
                delta, pcg_iters = schur_pcg_solve(*args, eliminate="poses",
                                                   x0=x0)
            elif options.solver == "schur_direct" and "poses" not in frozen:
                delta, pcg_iters = schur_direct_solve(*args, eliminate="poses")
            elif (options.solver == "schur_direct_points"
                  and "points" not in frozen):
                delta, pcg_iters = schur_direct_solve(*args,
                                                      eliminate="points")
            else:
                delta, pcg_iters = pcg_solve(*args, x0=x0)
    return delta, pcg_iters, lam, grad


def _paired_sums(old_costs, old_valids, new_costs, new_valids, dtype, device,
                 data):
    """Costs on the observations valid in both states, and full costs
    (summed over the ranks when ``data`` is sharded)."""
    zero = torch.zeros((), dtype=dtype, device=device)
    old_sum, new_sum, full, new_full = zero, zero, zero, zero
    for oc, ov, nc, nv in zip(old_costs, old_valids, new_costs, new_valids):
        joint = ov & nv
        old_sum = old_sum + torch.sum(torch.where(joint, oc, 0.0))
        new_sum = new_sum + torch.sum(torch.where(joint, nc, 0.0))
        full = full + torch.sum(oc)
        new_full = new_full + torch.sum(nc)
    return tuple(_reduce(data, old_sum, new_sum, full, new_full))


def lm_step(state, warm_xy, lam, data, options: BAOptions, blocks=None,
            prev_delta=None):
    """One LM iteration.

    Without ``blocks`` this is the two-pass step: a blocks pass at ``state``
    and a cost-only pass at the test state.  Returns (state, warm, lam,
    accept, cost, new_cost, pcg_iters, paired_old, paired_new).

    With ``blocks`` (the cache evaluated at ``state``) the test state gets a
    full blocks pass, which is both the accept test and the next
    iteration's cache; the carried blocks and the step tangent (for CG warm
    starts) are appended to the outputs.

    ``accept`` is read on the host (one sync per step); ``lam`` and the
    costs stay 0-d tensors.  ``solver="auto"`` must be resolved first
    (:func:`resolve_solver`; :func:`optimize` does it).
    """
    if options.solver == "auto":
        raise ValueError(
            "solver='auto' must be resolved before the step: call "
            "optimize(), or resolve_solver(options, state) first")
    if blocks is None:
        return _lm_step_two_pass(state, warm_xy, lam, data, options)
    x0 = prev_delta if options.cg_warm_start else None
    delta, pcg_iters, lam, grad = _solve_step(data, blocks, state, lam,
                                              options, x0=x0)
    test_state = apply_freeze(state, retract(state, delta), options.freeze)
    with tracing.span("lm.cost"):
        test_blocks, warm2 = compute_blocks(data, test_state, warm_xy, options)
    with tracing.span("lm.accept"):
        old_sum, new_sum, full_cost, new_full_cost = _paired_sums(
            [b.cost for b in blocks], [b.valid for b in blocks],
            [b.cost for b in test_blocks], [b.valid for b in test_blocks],
            state.points.dtype, state.points.device, data)
        accept = tracing.read("lm.accept", new_sum < old_sum)
        if accept:
            state, blocks, warm = test_state, test_blocks, warm2
        else:
            warm = warm_xy
        if options.lambda_schedule == "gain_ratio":
            # ρ = actual/predicted reduction, L(0) − L(δ) = ½ δᵀ(λδ − g)
            pred = 0.5 * delta.dot(delta.map(lambda d, g: lam * d - g, grad))
            rho = (old_sum - new_sum) / torch.clamp_min(pred, 1e-30)
            fac = torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
            lam = lam * fac if accept else 2.0 * lam
        else:
            lam = 0.5 * lam if accept else 2.0 * lam
        lam = torch.clamp_min(lam, options.lambda_min)
    if not accept:
        # the retry after a rejected step solves from scratch
        delta = delta.map(torch.zeros_like)
    return (state, warm, lam, accept, full_cost, new_full_cost, pcg_iters,
            old_sum, new_sum, blocks, delta)


def _lm_step_two_pass(state, warm_xy, lam, data, options: BAOptions):
    """One LM iteration, classic two-pass form (blocks + cost-only)."""
    with tracing.span("lm.blocks"):
        blocks, warm1 = compute_blocks(data, state, warm_xy, options)
    delta, pcg_iters, lam, _ = _solve_step(data, blocks, state, lam, options)
    test_state = apply_freeze(state, retract(state, delta), options.freeze)
    with tracing.span("lm.cost"):
        test_costs, test_valids, warm2 = total_cost(data, test_state, warm1,
                                                    options)
    with tracing.span("lm.accept"):
        old_sum, new_sum, full_cost, new_full_cost = _paired_sums(
            [b.cost for b in blocks], [b.valid for b in blocks],
            test_costs, test_valids, state.points.dtype, state.points.device,
            data)
        accept = tracing.read("lm.accept", new_sum < old_sum)
        if accept:
            state, warm = test_state, warm2
        else:
            warm = warm1
        lam = torch.clamp_min(0.5 * lam if accept else 2.0 * lam,
                              options.lambda_min)
    return (state, warm, lam, accept, full_cost, new_full_cost, pcg_iters,
            old_sum, new_sum)


def make_lm_step(options: BAOptions):
    """The two-pass LM step as a callable (state, warm, lam, data)."""
    check_options(options)
    return lambda state, warm, lam, data: lm_step(state, warm, lam, data,
                                                  options)


def make_lm_scan(options: BAOptions, n_steps: int):
    """``n_steps`` cached-blocks LM iterations per call, from a host loop.

    One blocks pass at the start state, then each step's test-state blocks
    pass is carried into the next.  Returns a callable (state, warm, lam,
    data) -> (state, warm, lam, outs) with outs = per-iteration lists
    (accept, cost, new_cost, pcg_iters, paired_old, paired_new).
    """
    check_options(options)

    def scanned(state, warm, lam, data):
        with tracing.span("lm.blocks"):
            blocks, warm = compute_blocks(data, state, warm, options)
        delta = zero_tangent(state)
        outs = tuple([] for _ in range(6))
        for _ in range(int(n_steps)):
            with tracing.span("lm.iter"):
                (state, warm, lam, accept, cost, new_cost, iters, p_old,
                 p_new, blocks, delta) = lm_step(state, warm, lam, data,
                                                 options, blocks,
                                                 prev_delta=delta)
                cost, new_cost, p_old, p_new = (
                    tracing.read("lm.history", x)
                    for x in (cost, new_cost, p_old, p_new))
            for lst, v in zip(outs, (accept, cost, new_cost, iters, p_old,
                                     p_new)):
                lst.append(v)
        return state, warm, lam, outs

    return scanned


def maybe_grid_layout(data, state: BAState, options: BAOptions):
    """Re-lay per-camera tables into (M, P) grid layout when the fill ratio
    justifies it (``options.table_layout='auto'``).  Sharded tables are
    kept as they are: their caller lays them out before sharding."""
    if sharding.shard_of(data) is not None:
        return data
    if options.table_layout == "flat":
        return tuple(data)
    m = state.rig_q_global.shape[0]
    p = state.points.shape[0]
    # The direct Schur solvers assemble the reduced system from the grid
    # table, so they take the grid layout whatever the fill ratio.
    force = options.solver in ("schur_direct", "schur_direct_points")
    out = []
    for seg in data:
        if seg.grid_shape is not None:
            out.append(seg)
            continue
        n_valid = int(seg.valid.sum())
        if force or m * p <= options.grid_layout_max_expand * max(n_valid, 1):
            out.append(to_grid_layout(seg, m, p))
        else:
            out.append(seg)
    return tuple(out)


def resolve_solver(options: BAOptions, state: BAState,
                   direct_max_reduced_dim: int = 2048) -> BAOptions:
    """Resolve ``solver="auto"`` from the problem size (reference package
    ``lm_pcg.py:1341-1366``): ``schur_direct`` while the reduced system
    (3 per point, 6 per camera, the intrinsics) has at most
    ``direct_max_reduced_dim`` unknowns, ``schur`` beyond."""
    if options.solver != "auto":
        return options
    n_intr = sum(protocol.intrinsics_tangent_zero(m).numel()
                 for m in state.intrinsics)
    reduced = state.points.shape[0] * 3 + state.cam_q_rig.shape[0] * 6 + n_intr
    mode = "schur_direct" if reduced <= direct_max_reduced_dim else "schur"
    return dataclasses.replace(options, solver=mode)


def _profiled(profile_dir, device):
    """A context that records the LM loop with torch.profiler (the card's
    activity too when the state is on the card), the program's spans as its
    user annotations (``tracing.annotated``), and writes the trace to
    ``profile_dir/lm_trace.json``; a no-op without ``profile_dir``."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)

    @contextlib.contextmanager
    def run():
        with profile(activities=activities) as prof, tracing.annotated():
            yield
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "lm_trace.json"))

    return run()


def optimize(
    state,
    obs,
    segments,
    options: BAOptions = BAOptions(),
    *,
    callback=None,
    data=None,
    device=None,
):
    """Run LM to convergence from a host loop.  Returns (state, info dict).

    obs+segments: a camera-sorted ObservationTable and its per-camera
    (start, count) slices, or pass ``data`` (a tuple of per-camera tables)
    directly.  A state or tables given as numpy arrays (dicts or objects
    with the fields) are converted onto ``device`` (default: the card).
    """
    from camera_calibration_torch import convert

    check_options(options)
    if not isinstance(state, BAState):
        state = convert.ba_state(state, device=device)
    dev = state.points.device
    if data is None:
        if not isinstance(obs, ObservationTable):
            obs = convert.observation_table(obs, device=dev)
        data = split_by_camera(obs, segments)
    if sharding.shard_of(data) is None:
        data = tuple(seg if isinstance(seg, ObservationTable)
                     else convert.observation_table(seg, device=dev)
                     for seg in data)
    was_auto = options.solver == "auto"
    options = resolve_solver(options, state)
    data = maybe_grid_layout(data, state, options)
    if (was_auto and options.solver.startswith("schur_direct")
            and not all(seg.grid_shape is not None for seg in data)):
        # auto picked the direct solver but the tables are not in grid
        # layout (table_layout="flat"): the iterative mode instead
        options = dataclasses.replace(options, solver="schur")
    if options.debug_verify:
        verify_cost(state, data, options)
    k = max(1, int(options.lm_steps_per_call))
    if options.cg_warm_start and (
            k == 1 or options.solver.startswith("schur_direct")):
        warnings.warn(
            "cg_warm_start=True has no effect: it needs the cached-blocks "
            "path (lm_steps_per_call > 1) and an iterative solver "
            f"(got lm_steps_per_call={k}, solver={options.solver!r}).",
            stacklevel=2)
    step = make_lm_scan(options, k) if k > 1 else make_lm_step(options)
    warm = tuple(seg.pixel for seg in data)
    lam = torch.tensor(-1.0, dtype=state.points.dtype, device=dev)
    history = []
    rejects = 0
    final_cost = None
    it = 0
    stop = False
    report = OptimizationReport()
    t_run0 = time.perf_counter()
    # one lm.iter span a two-pass step; a scan call is lm.scan, its steps
    # lm.iter
    iter_span = "lm.scan" if k > 1 else "lm.iter"
    with _profiled(options.profile_dir, dev), \
            tracing.span("ba.solve", solve=True):
        while it < options.max_lm_iterations and not stop:
            t0 = time.perf_counter()
            with tracing.span(iter_span):
                if k > 1:
                    state, warm, lam, outs = step(state, warm, lam, data)
                    entries = list(zip(*outs))
                else:
                    (state, warm, lam, accept, cost, new_cost, pcg_iters,
                     p_old, p_new) = step(state, warm, lam, data)
                    cost, new_cost, p_old, p_new = (
                        tracing.read("lm.history", x)
                        for x in (cost, new_cost, p_old, p_new))
                    entries = [(accept, cost, new_cost, pcg_iters, p_old,
                                p_new)]
                lam_read = tracing.read("lm.history", lam)
            dt = time.perf_counter() - t0  # the history reads synced
            if report.iterations == 0:
                report.first_call_seconds = dt
            else:
                report.step_seconds += dt
            for accept, cost, new_cost, pcg_iters, p_old, p_new in entries:
                if it >= options.max_lm_iterations:
                    break
                history.append({
                    "iteration": it,
                    "cost": cost,
                    "new_cost": new_cost,
                    "paired_cost": p_old,
                    "paired_new_cost": p_new,
                    "accepted": accept,
                    "lambda": lam_read,
                    "pcg_iterations": pcg_iters,
                })
                if callback is not None:
                    callback(history[-1], state)
                it += 1
                report.iterations = it
                report.pcg_iterations_total += pcg_iters
                if report.iterations == 1:
                    report.initial_cost = cost
                if accept:
                    report.accepted += 1
                    rejects = 0
                    # Convergence is judged on the paired costs, the quantity
                    # the accept decision compares: the full cost can rise on
                    # an accepted step when the valid set shifts.
                    rel = (p_old - p_new) / max(p_old, 1e-30)
                    final_cost = new_cost
                    if rel < options.cost_reduction_threshold:
                        stop = True
                        break
                else:
                    report.rejected += 1
                    rejects += 1
                    final_cost = cost
                    if rejects >= options.max_consecutive_rejects:
                        stop = True
                        break
    report.final_cost = (
        float(final_cost) if final_cost is not None else float("nan"))
    report.total_seconds = time.perf_counter() - t_run0
    return state, {"history": history, "final_cost": final_cost,
                   "report": report}


def verify_cost(state, data, options: BAOptions, seed: int = 0):
    """Numeric self-checks of the cost and gradient (reference package
    ``lm_pcg.py:1561-1652``).

    1. Determinism: the cost evaluated twice agrees bitwise (the cost path
       has no atomic reduction).
    2. Consistency: the cost of the Jacobian-block pass matches the
       cost-only pass.
    3. The analytic gradient against central differences along a random
       tangent direction (numpy ``seed``), of 0.5·Σ w r² with the blocks'
       weights frozen.

    Returns the measured discrepancies; raises AssertionError on gross
    failures.
    """
    warm = tuple(seg.pixel for seg in data)

    def cost(s):
        return _reduce(data, sum(torch.sum(c) for c in
                                 total_cost(data, s, warm, options)[0]))[0]

    c1 = float(cost(state))
    c2 = float(cost(state))
    assert c1 == c2, f"nondeterministic cost: {c1} vs {c2}"

    blocks, _ = compute_blocks(data, state, warm, options)
    c_blocks = float(_reduce(data, sum(torch.sum(b.cost) for b in blocks))[0])
    rel_cost = abs(c_blocks - c1) / max(abs(c1), 1e-30)
    assert rel_cost < 1e-4, (
        f"block-pass cost {c_blocks} vs cost-pass {c1} (rel {rel_cost})")

    # d/dt [0.5 Σ w·r(t)²] at t=0 is Σ w·r·(J v) = <grad, v> with the IRLS
    # weights frozen
    rng = np.random.default_rng(seed)
    v = zero_tangent(state).map(lambda x: torch.as_tensor(
        rng.normal(0, 1, tuple(x.shape)), dtype=x.dtype, device=x.device))
    mask = fix_gauge_mask(state, options.freeze)
    v = _masked(v, mask)
    v = v.map(lambda x, n=torch.sqrt(v.dot(v)): x / n)
    grad = _masked(apply_jtw(data, blocks, [b.r for b in blocks], state), mask)
    analytic = float(grad.dot(v))

    def weighted_cost(s):
        total = 0
        for ci, seg in enumerate(data):
            x_cam, _ = transform_to_camera(s, seg.imageset, seg.camera,
                                           s.points[seg.point])
            px, _, _ = protocol.project_points(
                s.intrinsics[ci], x_cam, init_xy=warm[ci],
                max_iterations=options.proj_iterations)
            r = px - seg.pixel
            total = total + 0.5 * torch.sum(
                blocks[ci].weight * torch.sum(r * r, dim=-1))
        return _reduce(data, total)[0]

    eps = 1e-5 if state.points.dtype == torch.float64 else 3e-3
    c_plus = float(weighted_cost(retract(state, v.map(lambda x: eps * x))))
    c_minus = float(weighted_cost(retract(state, v.map(lambda x: -eps * x))))
    fd = (c_plus - c_minus) / (2 * eps)
    denom = max(abs(analytic), abs(fd), 1e-12)
    rel_grad = abs(fd - analytic) / denom
    assert rel_grad < 5e-2, (
        f"gradient check failed: analytic {analytic} vs FD {fd} "
        f"(rel {rel_grad})")
    return {
        "cost": c1,
        "cost_block_pass_rel_diff": rel_cost,
        "grad_analytic": analytic,
        "grad_fd": fd,
        "grad_rel_diff": rel_grad,
    }

"""Joint bundle adjustment: Levenberg-Marquardt with Schur-complement PCG.

- Per-observation residual + Jacobian blocks are computed once per LM
  iteration (closed form, batched) and kept on the device.
- The normal equations (JᵀWJ + λI) δ = −g are solved matrix-free: one
  variable group (points or imageset poses) is eliminated by its block
  diagonal, and block-Jacobi preconditioned CG runs on the reduced system.
- The intrinsics legs of every matvec and the block-Jacobi blocks of the
  intrinsics go through the window kernels (``ba/window_cuda.py``); the
  projections go through the projection kernels
  (``models/central_generic_cuda.py``).
- An LM step is judged on the observations valid in both states (paired
  cost comparison); λ is halved on accept and doubled on reject.
- Projections warm-start from the previous converged pixels.

This slice ports ``solver="schur"`` and ``"schur_poses"`` for CentralGeneric
cameras, in both step forms: the two-pass step (blocks pass + cost-only
pass, :func:`lm_step` without ``blocks``) and the cached-blocks step (the
test-state blocks pass doubles as the accept test and the next iteration's
cache, :func:`make_lm_scan`).  Everything else raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import torch

from camera_calibration_torch.ba import residuals as res
from camera_calibration_torch.ba import window_cuda
from camera_calibration_torch.ba.dataset import (
    ObservationTable, split_by_camera, to_grid_layout,
)
from camera_calibration_torch.ba.state import (
    BAState, BATangent, apply_freeze, fix_gauge_mask, retract, zero_tangent,
)
from camera_calibration_torch.models import protocol
from camera_calibration_torch.ops import linalg, manifolds
from camera_calibration_torch.ops.segsum import onehot_segment_sum


@dataclasses.dataclass(frozen=True)
class BAOptions:
    max_lm_iterations: int = 30
    max_pcg_iterations: int = 50
    # "schur": eliminate the 3×3 point blocks, PCG on the reduced
    # rig+camera+intrinsics system; "schur_poses": eliminate the 6×6
    # imageset pose blocks, PCG on cameras+points+intrinsics.
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
    debug_verify: bool = False
    # "auto" re-lays each per-camera table into dense (imagesets × points)
    # grid layout when M·P ≤ grid_layout_max_expand × valid observations;
    # "flat" keeps the given tables.
    table_layout: str = "auto"
    grid_layout_max_expand: float = 1.6
    block_chunk: int | None = None
    profile_dir: str | None = None
    # Warm-start each PCG solve from the previous cached-blocks step.
    cg_warm_start: bool = False
    cg_jacobian_dtype: str = "float32"
    # "halve_double" (accept → λ/2, reject → λ×2) or "gain_ratio"
    # (accept → λ·max(1/3, 1−(2ρ−1)³) with ρ = actual/predicted reduction).
    lambda_schedule: str = "halve_double"


def check_options(options: BAOptions) -> None:
    """Raise for options this slice of the port does not implement."""
    if options.solver not in ("schur", "schur_poses"):
        raise NotImplementedError(
            f"solver={options.solver!r} is not ported yet: only 'schur' and "
            "'schur_poses' are (ROADMAP.md queue 1, item 8: the other "
            "solver modes, 'auto' included)")
    if options.cg_jacobian_dtype != "float32":
        raise NotImplementedError(
            "cg_jacobian_dtype='bfloat16' is not ported yet (ROADMAP.md "
            "queue 1, item 9)")
    if options.block_chunk is not None:
        raise NotImplementedError(
            "block_chunk is not ported yet (ROADMAP.md queue 1, item 10)")
    if options.debug_verify:
        raise NotImplementedError(
            "debug_verify (verify_cost) is not ported yet (ROADMAP.md "
            "queue 1, item 8)")
    if options.profile_dir is not None:
        raise NotImplementedError(
            "profile_dir is not ported yet (ROADMAP.md queue 1, item 8)")
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


# --------------------- pose/point legs (grid or flat) ---------------------


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
        jg = j.reshape(gs + j.shape[1:])
        return torch.einsum("mpik,mk->mpi", jg, arr).reshape(j.shape[:2])
    return torch.einsum("nik,nk->ni", j, arr[seg.imageset])


def _jv_point(seg, j, arr):
    """einsum('nik,nk->ni', j, arr[seg.point]) without the gather."""
    gs = _grid_mp(seg, p=arr.shape[0])
    if gs is not None:
        jg = j.reshape(gs + j.shape[1:])
        return torch.einsum("mpik,pk->mpi", jg, arr).reshape(j.shape[:2])
    return torch.einsum("nik,nk->ni", j, arr[seg.point])


def _jtw_imageset(seg, j, ws, m):
    """segment_sum(einsum('nik,ni->nk', j, ws), seg.imageset, m)."""
    gs = _grid_mp(seg, m=m)
    if gs is not None:
        jg = j.reshape(gs + j.shape[1:])
        return torch.einsum("mpik,mpi->mk", jg, ws.reshape(gs + (2,)))
    return onehot_segment_sum(torch.einsum("nik,ni->nk", j, ws), seg.imageset, m)


def _jtw_point(seg, j, ws, p):
    """segment_sum(einsum('nik,ni->nk', j, ws), seg.point, p)."""
    gs = _grid_mp(seg, p=p)
    if gs is not None:
        jg = j.reshape(gs + j.shape[1:])
        return torch.einsum("mpik,mpi->pk", jg, ws.reshape(gs + (2,)))
    return onehot_segment_sum(torch.einsum("nik,ni->nk", j, ws), seg.point, p)


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


# ------------------------------ linear solver ------------------------------


def _flat_cg(matvec_flat, precond_flat, b_flat, options, x0=None):
    """Preconditioned CG on flat tangent vectors.  Returns (x, iterations).

    The loop test ``|r| > tol`` is read on the host, so each iteration syncs
    the host with the device once.
    """
    if x0 is None:
        x = torch.zeros_like(b_flat)
        r = b_flat
    else:
        # Guarded warm start: after a large accepted step the previous
        # delta can be a worse iterate than zero; then start cold.
        r0 = b_flat - matvec_flat(x0)
        if bool(torch.dot(r0, r0) <= torch.dot(b_flat, b_flat)):
            x, r = x0, r0
        else:
            x, r = torch.zeros_like(b_flat), b_flat
    z = precond_flat(r)
    p = z
    rz = torch.dot(r, z)
    tol = options.pcg_rel_tolerance * torch.sqrt(torch.dot(b_flat, b_flat))
    k = 0
    while (k < options.max_pcg_iterations
           and bool(torch.sqrt(torch.dot(r, r)) > tol)):
        ap = matvec_flat(p)
        alpha = rz / torch.clamp_min(torch.dot(p, ap), 1e-35)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond_flat(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.clamp_min(rz, 1e-35)
        p = z + beta * p
        rz = rz_new
        k += 1
    return x, k


def compute_blocks(data, state: BAState, warm_xy, options: BAOptions):
    """Residual/Jacobian blocks for all cameras.

    data: tuple of per-camera ObservationTable; warm_xy: tuple of (n_c, 2).
    Returns (blocks list, new warm tuple).
    """
    blocks, new_warm = [], []
    for ci, seg in enumerate(data):
        model = state.intrinsics[ci]
        protocol.require_supported(model)
        b, w = res.segment_blocks(
            model, state, seg.imageset, seg.camera, seg.point, seg.pixel,
            seg.valid, warm_xy[ci],
            huber_px=options.huber_px,
            max_proj_iterations=options.proj_iterations,
            tangent_frames=manifolds.direction_tangents(model.grid),
            grid_shape=_valid_grid_shape(seg, state),
        )
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
            s = s + torch.einsum("nik,k->ni", b.j_cam, tangent.cam[ci])
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
            cam_t = _add_row(cam_t, ci, torch.einsum("nik,ni->k", b.j_cam, ws))
        if points:
            pts_t = pts_t + _jtw_point(seg, b.j_point, ws, pts_t.shape[0])
        if intr:
            intr_t[ci] = intr_t[ci] + res.intr_apply_jtw(b.intr, ws, intr_t[ci])
    return BATangent(rig=rig_t, cam=cam_t, points=pts_t, intr=tuple(intr_t))


def apply_j(data, blocks, tangent: BATangent):
    """J·v: list of per-observation 2-vectors, one entry per camera."""
    return _apply_j_subset(data, blocks, tangent)


def apply_jtw(data, blocks, s_list, state: BAState) -> BATangent:
    """JᵀW·s: scatter-add per-observation contributions into the tangent."""
    return _apply_jt_subset(data, blocks, s_list, state)


def jtwj_block_diag(data, blocks, state: BAState):
    """Variable-block diagonal of JᵀWJ: 6×6 rig/cam, 3×3 point and per-knot
    K×K grid blocks."""
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
        gh, gw = state.intrinsics[ci].grid.shape[:2]
        bi = b.intr
        intr.append(window_cuda.window_block_diag(
            bi.j_win, bi.base_xy, w, gh, gw, bi.k_tangent))
    return rig, cam, pts, tuple(intr)


def _damped_inv(a, lam):
    k = a.shape[-1]
    return linalg.inv_spd_blocks(
        a + lam * torch.eye(k, dtype=a.dtype, device=a.device))


def make_block_preconditioner(block_diag, lam, state):
    """Invert damped diagonal blocks; returns an apply(r)->z function."""
    rig_inv, cam_inv, pts_inv = (_damped_inv(x, lam) for x in block_diag[:3])
    intr_inv = [_damped_inv(x, lam) for x in block_diag[3]]

    def apply(r: BATangent) -> BATangent:
        return BATangent(
            rig=torch.einsum("mjk,mk->mj", rig_inv, r.rig),
            cam=torch.einsum("cjk,ck->cj", cam_inv, r.cam),
            points=torch.einsum("pjk,pk->pj", pts_inv, r.points),
            intr=tuple(torch.einsum("hwjk,hwk->hwj", inv, ri)
                       for inv, ri in zip(intr_inv, r.intr)),
        )

    return apply


def schur_pcg_solve(data, blocks, state, grad, block_diag, lam, mask, options,
                    eliminate: str = "points", x0=None):
    """Solve (JᵀWJ + λI) δ = −grad by block elimination + PCG.

    eliminate="points" eliminates the 3×3 point blocks (PCG on rig, cameras
    and intrinsics); eliminate="poses" eliminates the 6×6 imageset pose
    blocks (PCG on cameras, points and intrinsics).  The reduced matvec
    stays matrix-free.  Returns (δ, CG iterations).
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
        lam, state,
    )
    mask_keep = zero_elim(mask)
    mask_keep_flat = mask_keep.ravel()

    def apply_elim_block(t_e):
        return torch.einsum("pjk,pk->pj", d_inv, t_e)

    def matvec_flat(vf):
        v = mask_keep.unravel(vf * mask_keep_flat)
        u = _apply_j_subset(data, blocks, v, **keep)
        t_e = get_elim(_apply_jt_subset(data, blocks, u, state, **elim))
        u2 = _apply_j_subset(
            data, blocks, with_elim(zero_tangent(state), apply_elim_block(t_e)),
            **elim)
        diff = [a - b_ for a, b_ in zip(u, u2)]
        out = _apply_jt_subset(data, blocks, diff, state, **keep).ravel()
        return (out + lam * vf) * mask_keep_flat

    def precond_flat(rf):
        return precond(mask_keep.unravel(rf * mask_keep_flat)).ravel() \
            * mask_keep_flat

    # reduced RHS: b_keep = −g_keep + B D⁻¹ g_elim
    g_e = get_elim(grad)
    u2 = _apply_j_subset(
        data, blocks, with_elim(zero_tangent(state), apply_elim_block(g_e)),
        **elim)
    corr = _apply_jt_subset(data, blocks, u2, state, **keep)
    b_flat = grad.map(lambda g, c: -g + c, corr).ravel() * mask_keep_flat

    x0_flat = (zero_elim(x0).ravel() * mask_keep_flat
               if x0 is not None else None)
    x_flat, iters = _flat_cg(matvec_flat, precond_flat, b_flat, options,
                             x0=x0_flat)
    x = mask_keep.unravel(x_flat * mask_keep_flat)

    # back-substitution: δ_e = D⁻¹ (−g_e − Bᵀ δ_keep)
    u = _apply_j_subset(data, blocks, x, **keep)
    bt_x = get_elim(_apply_jt_subset(data, blocks, u, state, **elim))
    x = with_elim(x, apply_elim_block(-g_e - bt_x))
    return _masked(x, mask), iters


def total_cost(data, state, warm_xy, options):
    """Robust per-obs costs, validity and warm pixels for every camera."""
    costs, valids, warms = [], [], []
    for ci, seg in enumerate(data):
        cost, valid, w = res.segment_cost(
            state.intrinsics[ci], state, seg.imageset, seg.camera, seg.point,
            seg.pixel, seg.valid, warm_xy[ci],
            huber_px=options.huber_px,
            max_proj_iterations=options.proj_iterations,
            grid_shape=_valid_grid_shape(seg, state),
        )
        costs.append(cost)
        valids.append(valid)
        warms.append(w)
    return costs, valids, tuple(warms)


# --------------------------------- LM step ---------------------------------


def _solve_step(data, blocks, state, lam, options, x0=None):
    """Gradient, block diagonal, λ initialisation and the Schur-PCG solve.

    Returns (delta, pcg_iters, lam, grad)."""
    check_options(options)
    mask = fix_gauge_mask(state, options.freeze)
    grad = _masked(apply_jtw(data, blocks, [b.r for b in blocks], state), mask)
    block_diag = jtwj_block_diag(data, blocks, state)

    # λ init from the mean scalar diagonal of the blocks
    rig_b, cam_b, pts_b, intr_b = block_diag
    diag_sum = sum(torch.diagonal(x, dim1=-2, dim2=-1).sum()
                   for x in (rig_b, cam_b, pts_b) + tuple(intr_b))
    n_params = sum(x.numel() for x in zero_tangent(state).leaves())
    lam = torch.where(lam < 0, options.lambda_initial_factor * diag_sum / n_params,
                      lam)

    eliminate = "points" if options.solver == "schur" else "poses"
    if eliminate in options.freeze:
        raise NotImplementedError(
            f"freezing the eliminated group ({eliminate!r}) needs the "
            "full-system 'pcg' solver, which is not ported yet (ROADMAP.md "
            "queue 1, item 8)")
    delta, pcg_iters = schur_pcg_solve(
        data, blocks, state, grad, block_diag, lam, mask, options,
        eliminate=eliminate, x0=x0,
    )
    return delta, pcg_iters, lam, grad


def _paired_sums(old_costs, old_valids, new_costs, new_valids, dtype, device):
    """Costs on the observations valid in both states, and full costs."""
    zero = torch.zeros((), dtype=dtype, device=device)
    old_sum, new_sum, full, new_full = zero, zero, zero, zero
    for oc, ov, nc, nv in zip(old_costs, old_valids, new_costs, new_valids):
        joint = ov & nv
        old_sum = old_sum + torch.sum(torch.where(joint, oc, 0.0))
        new_sum = new_sum + torch.sum(torch.where(joint, nc, 0.0))
        full = full + torch.sum(oc)
        new_full = new_full + torch.sum(nc)
    return old_sum, new_sum, full, new_full


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
    costs stay 0-d tensors.
    """
    if blocks is None:
        return _lm_step_two_pass(state, warm_xy, lam, data, options)
    x0 = prev_delta if options.cg_warm_start else None
    delta, pcg_iters, lam, grad = _solve_step(data, blocks, state, lam,
                                              options, x0=x0)
    test_state = apply_freeze(state, retract(state, delta), options.freeze)
    test_blocks, warm2 = compute_blocks(data, test_state, warm_xy, options)
    old_sum, new_sum, full_cost, new_full_cost = _paired_sums(
        [b.cost for b in blocks], [b.valid for b in blocks],
        [b.cost for b in test_blocks], [b.valid for b in test_blocks],
        state.points.dtype, state.points.device)
    accept = bool(new_sum < old_sum)
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
    blocks, warm1 = compute_blocks(data, state, warm_xy, options)
    delta, pcg_iters, lam, _ = _solve_step(data, blocks, state, lam, options)
    test_state = apply_freeze(state, retract(state, delta), options.freeze)
    test_costs, test_valids, warm2 = total_cost(data, test_state, warm1, options)
    old_sum, new_sum, full_cost, new_full_cost = _paired_sums(
        [b.cost for b in blocks], [b.valid for b in blocks],
        test_costs, test_valids, state.points.dtype, state.points.device)
    accept = bool(new_sum < old_sum)
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
        blocks, warm = compute_blocks(data, state, warm, options)
        delta = zero_tangent(state)
        outs = tuple([] for _ in range(6))
        for _ in range(int(n_steps)):
            (state, warm, lam, accept, cost, new_cost, iters, p_old, p_new,
             blocks, delta) = lm_step(state, warm, lam, data, options, blocks,
                                      prev_delta=delta)
            for lst, v in zip(outs, (accept, float(cost), float(new_cost),
                                     iters, float(p_old), float(p_new))):
                lst.append(v)
        return state, warm, lam, outs

    return scanned


def maybe_grid_layout(data, state: BAState, options: BAOptions):
    """Re-lay per-camera tables into (M, P) grid layout when the fill ratio
    justifies it (``options.table_layout='auto'``)."""
    if options.table_layout == "flat":
        return tuple(data)
    m = state.rig_q_global.shape[0]
    p = state.points.shape[0]
    out = []
    for seg in data:
        if seg.grid_shape is not None:
            out.append(seg)
            continue
        n_valid = int(seg.valid.sum())
        if m * p <= options.grid_layout_max_expand * max(n_valid, 1):
            out.append(to_grid_layout(seg, m, p))
        else:
            out.append(seg)
    return tuple(out)


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
    data = tuple(seg if isinstance(seg, ObservationTable)
                 else convert.observation_table(seg, device=dev)
                 for seg in data)
    data = maybe_grid_layout(data, state, options)
    k = max(1, int(options.lm_steps_per_call))
    if options.cg_warm_start and k == 1:
        warnings.warn(
            "cg_warm_start=True has no effect: it needs the cached-blocks "
            "path (lm_steps_per_call > 1).", stacklevel=2)
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
    while it < options.max_lm_iterations and not stop:
        t0 = time.perf_counter()
        if k > 1:
            state, warm, lam, outs = step(state, warm, lam, data)
            entries = list(zip(*outs))
        else:
            (state, warm, lam, accept, cost, new_cost, pcg_iters,
             p_old, p_new) = step(state, warm, lam, data)
            entries = [(accept, float(cost), float(new_cost), pcg_iters,
                        float(p_old), float(p_new))]
        dt = time.perf_counter() - t0  # the float conversions synced
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
                "lambda": float(lam),
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

"""PatchMatch stereo depth estimation on calibrated generic cameras.

The counterpart of the reference package's ``stereo/patch_match.py``,
function for function, in PyTorch.  Two stages:

1. *Plane-sweep init* (:func:`_plane_sweep_jit`): L constant-inverse-depth
   hypotheses, each scored as one whole-image warp and box-filtered
   ZNCC/SSD; winner-take-all, parabola refinement and a ± polish.
2. *Slanted PatchMatch* (:func:`_patch_match_jit`): a per-pixel plane
   (unit normal n, offset c with n·X = c).  Every candidate field —
   neighbour propagation by shifts at strides 1 and 2 and random plane
   mutations of shrinking scale — is scored for all pixels at once: one
   warp of the plane/ray intersections plus a per-pixel affine window
   map A(p) from the projection's point Jacobian, so the window samples
   are bilinear reads at W(p) + A(p)·o against shifted reference pixels.

Every warp projects all H·W points through ``protocol.project_points``:
for a float32 CentralGeneric camera on the card that is the ``project``
kernel, warm-started from the previous candidate's pixels.  The random
draws of a PatchMatch round come from a ``torch.Generator`` seeded with
``opts.seed`` on the images' device; :func:`_patch_match_round` takes
them as arguments.

Post-processing: LR consistency, an edge-preserving bilateral filter on
inverse depth and a connected-component speckle filter (host SciPy).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from camera_calibration_torch.models import protocol
from camera_calibration_torch.ops import interp


@dataclasses.dataclass(frozen=True)
class PatchMatchOptions:
    iterations: int = 8  # PatchMatch propagation/mutation rounds
    num_levels: int = 64  # plane-sweep init hypotheses
    refinement_iterations: int = 6
    patch_radius: int = 3
    metric: str = "zncc"  # zncc | ssd
    min_depth: float = 0.2
    max_depth: float = 20.0
    mutation_count: int = 2  # random plane mutations per round
    consistency_threshold_px: float = 1.5
    # slanted-window sample offsets: every `window_stride`-th integer
    # offset inside the (2·patch_radius+1)² window
    window_stride: int = 1
    max_tilt_cos: float = 0.25  # |n·dir| floor (≤ ~75° plane tilt)
    seed: int = 0


def _box_filter(img, radius):
    """Separable box mean with same-size output (zero padding)."""
    k = 2 * radius + 1
    x = img[None, None]
    x = F.avg_pool2d(x, (1, k), stride=1, padding=(0, radius),
                     count_include_pad=True)
    x = F.avg_pool2d(x, (k, 1), stride=1, padding=(radius, 0),
                     count_include_pad=True)
    return x[0, 0]


def _window_metric(ref_img, warped, valid, opts):
    """Box-filtered SSD or 1 − ZNCC of a warped image (inf where invalid)."""
    r = opts.patch_radius
    inf = torch.tensor(float("inf"), dtype=ref_img.dtype,
                       device=ref_img.device)
    if opts.metric == "ssd":
        diff = torch.where(valid, (ref_img - warped) ** 2,
                           torch.zeros_like(ref_img))
        return torch.where(valid, _box_filter(diff, r), inf)
    wv = valid.to(ref_img.dtype)
    n = _box_filter(wv, r) + 1e-9
    m_a = _box_filter(ref_img * wv, r) / n
    m_b = _box_filter(warped * wv, r) / n
    v_a = _box_filter(ref_img * ref_img * wv, r) / n - m_a * m_a
    v_b = _box_filter(warped * warped * wv, r) / n - m_b * m_b
    cov = _box_filter(ref_img * warped * wv, r) / n - m_a * m_b
    cost = 1.0 - cov / torch.sqrt(torch.clamp_min(v_a * v_b, 1e-10))
    return torch.where(valid, cost, inf)


def _warp_cost(ref_img, other_img, dirs_ref, inv_depth, r_rel, t_rel,
               model_other, opts):
    """Photometric cost of an inverse-depth field (whole image).

    dirs_ref: (H, W, 3) unit rays of the reference camera.
    Returns (cost (H, W), valid (H, W)).
    """
    h, w = ref_img.shape
    depth = 1.0 / torch.clamp_min(inv_depth, 1e-9)
    pts = dirs_ref * depth[..., None]  # reference-camera space
    pts_other = pts @ r_rel.T + t_rel
    px, _, pvalid = protocol.project_points(
        model_other, pts_other.reshape(-1, 3), max_iterations=8)
    px = px.reshape(h, w, 2)
    pvalid = pvalid.reshape(h, w) & (pts_other[..., 2] > 1e-6)
    warped = interp.bilinear(other_img, px - 0.5)  # pixel-center sampling
    inb = interp.in_bounds(other_img.shape, px - 0.5, margin=1.0)
    valid = pvalid & inb
    return _window_metric(ref_img, warped, valid, opts), valid


def _center_warm(h, w, like):
    return (torch.tensor([w * 0.5, h * 0.5], dtype=like.dtype,
                         device=like.device).expand(h * w, 2).contiguous())


def _plane_sweep_jit(ref_img, other_img, dirs_ref, r_rel, t_rel,
                     model_other, opts):
    """Inverse-depth plane sweep + winner-take-all + parabola refinement.

    L constant-inverse-depth hypotheses, each scored as a whole-image warp
    and box-filtered metric; the projections are warm-started level to
    level.  Returns (inv_depth (H, W), cost (H, W)).
    """
    h, w = ref_img.shape
    dtype, dev = ref_img.dtype, ref_img.device
    inv_min = 1.0 / opts.max_depth
    inv_max = 1.0 / opts.min_depth
    levels = torch.linspace(inv_min, inv_max, opts.num_levels,
                            dtype=torch.float64).to(dtype).to(dev)
    dirs_flat = dirs_ref.reshape(-1, 3)
    volume = torch.empty((opts.num_levels, h, w), dtype=dtype, device=dev)
    warm = _center_warm(h, w, ref_img)
    for li in range(opts.num_levels):
        pts_other = (dirs_flat * (1.0 / levels[li])) @ r_rel.T + t_rel
        px, _, pvalid = protocol.project_points(
            model_other, pts_other, init_xy=warm, max_iterations=6)
        warm = torch.where(pvalid[:, None], px, warm)
        pximg = px.reshape(h, w, 2)
        valid = (pvalid.reshape(h, w)
                 & interp.in_bounds(other_img.shape, pximg - 0.5,
                                    margin=1.0))
        warped = interp.bilinear(other_img, pximg - 0.5)
        volume[li] = _window_metric(ref_img, warped, valid, opts)

    best = torch.argmin(volume, dim=0)  # (H, W); all-inf picks level 0
    # parabola sub-level refinement between neighbours
    lidx = torch.clamp(best, 1, opts.num_levels - 2)
    c0 = torch.gather(volume, 0, (lidx - 1)[None])[0]
    c1 = torch.gather(volume, 0, lidx[None])[0]
    c2 = torch.gather(volume, 0, (lidx + 1)[None])[0]
    del volume
    denom = c0 - 2 * c1 + c2
    zero = torch.zeros_like(denom)
    delta = torch.where(torch.abs(denom) > 1e-12, 0.5 * (c0 - c2) / denom,
                        zero)
    delta = torch.clamp(torch.where(torch.isfinite(delta), delta, zero),
                        -1.0, 1.0)
    step = (inv_max - inv_min) / (opts.num_levels - 1)
    inv_depth = torch.clamp(levels[lidx] + delta * step, inv_min, inv_max)

    # local continuous polish: small ± candidates with full recompute
    cost, _ = _warp_cost(ref_img, other_img, dirs_ref, inv_depth, r_rel,
                         t_rel, model_other, opts)
    for i in range(opts.refinement_iterations):
        frac = 0.5 ** (i + 1)
        for sign in (-1.0, 1.0):
            cand = torch.clamp(inv_depth + sign * frac * step, inv_min,
                               inv_max)
            c, _ = _warp_cost(ref_img, other_img, dirs_ref, cand, r_rel,
                              t_rel, model_other, opts)
            better = c < cost
            inv_depth = torch.where(better, cand, inv_depth)
            cost = torch.where(better, c, cost)
    return inv_depth, cost


# --------------------------- slanted PatchMatch ---------------------------


def _ray_field_derivative(dirs_ref):
    """d dir / d pixel via central differences: (H, W, 3, 2)."""
    dx = 0.5 * (torch.roll(dirs_ref, -1, 1) - torch.roll(dirs_ref, 1, 1))
    dy = 0.5 * (torch.roll(dirs_ref, -1, 0) - torch.roll(dirs_ref, 1, 0))
    # one-sided at the borders
    dx[:, 0] = dirs_ref[:, 1] - dirs_ref[:, 0]
    dx[:, -1] = dirs_ref[:, -1] - dirs_ref[:, -2]
    dy[0, :] = dirs_ref[1] - dirs_ref[0]
    dy[-1, :] = dirs_ref[-1] - dirs_ref[-2]
    return torch.stack([dx, dy], dim=-1)


def _window_offsets(opts):
    r = opts.patch_radius
    st = max(1, opts.window_stride)
    vals = list(range(-r, r + 1, st))
    if vals[-1] != r:
        vals.append(r)
    return [(du, dv) for dv in vals for du in vals]


def _plane_depth(n_f, c_f, dirs_ref):
    """(n·dir, its sign-safe version, ray depth c / n·dir)."""
    nd = (n_f * dirs_ref).sum(-1)
    nd_safe = torch.sign(nd) * torch.clamp_min(torch.abs(nd), 1e-9)
    return nd, nd_safe, c_f / nd_safe


def _slanted_cost(ref_img, other_img, dirs_ref, ddirs, n_f, c_f,
                  r_rel, t_rel, model_other, warm, opts):
    """Slanted-window cost of a plane field (whole image).

    n_f (H,W,3) unit plane normals, c_f (H,W) plane offsets (n·X = c).
    Returns (cost (H,W), valid (H,W), warm pixels (H*W,2)).
    """
    h, w = ref_img.shape
    dtype, dev = ref_img.dtype, ref_img.device
    nd, nd_safe, z = _plane_depth(n_f, c_f, dirs_ref)
    zc = torch.clamp(z, opts.min_depth, opts.max_depth)
    plane_ok = ((torch.abs(nd) > opts.max_tilt_cos)
                & (z > opts.min_depth) & (z < opts.max_depth))
    x_o = (dirs_ref * zc[..., None]) @ r_rel.T + t_rel
    x_flat = x_o.reshape(-1, 3)

    px, aux, pvalid = protocol.project_points(
        model_other, x_flat, init_xy=warm, max_iterations=6)
    warm_next = torch.where(pvalid[:, None], px, warm)
    # plane-induced local affine: dpx/dp = P(x_o)·R·dX/dp with
    # dX/dp = z·ddir + dir ⊗ dz/dp, dz/dp = −z (n·ddir)/(n·dir)
    p_jac = protocol.projection_point_jacobian(
        model_other, x_flat, aux).reshape(h, w, 2, 3)
    n_ddir = torch.einsum("hwj,hwjk->hwk", n_f, ddirs)  # (H,W,2)
    dz = -(zc / nd_safe)[..., None] * n_ddir  # (H,W,2)
    d_x = (zc[..., None, None] * ddirs
           + dirs_ref[..., :, None] * dz[..., None, :])
    a_f = p_jac @ r_rel @ d_x  # (H,W,2,2)
    del p_jac, d_x

    pximg = px.reshape(h, w, 2)
    base_valid = (pvalid.reshape(h, w) & plane_ok
                  & interp.in_bounds(other_img.shape, pximg - 0.5,
                                     margin=1.0))
    base = pximg - 0.5
    offsets = _window_offsets(opts)
    zeros = torch.zeros((h, w), dtype=dtype, device=dev)
    s_v, s_r, s_vv = zeros.clone(), zeros.clone(), zeros.clone()
    s_rr, s_rv, s_n = zeros.clone(), zeros.clone(), zeros
    for du, dv in offsets:
        pos = base + (a_f[..., 0] * du + a_f[..., 1] * dv)
        val = interp.bilinear(other_img, pos)
        ok = (interp.in_bounds(other_img.shape, pos, margin=1.0)
              & _shift_valid(h, w, du, dv, dev))
        refv = torch.roll(ref_img, (-dv, -du), (0, 1))
        wgt = ok.to(dtype)
        wv = wgt * val
        wr = wgt * refv
        s_v = s_v + wv
        s_r = s_r + wr
        s_vv = s_vv + wv * val
        s_rr = s_rr + wr * refv
        s_rv = s_rv + wr * val
        s_n = s_n + wgt
    n_eff = torch.clamp_min(s_n, 1e-9)
    if opts.metric == "ssd":
        cost = (s_rr - 2 * s_rv + s_vv) / n_eff
    else:
        m_v = s_v / n_eff
        m_r = s_r / n_eff
        var_v = s_vv / n_eff - m_v * m_v
        var_r = s_rr / n_eff - m_r * m_r
        cov = s_rv / n_eff - m_r * m_v
        cost = 1.0 - cov / torch.sqrt(torch.clamp_min(var_r * var_v, 1e-10))
    valid = base_valid & (s_n >= 0.5 * len(offsets))
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    return torch.where(valid, cost, inf), valid, warm_next


def _shift_valid(h, w, du, dv, device=None):
    """Mask of pixels whose (du, dv)-shifted neighbour is in-image."""
    xs = torch.arange(w, device=device)
    ys = torch.arange(h, device=device)
    okx = (xs + du >= 0) & (xs + du < w)
    oky = (ys + dv >= 0) & (ys + dv < h)
    return oky[:, None] & okx[None, :]


def _roll_field(n_f, c_f, du, dv):
    """Neighbour plane candidates: shift the plane field by (du, dv)."""
    return (torch.roll(n_f, (dv, du), (0, 1)),
            torch.roll(c_f, (dv, du), (0, 1)))


SHIFTS = ((1, 0), (-1, 0), (0, 1), (0, -1),
          (2, 0), (-2, 0), (0, 2), (0, -2))


def _accept(state, n_c, c_c, cost_c):
    n_f, c_f, cost = state
    better = cost_c < cost
    return (torch.where(better[..., None], n_c, n_f),
            torch.where(better, c_c, c_f),
            torch.where(better, cost_c, cost))


def _patch_match_round(evaluate, dirs_ref, state, uniforms, normals, opts):
    """One propagation + mutation round.

    evaluate(n, c, warm) -> (cost, valid, warm); state (n_f, c_f, cost,
    warm); ``uniforms[mi]`` (H, W) in [-1, 1) and ``normals[mi]`` (H, W, 3)
    standard normal are the draws of mutation ``mi``.
    """
    n_f, c_f, cost, warm = state
    # propagation: neighbour planes at strides 1 and 2
    for du, dv in SHIFTS:
        n_c, c_c = _roll_field(n_f, c_f, du, dv)
        cost_c, _, warm = evaluate(n_c, c_c, warm)
        n_f, c_f, cost = _accept((n_f, c_f, cost), n_c, c_c, cost_c)
    # random mutations with shrinking scale
    for mi in range(opts.mutation_count):
        frac = 0.5 ** (mi + 1)
        # depth mutation: multiplicative jitter of the ray depth
        _, _, z = _plane_depth(n_f, c_f, dirs_ref)
        jitter = 1.0 + frac * 0.5 * uniforms[mi]
        z_c = torch.clamp(z * jitter, opts.min_depth, opts.max_depth)
        c_c = c_f / torch.clamp_min(torch.abs(z), 1e-9) * z_c * torch.sign(z)
        cost_c, _, warm = evaluate(n_f, c_c, warm)
        n_f, c_f, cost = _accept((n_f, c_f, cost), n_f, c_c, cost_c)
        # normal mutation: random tilt, re-anchored at the same point
        n_c = n_f + frac * normals[mi]
        n_c = n_c / torch.clamp_min(
            torch.linalg.vector_norm(n_c, dim=-1, keepdim=True), 1e-9)
        # keep normals facing the camera
        facing = (n_c * dirs_ref).sum(-1) < 0
        n_c = torch.where(facing[..., None], n_c, -n_c)
        _, _, z_f = _plane_depth(n_f, c_f, dirs_ref)
        c_c = (n_c * (dirs_ref * z_f[..., None])).sum(-1)
        cost_c, _, warm = evaluate(n_c, c_c, warm)
        n_f, c_f, cost = _accept((n_f, c_f, cost), n_c, c_c, cost_c)
    return n_f, c_f, cost, warm


def _draws(gen, opts, h, w, like):
    """One round's mutation draws from ``gen``: uniforms in [-1, 1) and
    standard normals, in the images' type and device."""
    uniforms, normals = [], []
    for _ in range(opts.mutation_count):
        u = torch.rand((h, w), generator=gen, dtype=like.dtype,
                       device=like.device)
        uniforms.append(2.0 * u - 1.0)
        normals.append(torch.randn((h, w, 3), generator=gen,
                                   dtype=like.dtype, device=like.device))
    return uniforms, normals


def _patch_match_setup(ref_img, other_img, dirs_ref, r_rel, t_rel,
                       model_other, inv_depth0, opts):
    """(evaluate, state) of a PatchMatch run: the slanted-cost closure and
    the scored fronto-parallel planes of the sweep depth."""
    h, w = ref_img.shape
    ddirs = _ray_field_derivative(dirs_ref)
    n_f = -dirs_ref
    z0 = 1.0 / torch.clamp_min(inv_depth0, 1e-9)
    c_f = (n_f * (dirs_ref * z0[..., None])).sum(-1)

    def evaluate(n_c, c_c, warm):
        return _slanted_cost(ref_img, other_img, dirs_ref, ddirs, n_c, c_c,
                             r_rel, t_rel, model_other, warm, opts)

    cost, _, warm = evaluate(n_f, c_f, _center_warm(h, w, ref_img))
    return evaluate, (n_f, c_f, cost, warm)


def _patch_match_jit(ref_img, other_img, dirs_ref, r_rel, t_rel,
                     model_other, inv_depth0, opts):
    """Slanted-plane PatchMatch from a plane-sweep init.

    Returns (inv_depth, cost, normals)."""
    h, w = ref_img.shape
    evaluate, state = _patch_match_setup(ref_img, other_img, dirs_ref, r_rel,
                                         t_rel, model_other, inv_depth0,
                                         opts)
    gen = torch.Generator(device=ref_img.device)
    gen.manual_seed(opts.seed)
    for _ in range(opts.iterations):
        uniforms, normals = _draws(gen, opts, h, w, ref_img)
        state = _patch_match_round(evaluate, dirs_ref, state, uniforms,
                                   normals, opts)
    n_f, c_f, cost, _ = state
    _, _, z = _plane_depth(n_f, c_f, dirs_ref)
    z = torch.clamp(z, opts.min_depth, opts.max_depth)
    return 1.0 / z, cost, n_f


def pixel_directions(model, h, w, dtype, device):
    """(H, W, 3) unit rays of the pixel centers of ``model``."""
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=dtype, device=device) + 0.5,
        torch.arange(w, dtype=dtype, device=device) + 0.5, indexing="ij")
    px = torch.stack([xx, yy], -1).reshape(-1, 2)
    dirs, _ = protocol.unproject(model, px)
    return dirs.reshape(h, w, 3)


def compute_depth_map(ref_img, other_img, model_ref, model_other,
                      other_tr_ref,
                      opts: PatchMatchOptions = PatchMatchOptions(),
                      algorithm: str = "patch_match"):
    """Inverse-depth map of ref_img (reference-camera frame).

    Images are (H, W) tensors in the models' type and on their device.
    other_tr_ref: (R, t) with x_other = R x_ref + t.
    algorithm: "patch_match" (plane-sweep init + slanted PatchMatch) or
    "plane_sweep" (fronto-parallel init only).
    Returns a dict with inv_depth, depth, cost, dirs (+ normals for
    patch_match).
    """
    if algorithm not in ("patch_match", "plane_sweep"):
        raise ValueError(f"unknown stereo algorithm {algorithm!r}")
    h, w = ref_img.shape
    dtype, dev = ref_img.dtype, ref_img.device
    dirs_ref = pixel_directions(model_ref, h, w, dtype, dev)
    r_rel = torch.as_tensor(other_tr_ref[0], dtype=dtype, device=dev)
    t_rel = torch.as_tensor(other_tr_ref[1], dtype=dtype, device=dev)
    inv_depth, cost = _plane_sweep_jit(ref_img, other_img, dirs_ref, r_rel,
                                       t_rel, model_other, opts)
    out = {"inv_depth": inv_depth,
           "depth": 1.0 / torch.clamp_min(inv_depth, 1e-9),
           "cost": cost, "dirs": dirs_ref}
    if algorithm == "patch_match":
        inv_depth, cost, normals = _patch_match_jit(
            ref_img, other_img, dirs_ref, r_rel, t_rel, model_other,
            inv_depth, opts)
        out.update(inv_depth=inv_depth,
                   depth=1.0 / torch.clamp_min(inv_depth, 1e-9),
                   cost=cost, normals=normals)
    return out


def lr_consistency_mask(result_l, result_r, model_l, model_r, r_tr_l,
                        threshold_px=1.5):
    """Left-right consistency filter.

    Projects each left pixel's 3D point into the right view, samples the
    right depth and requires the right-camera depths to agree.
    """
    depth_l = result_l["depth"]
    h, w = depth_l.shape
    dtype, dev = depth_l.dtype, depth_l.device
    pts_l = result_l["dirs"] * depth_l[..., None]
    r_rel = torch.as_tensor(r_tr_l[0], dtype=dtype, device=dev)
    t_rel = torch.as_tensor(r_tr_l[1], dtype=dtype, device=dev)
    pts_r = pts_l @ r_rel.T + t_rel
    px_r, _, valid_r = protocol.project_points(
        model_r, pts_r.reshape(-1, 3), max_iterations=8)
    px_r_img = px_r.reshape(h, w, 2)
    depth_r_sampled = interp.bilinear(result_r["depth"], px_r_img - 0.5)
    # right-camera depth of the left point
    z_r = torch.linalg.vector_norm(pts_r, dim=-1)
    rel_err = torch.abs(depth_r_sampled - z_r) / torch.clamp_min(z_r, 1e-6)
    inb = interp.in_bounds(result_r["depth"].shape, px_r_img - 0.5,
                           margin=1.0)
    return (valid_r.reshape(h, w) & inb
            & (rel_err < 0.02 + threshold_px / 720.0))


def median_filter(depth, size=3):
    """Median post-filter (host SciPy)."""
    from scipy.ndimage import median_filter as mf

    d = torch.as_tensor(depth)
    return torch.as_tensor(mf(d.cpu().numpy(), size=size)).to(d.device)


def bilateral_filter(inv_depth, guide, radius=3, sigma_space=2.0,
                     sigma_range=0.08, sigma_value=0.05):
    """Edge-preserving bilateral filter on inverse depth, guided by the
    reference image: weights combine spatial distance, guide-intensity
    difference and inverse-depth difference of shifted copies."""
    acc = torch.zeros_like(inv_depth)
    wacc = torch.zeros_like(inv_depth)
    for dv in range(-radius, radius + 1):
        for du in range(-radius, radius + 1):
            d_s = torch.roll(inv_depth, (dv, du), (0, 1))
            g_s = torch.roll(guide, (dv, du), (0, 1))
            w_ = torch.exp(
                -(du * du + dv * dv) / (2 * sigma_space ** 2)
                - (guide - g_s) ** 2 / (2 * sigma_range ** 2)
                - (inv_depth - d_s) ** 2 / (2 * sigma_value ** 2))
            acc = acc + w_ * d_s
            wacc = wacc + w_
    return acc / torch.clamp_min(wacc, 1e-12)


def connected_component_filter(mask, inv_depth, min_size=50,
                               depth_tol=0.02):
    """Remove small speckle components (host SciPy labelling).

    Components connect neighbouring valid pixels of similar inverse depth
    (coarse relative buckets); components smaller than ``min_size``
    pixels are invalidated.  Returns a NumPy bool mask.
    """
    from scipy import ndimage

    mask = np.asarray(_host(mask), bool)
    inv_d = np.asarray(_host(inv_depth))
    # break connectivity across depth discontinuities: quantize
    step = depth_tol * max(float(np.nanmedian(inv_d[mask])) if mask.any()
                           else 1.0, 1e-6)
    q = np.round(inv_d / max(step, 1e-9)).astype(np.int64)
    lbl, n = ndimage.label(mask)
    out = mask.copy()
    if n == 0:
        return out
    # split labels further by quantized depth: combine label and coarse
    # depth bucket, then re-label
    combo = (lbl.astype(np.int64) << 20) + np.clip(q // 4, 0, (1 << 19))
    combo[~mask] = 0
    _, combo_ids = np.unique(combo, return_inverse=True)
    combo_ids = combo_ids.reshape(mask.shape)
    lbl2, n2 = ndimage.label(combo_ids * mask)
    sizes = ndimage.sum_labels(mask, lbl2, index=np.arange(1, n2 + 1))
    small = np.zeros(n2 + 1, bool)
    small[1:] = sizes < min_size
    out[small[lbl2]] = False
    return out


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


EXPORT_CHUNK = 1 << 16  # .obj lines formatted per write


def export_point_cloud(path, result, mask=None, colors=None):
    """Export a depth map as a (coloured) .obj point cloud: one
    ``v x y z [r g b]`` line per masked pixel, row-major, written in
    chunks of EXPORT_CHUNK points."""
    depth = np.asarray(_host(result["depth"]))
    dirs = np.asarray(_host(result["dirs"]))
    pts = dirs * depth[..., None]
    m = np.ones(depth.shape, bool) if mask is None else np.asarray(
        _host(mask), bool)
    ys, xs = np.nonzero(m)
    cols = [pts[ys, xs].astype(np.float64)]
    fmt = "v %.6f %.6f %.6f\n"
    if colors is not None:
        c = np.asarray(_host(colors))[ys, xs]
        if c.ndim == 1:
            c = np.repeat(c[:, None], 3, axis=1)
        cols.append(c[:, :3].astype(np.float64))
        fmt = "v %.6f %.6f %.6f %.3f %.3f %.3f\n"
    rows = np.concatenate(cols, axis=1)
    with open(path, "w") as f:
        for s in range(0, rows.shape[0], EXPORT_CHUNK):
            f.write("".join(fmt % tuple(r)
                            for r in rows[s:s + EXPORT_CHUNK].tolist()))

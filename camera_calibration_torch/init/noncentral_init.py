"""Noncentral dense initialization: per-pixel 3D lines instead of rays.

The port of the reference package's ``init/noncentral_init.py``: it
bootstraps a NoncentralGeneric camera from scratch, with no central
calibration to convert.

1. bootstrap a random image triple with the noncentral planar
   Ramalingam–Sturm solver (``init.relative_pose.
   noncentral_planar_relative_pose``), which returns the mirror candidate
   pair;
2. polish both candidates geometrically (L-BFGS on the per-pixel line
   thickness) and tell the mirror apart by the handedness of the
   resulting direction field: any real camera, central or not, has
   ``det[∂d/∂x, ∂d/∂y, d] > 0`` in pixel-aligned coordinates, and the
   mirrored solution flips the sign;
3. accumulate per-buffer-pixel point statistics (Σp, Σppᵀ, n) from every
   localized view; each pixel's 3D line is the principal axis of its
   point cloud;
4. localize the remaining images against the line field: a central P3P
   RANSAC seed (line directions as bearings) and Gauss–Newton on exact
   point-to-line distances, a generalized-camera pose solve;
5. rebuild the line field from all localized views and re-localize them
   (``alternating_refinement``).

Everything here is host orchestration in NumPy (and SciPy's L-BFGS-B);
the P3P polish runs on tensors on ``config.host_device()``, the square
rasterizer is the port's native library.  The random draws come from
``np.random.default_rng(options.seed)`` in the reference's order, so one
seed gives the same triples, subsets and RANSAC samples.
``models.fit.fit_noncentral_to_lines`` fits the model to
:meth:`NoncentralInitResult.line_field`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from camera_calibration_torch.ba.dataset import Dataset
from camera_calibration_torch.init import dense_init as di
from camera_calibration_torch.init.p3p import ransac_p3p
from camera_calibration_torch.init.relative_pose import (
    noncentral_planar_relative_pose,
)


def _hat_np(a):
    return np.array([
        [0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]
    ])


@dataclasses.dataclass
class NoncentralInitResult:
    point_sum: np.ndarray  # (bh, bw, 3)
    point_sq_sum: np.ndarray  # (bh, bw, 3, 3)
    point_count: np.ndarray  # (bh, bw) int
    image_used: list
    image_tr_global: list  # per imageset (R, t) or None — camera_tr_global
    global_tr_known_geometry: list
    buffer_size: tuple
    image_size: tuple

    def line_field(self):
        """Per-pixel (direction (bh,bw,3), anchor (bh,bw,3), valid).

        direction = principal axis of the pixel's point scatter, oriented
        away from the effective camera centroid; anchor = closest point of
        the line to that centroid.  Pixels need ≥2 accumulated points.
        """
        cnt = self.point_count
        valid = cnt >= 2
        n = np.maximum(cnt, 1)[..., None]
        mean = self.point_sum / n
        cov = self.point_sq_sum / n[..., None] - mean[..., :, None] * mean[..., None, :]
        # principal axis per pixel (3x3 symmetric eigendecomposition)
        _, v = np.linalg.eigh(cov)
        dirs = v[..., -1]  # largest eigenvalue's vector
        # effective camera centroid: iterate closest-points once
        m_valid = mean[valid]
        d_valid = dirs[valid]
        c = m_valid.mean(0) if m_valid.size else np.zeros(3)
        for _ in range(3):
            t = np.einsum("nj,nj->n", c - m_valid, d_valid)
            closest = m_valid + t[:, None] * d_valid
            c = closest.mean(0)
        # orient directions from camera centroid toward the pattern points
        sign = np.sign(
            np.einsum("hwj,hwj->hw", dirs, mean - c)[..., None]
        )
        dirs = dirs * np.where(sign == 0, 1.0, sign)
        t_all = np.einsum("j,hwj->hw", c, dirs) - np.einsum(
            "hwj,hwj->hw", mean, dirs
        )
        anchors = mean + t_all[..., None] * dirs
        valid = valid & np.isfinite(dirs).all(-1)
        return dirs, anchors, valid, c

    def observation_directions(self):
        """Central-compatible direction field (for a central-model fit)."""
        dirs, _, valid, _ = self.line_field()
        return dirs, valid


def _field_handedness(dirs, valid):
    """Normalized median det[∂x d, ∂y d, d] over the direction field.

    ≈ +1 for a physically-realizable camera field (right-handed pixel→ray
    map), ≈ −1 for its mirror, ≈ 0 for a degenerate/collapsed field.
    """
    dx = dirs[:, 1:] - dirs[:, :-1]
    dy = dirs[1:, :] - dirs[:-1, :]
    v = valid[:, 1:] & valid[:, :-1]
    v = v[1:, :] & v[:-1, :] & valid[1:, 1:]
    det = np.einsum(
        "hwi,hwi->hw",
        np.cross(dx[1:, :, :], dy[:, 1:, :]),
        dirs[1:, 1:],
    )
    vals = det[v]
    if not vals.size:
        return 0.0
    nx = np.linalg.norm(dx[1:, :, :], axis=-1)[v]
    ny = np.linalg.norm(dy[:, 1:, :], axis=-1)[v]
    scale = np.median(nx) * np.median(ny)
    return float(np.median(vals) / max(scale, 1e-30))


class NoncentralDenseInitializer:
    """Per-camera noncentral initializer (host orchestration)."""

    def __init__(self, dataset: Dataset, camera_index: int,
                 options: di.DenseInitOptions = di.DenseInitOptions()):
        self.dataset = dataset
        self.ci = camera_index
        self.opts = options
        self.image_size = dataset.image_sizes[camera_index]
        self.bsize = di._buffer_size(self.image_size, options)
        bw, bh = self.bsize
        self.point_sum = np.zeros((bh, bw, 3))
        self.point_sq_sum = np.zeros((bh, bw, 3, 3))
        self.point_count = np.zeros((bh, bw), np.int64)
        self.image_used = [False] * len(dataset.imagesets)
        self.image_tr_global = [None] * len(dataset.imagesets)
        self.global_tr_known_geometry = [None] * len(dataset.known_geometries)
        self.rng = np.random.default_rng(options.seed)

    # ------------------------- accumulation -------------------------

    def _dense_pattern_matches(self, imageset_index, geometry_index):
        """Identity-pose densified matches, memoized (pure function of
        the imageset's features; the bootstrap loop re-requests the same
        imagesets hundreds of times — see DenseInitializer)."""
        cache = getattr(self, "_dpm_cache", None)
        if cache is None:
            cache = self._dpm_cache = {}
        key = (imageset_index, geometry_index)
        hit = cache.get(key)
        if hit is not None:
            return hit
        feats = self.dataset.imagesets[imageset_index].features[self.ci]
        geoms = [self.dataset.known_geometries[geometry_index]]
        poses = [(np.eye(3), np.zeros(3))]
        out = di.densify_matches(feats, geoms, poses, self.bsize,
                                 self.image_size)
        cache[key] = out
        return out

    def _accumulate(self, pts_global, valid):
        """Add per-pixel 3D points (camera frame == global frame)."""
        p = pts_global[valid]
        self.point_sum[valid] += p
        self.point_sq_sum[valid] += p[:, :, None] * p[:, None, :]
        self.point_count[valid] += 1

    def update_with_image(self, imageset_index, pose):
        r_ig, t_ig = pose  # image(camera)_tr_global
        feats = self.dataset.imagesets[imageset_index].features[self.ci]
        pts, valid = di.densify_matches(
            feats, self.dataset.known_geometries,
            self.global_tr_known_geometry, self.bsize, self.image_size,
        )
        cam_pts = np.where(
            valid[..., None], pts @ r_ig.T + t_ig, 0.0
        )
        self._accumulate(cam_pts, valid)
        self.image_used[imageset_index] = True
        self.image_tr_global[imageset_index] = pose

    # ------------------------- bootstrap -------------------------

    def attempt_bootstrap(self):
        """Noncentral planar RS on random triples; mirror disambiguated by
        direction-field handedness."""
        n_sets = len(self.dataset.imagesets)
        bw, bh = self.bsize
        n_px = bw * bh
        candidates = [
            si for si in range(n_sets)
            if len(self.dataset.imagesets[si].features[self.ci]) >= 6
        ]
        if len(candidates) < 3:
            return False
        floor = 5.0 * self.opts.min_matched_area_attempt
        accepted = None
        polish_budget = 10  # triples worth polishing (L-BFGS) at most
        for attempt in range(self.opts.max_initialization_attempts):
            if polish_budget == 0:
                break
            triple = self.rng.choice(candidates, 3, replace=False)
            gi = 0
            dm = []
            ok = True
            for si in triple:
                pts, valid = self._dense_pattern_matches(si, gi)
                if valid.sum() < self.opts.min_matched_area_attempt * n_px:
                    ok = False
                    break
                dm.append((pts, valid))
            if not ok:
                continue
            common = dm[0][1] & dm[1][1] & dm[2][1]
            n_common = int(common.sum())
            if n_common < max(24, self.opts.min_matched_area_attempt * n_px):
                continue
            frac = n_common / n_px
            if frac < min(self.opts.min_matched_area_accept, floor):
                continue
            clouds = np.stack([pts[common][:, :2] for pts, _ in dm])
            if clouds.shape[1] > 768:
                sel = self.rng.choice(clouds.shape[1], 768, replace=False)
                clouds_sub = clouds[:, sel]
            else:
                clouds_sub = clouds
            out = noncentral_planar_relative_pose(clouds_sub)
            if not out["ok"]:
                continue
            # Polish both mirror candidates geometrically and demand a
            # clean mirror pair: one right-handed (h ≈ +1), one
            # left-handed.  A near-zero normalized handedness means the
            # polish collapsed into the degenerate coincident-views
            # minimum (two similar views squashed onto common lines) —
            # retry with another triple.
            polish_budget -= 1
            states = []
            for cand in out["candidates"]:
                p3 = [
                    (cand["r0"], cand["t0"]),
                    (cand["r1"], cand["t1"]),
                    (np.eye(3), np.zeros(3)),
                ]
                p3 = self._polish_bootstrap(p3, dm)
                ps, psq, pc = self._accumulate_triple(p3, dm)
                tmp = NoncentralInitResult(
                    point_sum=ps, point_sq_sum=psq, point_count=pc,
                    image_used=[], image_tr_global=[],
                    global_tr_known_geometry=[], buffer_size=self.bsize,
                    image_size=self.image_size,
                )
                dirs, anchors, valid_f, c = tmp.line_field()
                h = _field_handedness(dirs, valid_f)
                states.append((h, p3, ps, psq, pc))
            states.sort(key=lambda s: -s[0])
            h_best = states[0][0]
            h_other = states[1][0]
            if h_best > 0.05 and h_other < 0.5 * h_best:
                accepted = (triple, states[0])
                break
        if accepted is None:
            return False
        triple, (h, poses, ps, psq, pc) = accepted

        self.point_sum, self.point_sq_sum, self.point_count = ps, psq, pc
        self.global_tr_known_geometry[0] = (np.eye(3), np.zeros(3))
        for k, si in enumerate(triple):
            # Global frame := the pattern frame (global_tr_known_geometry
            # is identity), and the camera's line set is rigid in the RS
            # solution's fixed (cloud-2) frame.  cloud2_tr_cloudk maps view
            # k's pattern coords into that camera frame, which is exactly
            # image_tr_global for view k: X_cam = R_k X_global + t_k
            # (view 2's pose is the identity).
            self.image_used[si] = True
            self.image_tr_global[si] = poses[k]
        return True

    def _accumulate_triple(self, poses, dm):
        """Per-pixel point statistics from the 3 posed bootstrap clouds."""
        ps = np.zeros_like(self.point_sum)
        psq = np.zeros_like(self.point_sq_sum)
        pc = np.zeros_like(self.point_count)
        for k in range(3):
            r_pat, t_pat = poses[k]
            pts, valid = dm[k]
            flat = pts[valid]
            glob = np.concatenate(
                [flat[:, :2], np.zeros((flat.shape[0], 1))], -1
            ) @ r_pat.T + t_pat
            ps[valid] += glob
            psq[valid] += glob[:, :, None] * glob[:, None, :]
            pc[valid] += 1
        return ps, psq, pc

    def _polish_bootstrap(self, poses, dm, max_points=2500):
        """Geometric maximum-consistency polish of the algebraic RS poses.

        Minimizes the total per-pixel line-fit residual — for each common
        pixel the sum of the two smallest eigenvalues of the scatter of
        the three posed points ("line thickness") — jointly over the two
        free poses (view 2 stays the gauge anchor), with L-BFGS and the
        exact envelope gradient (the optimal per-pixel line drops out of
        the derivative).  Plain alternation crawls along a sloppy valley
        on this objective; quasi-Newton converges in a few hundred cheap
        iterations.
        """
        from scipy.optimize import minimize

        common = dm[0][1] & dm[1][1] & dm[2][1]
        n = int(common.sum())
        if n < 24:
            return poses
        ys, xs = np.nonzero(common)
        if n > max_points:
            sel = self.rng.choice(n, max_points, replace=False)
            ys, xs = ys[sel], xs[sel]
        flats = [
            np.concatenate(
                [dm[k][0][ys, xs][:, :2], np.zeros((ys.size, 1))], -1
            )
            for k in range(3)
        ]

        def rodrigues(w):
            th = np.linalg.norm(w)
            if th < 1e-12:
                return np.eye(3)
            k = w / th
            kx = _hat_np(k)
            return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx

        def f_and_g(theta):
            r_all = [rodrigues(theta[:3]), rodrigues(theta[6:9]), np.eye(3)]
            t_all = [theta[3:6], theta[9:12], np.zeros(3)]
            x = [flats[k] @ r_all[k].T + t_all[k] for k in range(3)]
            p = np.stack(x, 1)
            m = p.mean(1)
            d = p - m[:, None]
            s = np.einsum("nki,nkj->nij", d, d)
            w_, v_ = np.linalg.eigh(s)
            f = float((w_[:, 0] + w_[:, 1]).sum())
            vtop = v_[..., -1]
            g = np.zeros(12)
            for k in range(2):
                resid = x[k] - m
                pr = resid - np.einsum(
                    "nj,nj->n", resid, vtop
                )[:, None] * vtop
                # d x / d ω = −[x]× ω  ⇒  ∂f/∂ω = 2 Σ pr·(−x×ω) =
                # −2 Σ (x × pr)... sign fixed against numeric check below
                g[6 * k:6 * k + 3] = 2.0 * np.cross(x[k], pr).sum(0)
                g[6 * k + 3:6 * k + 6] = 2.0 * pr.sum(0)
            return f, g

        def rotvec(rm):
            tr = np.clip((np.trace(rm) - 1) / 2, -1, 1)
            th = np.arccos(tr)
            if th < 1e-12:
                return np.zeros(3)
            return np.array([
                rm[2, 1] - rm[1, 2], rm[0, 2] - rm[2, 0], rm[1, 0] - rm[0, 1]
            ]) / (2 * np.sin(th)) * th

        theta0 = np.concatenate([
            rotvec(poses[0][0]), poses[0][1],
            rotvec(poses[1][0]), poses[1][1],
        ])
        res = minimize(
            f_and_g, theta0, jac=True, method="L-BFGS-B",
            options={"maxiter": 600, "ftol": 1e-16, "gtol": 1e-12},
        )
        return [
            (rodrigues(res.x[:3]), res.x[3:6]),
            (rodrigues(res.x[6:9]), res.x[9:12]),
            (np.eye(3), np.zeros(3)),
        ]

    # ---------------- incremental localization ----------------

    def _line_at(self, px_buffer, dirs, anchors, valid):
        """Bilinearly interpolated line at a subpixel buffer position
        (nearest-pixel lookup costs several degrees of pose accuracy —
        same rationale as dense_init._calibrated_bearing)."""
        bw, bh = self.bsize
        fx = px_buffer[0] - 0.5
        fy = px_buffer[1] - 0.5
        x0, y0 = int(np.floor(fx)), int(np.floor(fy))
        tx, ty = fx - x0, fy - y0
        acc_d = np.zeros(3)
        acc_m = np.zeros(3)
        wsum = 0.0
        for (xi, yi, wgt) in (
            (x0, y0, (1 - tx) * (1 - ty)),
            (x0 + 1, y0, tx * (1 - ty)),
            (x0, y0 + 1, (1 - tx) * ty),
            (x0 + 1, y0 + 1, tx * ty),
        ):
            if not (0 <= xi < bw and 0 <= yi < bh) or not valid[yi, xi]:
                continue
            acc_d += wgt * dirs[yi, xi]
            acc_m += wgt * anchors[yi, xi]
            wsum += wgt
        if wsum < 0.5:
            return None
        d = acc_d / wsum
        n = np.linalg.norm(d)
        if n < 1e-12:
            return None
        return d / n, acc_m / wsum

    def localize_image(self, imageset_index, field=None, init_pose=None):
        """Generalized-camera localization: central P3P seed (or a given
        warm-start pose) + point-to-line Gauss-Newton refinement."""
        if field is None:
            field = self.line_field_cached()
        dirs, anchors, valid, c = field
        features = self.dataset.imagesets[imageset_index].features[self.ci]
        bw, bh = self.bsize
        w, h = self.image_size
        sx, sy = bw / w, bh / h
        for gi, gpose in enumerate(self.global_tr_known_geometry):
            if gpose is None:
                continue
            geometry = self.dataset.known_geometries[gi]
            by_pos = di._features_by_position(features, geometry)
            lines, world = [], []
            for pos, px in by_pos.items():
                ln = self._line_at(
                    np.array([px[0] * sx, px[1] * sy]), dirs, anchors, valid
                )
                if ln is None:
                    continue
                r_kg, t_kg = gpose
                pat = np.array([pos[0], pos[1], 0.0]) * geometry.cell_length_in_meters
                lines.append(ln)
                world.append(r_kg @ pat + t_kg)
            if len(lines) < max(6, self.opts.min_sparse_matches):
                continue
            v = np.stack([ln[0] for ln in lines])
            m = np.stack([ln[1] for ln in lines])
            x_w = np.stack(world)
            if init_pose is not None:
                r, t = init_pose
            else:
                # central seed: bearings from the effective center
                out = ransac_p3p(
                    v, x_w, max_iterations=self.opts.ransac_iterations,
                    seed=int(self.rng.integers(1 << 31)),
                )
                if out is None:
                    continue
                r_gi, t_gi, _ = out
                r = r_gi.T
                t = -r_gi.T @ t_gi + c  # bearings were anchored at c
            # Gauss-Newton on point-to-line distances
            r, t, rms = _refine_point_to_line(r, t, x_w, v, m)
            if rms is None or rms > 0.05:
                continue
            return (r, t)
        return None

    def line_field_cached(self):
        res = NoncentralInitResult(
            point_sum=self.point_sum, point_sq_sum=self.point_sq_sum,
            point_count=self.point_count, image_used=self.image_used,
            image_tr_global=self.image_tr_global,
            global_tr_known_geometry=self.global_tr_known_geometry,
            buffer_size=self.bsize, image_size=self.image_size,
        )
        return res.line_field()

    # ---------------- full pipeline ----------------

    def alternating_refinement(self, rounds=3):
        """Rebuild the line field from all localized views and re-localize
        each of them (noncentral analog of the central pipeline's
        AlternatingBundleAdjustment, dense_initialization.cc:468-514).
        With many views the per-pixel lines become well conditioned and
        the sloppy pose modes left by the 3-view bootstrap collapse."""
        used = [si for si, u in enumerate(self.image_used) if u]
        for _ in range(rounds):
            # refit poses against the current field
            field = self.line_field_cached()
            new_poses = {}
            for si in used:
                pose = self.localize_image(
                    si, field=field, init_pose=self.image_tr_global[si]
                )
                new_poses[si] = pose or self.image_tr_global[si]
            # rebuild the accumulation from scratch with the new poses
            self.point_sum[:] = 0
            self.point_sq_sum[:] = 0
            self.point_count[:] = 0
            for si in used:
                self.image_used[si] = False
                self.update_with_image(si, new_poses[si])

    def run(self):
        if not self.attempt_bootstrap():
            return None
        n_sets = len(self.dataset.imagesets)
        progress = True
        while progress:
            progress = False
            field = self.line_field_cached()
            for si in range(n_sets):
                if self.image_used[si]:
                    continue
                pose = self.localize_image(si, field=field)
                if pose is None:
                    continue
                self.update_with_image(si, pose)
                field = self.line_field_cached()
                progress = True
        self.alternating_refinement()
        return NoncentralInitResult(
            point_sum=self.point_sum,
            point_sq_sum=self.point_sq_sum,
            point_count=self.point_count,
            image_used=self.image_used,
            image_tr_global=self.image_tr_global,
            global_tr_known_geometry=self.global_tr_known_geometry,
            buffer_size=self.bsize,
            image_size=self.image_size,
        )


def _refine_point_to_line(r, t, x_w, v, m, iterations=30):
    """GN on e_i = (I − v_i v_iᵀ)((R x_i + t) − m_i) over SE(3)."""

    def hat(a):
        return np.array([
            [0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]
        ])

    best = None
    for _ in range(iterations):
        x_c = x_w @ r.T + t
        proj = np.eye(3)[None] - v[:, :, None] * v[:, None, :]
        e = np.einsum("nij,nj->ni", proj, x_c - m)
        rms = float(np.sqrt((e ** 2).sum(1).mean()))
        if best is None or rms < best[2]:
            best = (r.copy(), t.copy(), rms)
        # jacobian wrt (ω, δt): d x_c = −[x_c]× ω + δt
        j = np.concatenate(
            [-np.einsum("nij,njk->nik", proj,
                        np.stack([hat(p) for p in x_c])),
             proj], axis=2,
        )  # (n, 3, 6)
        jf = j.reshape(-1, 6)
        ef = e.reshape(-1)
        h = jf.T @ jf + 1e-12 * np.eye(6)
        g = jf.T @ ef
        try:
            delta = np.linalg.solve(h, -g)
        except np.linalg.LinAlgError:
            break
        w_rot = delta[:3]
        angle = np.linalg.norm(w_rot)
        if angle > 1e-12:
            k = hat(w_rot / angle)
            dr = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k
        else:
            dr = np.eye(3)
        r = dr @ r
        t = t + delta[3:]
        if np.linalg.norm(delta) < 1e-12:
            break
    if best is None:
        return r, t, None
    return best

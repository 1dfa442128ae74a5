"""Dense SfM-style calibration initialization.

Capability parity with the reference's DenseInitialization (reference:
applications/camera_calibration/src/camera_calibration/
calibration_initialization/dense_initialization.{h,cc}):

1. Densify sparse pattern-corner matches to per-pixel pattern coordinates
   via per-square homographies on a ≤640×480 buffer (DensifyMatches,
   dense_initialization.cc:118-292).  Here each square's interior test is
   done in pattern space (the homography maps the quad exactly to the unit
   cell), replacing the reference's scanline rasterizer.
2. Try random image triples with the Ramalingam-Sturm central+planar
   closed-form relative pose (cc:777-…, 1263-1302); accept when ≥30% of
   the image area is matched; require ≥1% per attempt.
3. Seed the calibration: camera at the recovered optical center with
   identity rotation; per-pixel observation directions accumulated from
   the three views (InitializeFromRelativePoses, cc:972-1069).
4. Incrementally localize remaining images by P3P RANSAC against the
   growing calibration — sparse features first (≥7 calibrated matches),
   dense fallback (≥50) (AttemptToLocalizeImage, cc:1072-1168;
   LocalizePattern cc:293-…, with 15px-cell occupancy downsampling);
   accumulate directions per image (UpdateCalibrationWithImage, cc:1171);
   localize additional pattern sheets against the model (cc:408-465);
   periodic alternating re-localization "BA" (cc:468-514, every 10 images
   while < 50).

All of this is host-side orchestration over small (≤VGA) buffers in NumPy;
the square rasterizer is native C++ (``camera_calibration_torch/native``),
and the Ramalingam-Sturm solve and the P3P polish run on tensors on
``config.host_device()``.  Bundle adjustment consumes the output.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from camera_calibration_torch import native
from camera_calibration_torch.ba.dataset import Dataset
from camera_calibration_torch.config import host_device
from camera_calibration_torch.init.p3p import ransac_p3p
from camera_calibration_torch.init.relative_pose import (
    central_planar_relative_pose,
)


@dataclasses.dataclass
class DenseInitResult:
    """Per-camera initialization output (reference: dense_initialization.h:47)."""

    direction_sum: np.ndarray  # (bh, bw, 3)
    direction_count: np.ndarray  # (bh, bw) int
    image_used: list  # per imageset bool
    image_tr_global: list  # per imageset (R, t) or None — camera_tr_global
    global_tr_known_geometry: list  # per geometry (R, t) or None
    buffer_size: tuple  # (bw, bh)
    image_size: tuple  # (w, h)

    def observation_directions(self):
        """Normalized per-pixel direction image + validity mask."""
        count = np.maximum(self.direction_count, 1)[..., None]
        dirs = self.direction_sum / count
        norms = np.linalg.norm(dirs, axis=-1, keepdims=True)
        dirs = dirs / np.maximum(norms, 1e-12)
        return dirs, self.direction_count > 0


def _features_by_position(features, geometry):
    """Map integer pattern position -> pixel xy for one geometry."""
    out = {}
    for f in features:
        pos = geometry.feature_id_to_position.get(f.feature_id)
        if pos is not None:
            out[tuple(pos)] = np.asarray(f.xy, np.float64)
    return out


def _squares(features, geometry):
    """(corners (n, 4, 2) in pixels, cells (n, 2)) of the pattern squares
    whose four corners were all detected."""
    by_pos = _features_by_position(features, geometry)
    corners, cells = [], []
    for (cx, cy), p00 in by_pos.items():
        p10 = by_pos.get((cx + 1, cy))
        p11 = by_pos.get((cx + 1, cy + 1))
        p01 = by_pos.get((cx, cy + 1))
        if p10 is None or p11 is None or p01 is None:
            continue
        corners.append(np.stack([p00, p10, p11, p01]))
        cells.append((cx, cy))
    return corners, cells


def densify_matches(
    features,
    geometries,
    geometry_poses,
    buffer_size,
    image_size,
):
    """Per-pixel 3D pattern points on the downsampled buffer, rasterized by
    the native library (``native.densify_matches_native``).

    features: list of PointFeature; geometries: list of KnownGeometry;
    geometry_poses: list of (R, t) or None — global pose of each pattern
    sheet (use identity for the relative-pose stage).
    Returns (points (bh, bw, 3), valid (bh, bw)).
    """
    bw, bh = buffer_size
    w, h = image_size
    scale_x = w / bw
    scale_y = h / bh
    pts = np.full((bh, bw, 3), np.nan)
    valid_u8 = np.zeros((bh, bw), np.uint8)
    for geometry, pose in zip(geometries, geometry_poses):
        if pose is None:
            continue
        r_kg, t_kg = pose
        corners, cells = _squares(features, geometry)
        if not corners:
            continue
        native.densify_matches_native(
            np.stack(corners), np.asarray(cells, np.int64),
            geometry.cell_length_in_meters,
            np.asarray(r_kg, np.float64), np.asarray(t_kg, np.float64),
            bw, bh, scale_x, scale_y, pts, valid_u8,
        )
    return pts, valid_u8.astype(bool)


def densify_matches_plain(
    features,
    geometries,
    geometry_poses,
    buffer_size,
    image_size,
):
    """NumPy version of :func:`densify_matches` (a 9-column SVD homography
    per square and a vectorized interior test), the one the native
    rasterizer is held against."""
    bw, bh = buffer_size
    w, h = image_size
    scale_x = w / bw
    scale_y = h / bh
    pts = np.full((bh, bw, 3), np.nan)
    for geometry, pose in zip(geometries, geometry_poses):
        if pose is None:
            continue
        r_kg, t_kg = pose
        cell = geometry.cell_length_in_meters
        for corners_img, (cx, cy) in zip(*_squares(features, geometry)):
            corners_pat = np.array(
                [[cx, cy], [cx + 1, cy], [cx + 1, cy + 1], [cx, cy + 1]],
                np.float64,
            )
            # Homography image -> pattern-cell coords via direct 4-point DLT.
            h_mat = _homography_4pt(corners_img, corners_pat)
            if h_mat is None:
                continue
            # Bounding box in buffer coords.
            bx0 = max(0, int(np.floor(corners_img[:, 0].min() / scale_x)))
            bx1 = min(bw - 1, int(np.ceil(corners_img[:, 0].max() / scale_x)))
            by0 = max(0, int(np.floor(corners_img[:, 1].min() / scale_y)))
            by1 = min(bh - 1, int(np.ceil(corners_img[:, 1].max() / scale_y)))
            if bx1 < bx0 or by1 < by0:
                continue
            xs = (np.arange(bx0, bx1 + 1) + 0.5) * scale_x
            ys = (np.arange(by0, by1 + 1) + 0.5) * scale_y
            gx, gy = np.meshgrid(xs, ys)
            ones = np.ones_like(gx)
            q = np.einsum(
                "ij,jkl->ikl", h_mat, np.stack([gx, gy, ones])
            )
            pat = q[:2] / q[2:3]
            inside = (
                (pat[0] >= cx)
                & (pat[0] < cx + 1)
                & (pat[1] >= cy)
                & (pat[1] < cy + 1)
            )
            if not inside.any():
                continue
            p3 = np.stack(
                [pat[0] * cell, pat[1] * cell, np.zeros_like(pat[0])], -1
            )
            p3 = p3 @ r_kg.T + t_kg
            sub = pts[by0 : by1 + 1, bx0 : bx1 + 1]
            sub[inside] = p3[inside]
    valid = np.isfinite(pts[..., 0])
    return pts, valid


def _homography_4pt(src, dst):
    """Exact 4-point homography (2N×9 null vector), host NumPy."""
    a = []
    for (x, y), (u, v) in zip(src, dst):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    a = np.asarray(a)
    try:
        _, _, vt = np.linalg.svd(a)
    except np.linalg.LinAlgError:
        return None
    h = vt[-1].reshape(3, 3)
    if abs(h[2, 2]) < 1e-15:
        return None
    return h / h[2, 2]


@dataclasses.dataclass
class DenseInitOptions:
    max_initialization_attempts: int = 500  # reference: cc:1263
    min_matched_area_attempt: float = 0.01  # reference: cc:894
    min_matched_area_accept: float = 0.30  # reference: cc:1296
    buffer_max_width: int = 640
    buffer_max_height: int = 480
    min_sparse_matches: int = 7  # reference: cc:1072-…
    min_dense_matches: int = 50
    localization_cell_px: int = 15  # reference: cc:346 kDownsampleCellSize
    ransac_iterations: int = 10
    alternating_every: int = 10  # reference: cc:1376
    alternating_below: int = 50
    seed: int = 0


def _buffer_size(image_size, options):
    w, h = image_size
    s = max(1.0, w / options.buffer_max_width, h / options.buffer_max_height)
    return (int(round(w / s)), int(round(h / s)))


class DenseInitializer:
    """Stateful per-camera initializer (host orchestration)."""

    def __init__(self, dataset: Dataset, camera_index: int,
                 options: DenseInitOptions = DenseInitOptions()):
        self.dataset = dataset
        self.ci = camera_index
        self.opts = options
        self.image_size = dataset.image_sizes[camera_index]
        self.bsize = _buffer_size(self.image_size, options)
        bw, bh = self.bsize
        self.direction_sum = np.zeros((bh, bw, 3))
        self.direction_count = np.zeros((bh, bw), np.int64)
        n_sets = len(dataset.imagesets)
        self.image_used = [False] * n_sets
        self.image_tr_global = [None] * n_sets
        self.global_tr_known_geometry = [None] * len(dataset.known_geometries)
        self.rng = np.random.default_rng(options.seed)

    # ---------------- bootstrap from a triple ----------------

    def _dense_pattern_matches(self, imageset_index, geometry_index):
        """Densified matches of one geometry at identity pose (pattern coords).

        Memoized: the result is a pure function of the imageset's
        features (the pose is always identity here), and the bootstrap's
        RANSAC loop re-requests the same imagesets hundreds of times —
        densification was 40% of the measured warm init wall clock
        before caching.
        """
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
        out = densify_matches(
            feats, geoms, poses, self.bsize, self.image_size
        )
        cache[key] = out
        return out

    def attempt_bootstrap(self):
        """Random-triple-> Ramalingam-Sturm; returns True on success.

        (reference: cc:777-970, 1263-1302)
        """
        n_sets = len(self.dataset.imagesets)
        bw, bh = self.bsize
        n_px = bw * bh
        candidates = [
            si for si in range(n_sets)
            if len(self.dataset.imagesets[si].features[self.ci]) >= 4
        ]
        if len(candidates) < 3:
            return False
        gi = 0  # bootstrap uses the first pattern sheet
        min_attempt = self.opts.min_matched_area_attempt * n_px

        # Per-candidate densified matches once (memoized), flattened for
        # cheap per-triple indexing.
        flat = {}
        for si in candidates:
            pts, valid = self._dense_pattern_matches(si, gi)
            if valid.sum() >= min_attempt:
                flat[si] = (pts.reshape(-1, 3), valid.ravel())
        eligible = [si for si in candidates if si in flat]
        if len(eligible) < 3:
            return False

        def solve_triple(triple, idx):
            """RS solve of one triple's common pixels; None when not ok."""
            if idx.size > 512:
                idx = self.rng.choice(idx, 512, replace=False)
            clouds = np.stack([flat[si][0][idx][:, :2] for si in triple])
            out = central_planar_relative_pose(torch.as_tensor(
                clouds, dtype=torch.float64, device=host_device()))
            if not bool(out["ok"]):
                return None
            return {k: v.cpu().numpy() for k, v in out.items()}

        # Phase 1 (matches the reference's random-attempt loop,
        # cc:1263-1302): draw random triples; the RS solver only needs to
        # run when a triple clears the acceptance area, because the
        # best-so-far ranking depends ONLY on the common-pixel fraction
        # — RS-solving every rejected attempt (the previous behavior)
        # bought nothing.  Phase 2: when no triple reaches acceptance,
        # solve the scanned triples in descending-fraction order and
        # keep the first that solves — identical to solving all of them
        # and keeping the max-fraction ok one.
        scanned = {}
        accepted = None
        for attempt in range(self.opts.max_initialization_attempts):
            triple = tuple(self.rng.choice(candidates, 3, replace=False))
            if any(si not in flat for si in triple):
                continue
            key = tuple(sorted(triple))
            if key in scanned:
                continue
            common = flat[triple[0]][1] & flat[triple[1]][1] \
                & flat[triple[2]][1]
            idx = np.flatnonzero(common)
            if idx.size < max(4, min_attempt):
                continue
            frac = idx.size / n_px
            scanned[key] = (frac, triple, idx)
            if frac >= self.opts.min_matched_area_accept:
                out = solve_triple(triple, idx)
                if out is None:
                    continue
                accepted = (frac, triple, out)
                break
        if accepted is None:
            for frac, triple, idx in sorted(
                scanned.values(), key=lambda v: -v[0]
            ):
                out = solve_triple(triple, idx)
                if out is not None:
                    accepted = (frac, triple, out)
                    break
        if accepted is None:
            return False
        frac, triple, out = accepted
        dm = [self._dense_pattern_matches(si, gi) for si in triple]
        # Strict acceptance per the reference (≥30% image area, cc:1296);
        # if no triple ever reaches it, fall back to the best one found as
        # long as it clears a floor — small patterns in large images would
        # otherwise never bootstrap.
        floor = 5.0 * self.opts.min_matched_area_attempt
        if frac < min(self.opts.min_matched_area_accept, floor):
            return False

        # Global frame = pattern (cloud2) frame. Camera center at the optical
        # center with identity rotation for all three (reference cc:996).
        o = out["optical_center"]
        pattern_poses = [
            (out["r0"], out["t0"]),
            (out["r1"], out["t1"]),
            (np.eye(3), np.zeros(3)),
        ]
        self.global_tr_known_geometry[0] = (np.eye(3), np.zeros(3))
        for k, si in enumerate(triple):
            # image_tr_global = camera_tr_cloud2 ∘ cloud2_tr_cloud_k:
            # (I, −O) ∘ (R_k, t_k) = (R_k, t_k − O)
            # (reference: dense_initialization.cc:1052-1056).
            r_pat, t_pat = pattern_poses[k]
            self.image_used[si] = True
            self.image_tr_global[si] = (r_pat, t_pat - o)
            pts, valid = dm[k]
            # pattern points of view k in global coords:
            flat = pts[valid]
            glob = np.concatenate(
                [flat[:, :2], np.zeros((flat.shape[0], 1))], -1
            ) @ r_pat.T + t_pat
            dirs = glob - o
            dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
            self.direction_sum[valid] += dirs
            self.direction_count[valid] += 1
        return True

    # ---------------- incremental localization ----------------

    def _calibrated_bearing(self, px_buffer):
        """Mean direction at a subpixel buffer position (or None).

        Bilinear interpolation of the normalized direction field over the
        valid neighbors — more accurate than the reference's integer-pixel
        lookup (dense_initialization.cc:330-335), whose ~0.5 px bearing
        quantization measurably degrades the weakly-conditioned planar
        P3P localization.
        """
        bw, bh = self.bsize
        fx = px_buffer[0] - 0.5
        fy = px_buffer[1] - 0.5
        x0, y0 = int(np.floor(fx)), int(np.floor(fy))
        tx, ty = fx - x0, fy - y0
        acc = np.zeros(3)
        wsum = 0.0
        for (xi, yi, wgt) in (
            (x0, y0, (1 - tx) * (1 - ty)),
            (x0 + 1, y0, tx * (1 - ty)),
            (x0, y0 + 1, (1 - tx) * ty),
            (x0 + 1, y0 + 1, tx * ty),
        ):
            if not (0 <= xi < bw and 0 <= yi < bh):
                continue
            cnt = self.direction_count[yi, xi]
            if cnt == 0:
                continue
            d = self.direction_sum[yi, xi] / cnt
            n = np.linalg.norm(d)
            if n <= 1e-12:
                continue
            acc += wgt * (d / n)
            wsum += wgt
        if wsum < 0.5:
            return None
        n = np.linalg.norm(acc)
        return acc / n if n > 1e-12 else None

    def _calibrated_bearings(self, px):
        """Vectorized _calibrated_bearing over (N, 2) buffer positions.

        Returns (bearings (N, 3), valid (N,)); invalid rows are zero.
        """
        bw, bh = self.bsize
        px = np.asarray(px, np.float64).reshape(-1, 2)
        n = px.shape[0]
        fx = px[:, 0] - 0.5
        fy = px[:, 1] - 0.5
        x0 = np.floor(fx).astype(int)
        y0 = np.floor(fy).astype(int)
        tx = fx - x0
        ty = fy - y0
        acc = np.zeros((n, 3))
        wsum = np.zeros(n)
        for dx, dy, wgt in (
            (0, 0, (1 - tx) * (1 - ty)),
            (1, 0, tx * (1 - ty)),
            (0, 1, (1 - tx) * ty),
            (1, 1, tx * ty),
        ):
            xi = x0 + dx
            yi = y0 + dy
            inb = (xi >= 0) & (xi < bw) & (yi >= 0) & (yi < bh)
            xc = np.clip(xi, 0, bw - 1)
            yc = np.clip(yi, 0, bh - 1)
            cnt = self.direction_count[yc, xc]
            d = self.direction_sum[yc, xc] / np.maximum(cnt, 1)[:, None]
            nrm = np.linalg.norm(d, axis=-1)
            ok = inb & (cnt > 0) & (nrm > 1e-12)
            okw = np.where(ok, wgt, 0.0)
            acc += okw[:, None] * np.where(
                ok[:, None], d / np.maximum(nrm, 1e-30)[:, None], 0.0
            )
            wsum += okw
        nrm = np.linalg.norm(acc, axis=-1)
        valid = (wsum >= 0.5) & (nrm > 1e-12)
        bearings = np.where(
            valid[:, None], acc / np.maximum(nrm, 1e-30)[:, None], 0.0
        )
        return bearings, valid

    def _collect_correspondences(self, features, geometry_index, sparse=True,
                                 imageset_index=None):
        """(bearings, world points) from sparse features or dense matches."""
        bw, bh = self.bsize
        w, h = self.image_size
        sx, sy = bw / w, bh / h
        geometry = self.dataset.known_geometries[geometry_index]
        pose = self.global_tr_known_geometry[geometry_index]
        if sparse:
            by_pos = _features_by_position(features, geometry)
            if not by_pos:
                return np.zeros((0, 3)), np.zeros((0, 3))
            px_arr = np.array(
                [[px[0] * sx, px[1] * sy] for px in by_pos.values()]
            )
            pat_arr = np.array(
                [[pos[0], pos[1], 0.0] for pos in by_pos.keys()]
            ) * geometry.cell_length_in_meters
        else:
            pts, valid = self._dense_pattern_matches(
                imageset_index, geometry_index
            )
            ys, xs = np.nonzero(valid)
            if ys.size == 0:
                return np.zeros((0, 3)), np.zeros((0, 3))
            px_arr = np.stack([xs + 0.5, ys + 0.5], -1)
            pat_arr = pts[ys, xs]
        bearings_all, valid_all = self._calibrated_bearings(px_arr)
        cell = self.opts.localization_cell_px
        keep = np.zeros(px_arr.shape[0], bool)
        occupied = set()
        for i in range(px_arr.shape[0]):
            key = (int(px_arr[i, 0]) // cell, int(px_arr[i, 1]) // cell)
            if not sparse and key in occupied:
                continue
            if not valid_all[i]:
                continue
            occupied.add(key)
            keep[i] = True
        if not keep.any():
            return np.zeros((0, 3)), np.zeros((0, 3))
        bearings = bearings_all[keep]
        pat = pat_arr[keep]
        if pose is not None:
            r_kg, t_kg = pose
            world = pat @ r_kg.T + t_kg
        else:
            world = pat
        return bearings, world

    def localize_image(self, imageset_index):
        """P3P-RANSAC localization against the current calibration.

        (reference: cc:1072-1168 AttemptToLocalizeImage)
        Returns (R, t) = image_tr_global or None.
        """
        features = self.dataset.imagesets[imageset_index].features[self.ci]
        # try localized geometries, sparse first then dense
        for gi, pose in enumerate(self.global_tr_known_geometry):
            if pose is None:
                continue
            for sparse, min_n in ((True, self.opts.min_sparse_matches),
                                  (False, self.opts.min_dense_matches)):
                bearings, points = self._collect_correspondences(
                    features, gi, sparse=sparse, imageset_index=imageset_index
                )
                if bearings.shape[0] < max(3, min_n):
                    continue
                out = ransac_p3p(
                    bearings, points,
                    max_iterations=self.opts.ransac_iterations,
                    seed=int(self.rng.integers(1 << 31)),
                    device=host_device(),
                )
                if out is None:
                    continue
                r, t, inliers = out
                if inliers.sum() < max(3, min_n):
                    continue
                # (R, t) is global_tr_image (x_global = R x_cam + t);
                # invert to image_tr_global.
                return (r.T, -r.T @ t)
        return None

    def update_with_image(self, imageset_index, pose):
        """Accumulate per-pixel directions from a localized image.

        (reference: cc:1171-1192 UpdateCalibrationWithImage)
        """
        r_ig, t_ig = pose  # image_tr_global
        feats = self.dataset.imagesets[imageset_index].features[self.ci]
        geoms = self.dataset.known_geometries
        pts, valid = densify_matches(
            feats, geoms, self.global_tr_known_geometry, self.bsize,
            self.image_size,
        )
        # Directions live in the (shared) camera frame — the pixel↔ray
        # identity only holds there (reference: cc:1022-1034).
        dirs = pts[valid] @ r_ig.T + t_ig
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        self.direction_sum[valid] += dirs
        self.direction_count[valid] += 1
        self.image_used[imageset_index] = True
        self.image_tr_global[imageset_index] = pose

    def localize_additional_patterns(self, imageset_index):
        """Pose unlocalized pattern sheets from a localized image.

        (reference: cc:408-465 LocalizeAdditionalPatterns)
        """
        pose = self.image_tr_global[imageset_index]
        if pose is None:
            return
        r_ig, t_ig = pose
        center = -r_ig.T @ t_ig
        feats = self.dataset.imagesets[imageset_index].features[self.ci]
        bw, bh = self.bsize
        w, h = self.image_size
        sx, sy = bw / w, bh / h
        for gi, gpose in enumerate(self.global_tr_known_geometry):
            if gpose is not None:
                continue
            geometry = self.dataset.known_geometries[gi]
            by_pos = _features_by_position(feats, geometry)
            bearings, points = [], []
            for pos, px in by_pos.items():
                bearing = self._calibrated_bearing(
                    np.array([px[0] * sx, px[1] * sy])
                )
                if bearing is None:
                    continue
                bearings.append(bearing)
                points.append(
                    np.array([pos[0], pos[1], 0.0])
                    * geometry.cell_length_in_meters
                )
            if len(bearings) < self.opts.min_sparse_matches:
                continue
            out = ransac_p3p(
                np.stack(bearings), np.stack(points),
                max_iterations=self.opts.ransac_iterations,
                seed=int(self.rng.integers(1 << 31)),
                device=host_device(),
            )
            if out is None:
                continue
            r, t, inliers = out
            if inliers.sum() < self.opts.min_sparse_matches:
                continue
            # (r, t): x_pattern = r x_cam + t  (pattern_tr_image).
            # global_tr_kg = global_tr_image ∘ inverse(pattern_tr_image):
            # x_global = R_gi (r^T (x_pat - t)) + center... compose:
            r_gi_mat = r_ig.T
            r_gkg = r_gi_mat @ r.T
            t_gkg = center - r_gkg @ t
            self.global_tr_known_geometry[gi] = (r_gkg, t_gkg)

    def alternating_refinement(self):
        """Re-localize all used images, rebuild the accumulation.

        (reference: cc:468-514 AlternatingBundleAdjustment)
        """
        used = [si for si, u in enumerate(self.image_used) if u]
        old_sum = self.direction_sum.copy()
        old_count = self.direction_count.copy()
        self.direction_sum[:] = 0
        self.direction_count[:] = 0
        poses = {}
        # localize against the old calibration
        saved_sum, saved_count = self.direction_sum, self.direction_count
        self.direction_sum, self.direction_count = old_sum, old_count
        for si in used:
            poses[si] = self.localize_image(si)
        self.direction_sum, self.direction_count = saved_sum, saved_count
        for si in used:
            pose = poses[si] or self.image_tr_global[si]
            self.image_used[si] = False
            self.update_with_image(si, pose)

    # ---------------- full pipeline ----------------

    def _incremental_loop(self):
        """Localize unlocalized imagesets until no progress."""
        n_sets = len(self.dataset.imagesets)
        n_localized = sum(self.image_used)
        progress = True
        while progress:
            progress = False
            for si in range(n_sets):
                if self.image_used[si]:
                    continue
                pose = self.localize_image(si)
                if pose is None:
                    continue
                self.update_with_image(si, pose)
                self.localize_additional_patterns(si)
                n_localized += 1
                progress = True
                if (
                    n_localized < self.opts.alternating_below
                    and n_localized % self.opts.alternating_every == 0
                ):
                    self.alternating_refinement()

    def run(self):
        """Bootstrap + incremental localization of all imagesets.

        Returns a DenseInitResult or None on failure.
        (reference: cc:1238-1449 InitializeCamera)
        """
        if not self.attempt_bootstrap():
            return None
        while True:
            self._incremental_loop()
            # Disconnected pattern sheets: when the incremental loop
            # stalls and a known geometry was never co-visible with the
            # localized set, start a new SUBMODEL — pretend the geometry
            # is localized at identity so images seeing only it localize
            # against it (reference: MakeNewSubmodelForKnownGeometry,
            # dense_initialization.cc:1194-1205, outer loop cc:1400-1414).
            # Per-pixel direction accumulation stays valid: directions
            # are camera-frame, and each disconnected component's image
            # and sheet poses are mutually consistent.
            # Gate beyond the reference: only pose a sheet some
            # still-unlocalized image actually observes — an identity
            # pose for an unobservable sheet gains nothing and injects
            # an arbitrary frame that later mixed-sheet P3P
            # correspondences would average against.
            remaining = [
                si for si, u in enumerate(self.image_used) if not u
            ]
            unlocalized = []
            for gi, p in enumerate(self.global_tr_known_geometry):
                if p is not None:
                    continue
                geometry = self.dataset.known_geometries[gi]
                for si in remaining:
                    feats = self.dataset.imagesets[si].features[self.ci]
                    if any(
                        f.feature_id in geometry.feature_id_to_position
                        for f in feats
                    ):
                        unlocalized.append(gi)
                        break
            if not unlocalized:
                break
            self.global_tr_known_geometry[unlocalized[0]] = (
                np.eye(3), np.zeros(3),
            )
        return DenseInitResult(
            direction_sum=self.direction_sum,
            direction_count=self.direction_count,
            image_used=self.image_used,
            image_tr_global=self.image_tr_global,
            global_tr_known_geometry=self.global_tr_known_geometry,
            buffer_size=self.bsize,
            image_size=self.image_size,
        )


# ----------------------- dense-initialization cache -----------------------

def _pose_list_to_arrays(poses):
    """list[(R, t) | None] -> (valid (N,), R (N,3,3), t (N,3))."""
    n = len(poses)
    valid = np.zeros(n, bool)
    rs = np.zeros((n, 3, 3))
    ts = np.zeros((n, 3))
    for i, p in enumerate(poses):
        if p is not None:
            valid[i] = True
            rs[i] = np.asarray(p[0], np.float64)
            ts[i] = np.asarray(p[1], np.float64)
    return valid, rs, ts


def _arrays_to_pose_list(valid, rs, ts):
    return [
        (rs[i], ts[i]) if valid[i] else None for i in range(len(valid))
    ]


def save_dense_init(path, results):
    """Serialize per-camera dense-initialization results to ``path``.

    A disk cache of the initialization, so a re-run skips it.
    ``results``: one DenseInitResult (or a noncentral result with
    ``point_sum``, ``point_sq_sum`` and ``point_count``) per camera.
    Format: a single .npz with per-camera key prefixes.
    """
    import os

    blob = {"num_cameras": np.asarray(len(results))}
    for ci, res in enumerate(results):
        p = f"cam{ci}_"
        if res is None:
            blob[p + "kind"] = np.asarray("none")
            continue
        if hasattr(res, "point_sum"):  # a noncentral init result
            blob[p + "kind"] = np.asarray("noncentral")
            blob[p + "point_sum"] = res.point_sum
            blob[p + "point_sq_sum"] = res.point_sq_sum
            blob[p + "point_count"] = res.point_count
        else:
            blob[p + "kind"] = np.asarray("central")
            blob[p + "direction_sum"] = res.direction_sum
            blob[p + "direction_count"] = res.direction_count
        blob[p + "image_used"] = np.asarray(res.image_used, bool)
        v, rs, ts = _pose_list_to_arrays(res.image_tr_global)
        blob[p + "img_valid"] = v
        blob[p + "img_r"] = rs
        blob[p + "img_t"] = ts
        v, rs, ts = _pose_list_to_arrays(res.global_tr_known_geometry)
        blob[p + "geom_valid"] = v
        blob[p + "geom_r"] = rs
        blob[p + "geom_t"] = ts
        blob[p + "buffer_size"] = np.asarray(res.buffer_size)
        blob[p + "image_size"] = np.asarray(res.image_size)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    np.savez_compressed(path, **blob)


def load_dense_init(path):
    """Load results saved by save_dense_init.  Returns a list of
    per-camera DenseInitResult or NoncentralInitResult (None for a camera
    without one)."""
    with np.load(path if str(path).endswith(".npz") else str(path) + ".npz",
                 allow_pickle=False) as z:
        n = int(z["num_cameras"])
        out = []
        for ci in range(n):
            p = f"cam{ci}_"
            kind = str(z[p + "kind"])
            if kind == "none":
                out.append(None)
                continue
            common = dict(
                image_used=list(z[p + "image_used"]),
                image_tr_global=_arrays_to_pose_list(
                    z[p + "img_valid"], z[p + "img_r"], z[p + "img_t"]
                ),
                global_tr_known_geometry=_arrays_to_pose_list(
                    z[p + "geom_valid"], z[p + "geom_r"], z[p + "geom_t"]
                ),
                buffer_size=tuple(int(v) for v in z[p + "buffer_size"]),
                image_size=tuple(int(v) for v in z[p + "image_size"]),
            )
            if kind == "noncentral":
                from camera_calibration_torch.init.noncentral_init import (
                    NoncentralInitResult,
                )

                out.append(NoncentralInitResult(
                    point_sum=z[p + "point_sum"],
                    point_sq_sum=z[p + "point_sq_sum"],
                    point_count=z[p + "point_count"],
                    **common,
                ))
            else:
                out.append(DenseInitResult(
                    direction_sum=z[p + "direction_sum"],
                    direction_count=z[p + "direction_count"],
                    **common,
                ))
    return out

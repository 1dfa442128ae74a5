"""Tagged star-pattern feature detector: tag seeding + homography growth.

Capability parity with the reference's FeatureDetectorTaggedPattern
(reference: applications/camera_calibration/src/camera_calibration/
feature_detection/feature_detector_tagged_pattern.cc:215-650):

1. detect AprilTags, match them to the configured pattern sheets, seed
   corner predictions next to each tag through the tag homography
   (PredictFeaturesNextToAprilTags, cc:769);
2. grow detections in rounds: predict not-yet-detected neighbors of
   detected corners with a local homography fit to the ≥4 nearest
   detections (NormalizedDLT, cc:1235), refine all predictions of a round
   in one batched jitted call (matching stage then symmetry stage,
   cc:1483-1520), accept converged results (PredictAndDetectFeatures,
   cc:958);
3. validate: cost-quartile outlier rejection (stricter near the border,
   cc:362-445) and geometric checks — ≥2 axis-aligned neighbors and
   opposite-neighbor collinearity (cc:447-498);
4. emit PointFeatures in pixel-corner convention (+0.5) with the
   sequential per-pattern feature ids (cc:619-650).

This module is the port of the reference package's
``features/detector.py``.  The image stack and the refinement batches run
on the detector's ``device`` (the card unless the caller asks for the CPU)
in its ``dtype`` (float32 unless the caller asks for another); tag seeding,
ring predictions, validation and bookkeeping are host-side NumPy, as
there.  The detector's NumPy generator draws the sample offsets at
construction and eight sub-pixel offsets per refinement batch, in the
reference package's order, so both render the same templates.  The
refinement rows are independent and run at their own batch size: the
reference package pads them to power-of-two buckets only so that its
compiler sees few shapes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from camera_calibration_torch import config
from camera_calibration_torch.ba.dataset import PointFeature
from camera_calibration_torch.features import apriltag as at
from camera_calibration_torch.features import pattern as pat
from camera_calibration_torch.features import patch_refinement as pref
from camera_calibration_torch.features import refinement as ref


@dataclasses.dataclass
class DetectorOptions:
    window_half_size: int = 10
    num_samples: int = 512  # symmetry-stage samples per feature
    matching_fraction: float = 0.125  # reference: 1/8 of samples (cc:1483)
    refinement_type: str = "intensity"  # intensity | gradient
    max_rounds: int = 64
    # Quartile outlier rejection: Q3 + factor·IQR on refinement costs,
    # with a STRICTER factor within 2·window_half_size of the image
    # border — the refinement window overlaps the border there, so the
    # grid search cannot escape local minima as reliably (reference:
    # feature_detector_tagged_pattern.cc:396-401).
    cost_quartile_factor: float = 6.0
    cost_quartile_factor_near_border: float = 1.0
    min_axis_neighbors: int = 2  # geometric validation (cc:447-457)
    collinearity_length_ratio: float = 1.5  # cc:100-135
    collinearity_max_angle_deg: float = 5.0
    # Max angle between the perpendicular lattice direction at a feature
    # and at each of its axis neighbors (cc:500-560).
    perpendicular_max_angle_deg: float = 25.0
    seed: int = 0
    # detect_batch device-memory bound: images are processed in chunks so
    # the stacked (B, H, W) image tensor stays under this many pixels
    # (~256 MB at f32 by default)
    max_batch_pixels: int = 64 * 1024 * 1024
    # Rings per refinement batch: ring k+1 predicted from ring k's
    # PREDICTED positions (speculation) so several growth rings share one
    # batch and one read-back.  1 = strict ring-at-a-time (the reference's
    # behavior); deeper speculation re-refines more failed frontier
    # candidates than it saves batches.
    speculative_rings: int = 2


@dataclasses.dataclass
class FeatureDetection:
    position: np.ndarray  # (2,) pixel-center convention
    coord: tuple  # integer pattern coord
    cost: float


def _feature_to_tag_frame(spec: pat.PatternSpec, tag: pat.AprilTagInfo):
    """Affine map: feature coords -> tag border frame [0, 8]²."""
    # tag outer square corners at feature coords (tag.x-1, tag.y-1) ..
    # (tag.x-1+width, tag.y-1+height) (reference geometry, h:173-261)
    sx = 8.0 / tag.width
    sy = 8.0 / tag.height
    return np.array(
        [
            [sx, 0.0, -sx * (tag.x - 1)],
            [0.0, sy, -sy * (tag.y - 1)],
            [0.0, 0.0, 1.0],
        ]
    )


def _apply_h(h, pts):
    p = np.concatenate([pts, np.ones_like(pts[..., :1])], -1)
    q = p @ h.T
    return q[..., :2] / q[..., 2:3]


def _apply_h_batch(h, pts):
    """Apply per-row homographies (n,3,3) to per-row points (n,2)."""
    p = np.concatenate([pts, np.ones_like(pts[..., :1])], -1)
    q = np.einsum("nij,nj->ni", h, p)
    w = np.where(np.abs(q[..., 2:3]) > 1e-15, q[..., 2:3], 1e-15)
    return q[..., :2] / w


def _normalized_dlt_batch(src, dst):
    """Batched host DLT with Hartley normalization.

    src, dst: (n, k, 2).  Returns (h (n, 3, 3), ok (n,) bool) — one
    batched SVD instead of a Python loop per candidate, which dominates
    the growth loop on large boards).
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n, k, _ = src.shape
    cs = src.mean(1, keepdims=True)
    cd = dst.mean(1, keepdims=True)
    ss = np.sqrt(2) / np.maximum(
        np.linalg.norm(src - cs, axis=2).mean(1), 1e-12
    )
    sd = np.sqrt(2) / np.maximum(
        np.linalg.norm(dst - cd, axis=2).mean(1), 1e-12
    )
    sn = (src - cs) * ss[:, None, None]
    dn = (dst - cd) * sd[:, None, None]
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zero = np.zeros_like(x)
    one = np.ones_like(x)
    row0 = np.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    row1 = np.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1)
    a = np.concatenate([row0, row1], axis=1)  # (n, 2k, 9)
    ok = np.isfinite(a).all(axis=(1, 2))
    a = np.where(ok[:, None, None], a, 0.0)
    try:
        _, _, vt = np.linalg.svd(a)
        hn = vt[:, -1].reshape(n, 3, 3)
    except np.linalg.LinAlgError:
        hs, oks = [], []
        for i in range(n):
            try:
                _, _, vti = np.linalg.svd(a[i])
                hs.append(vti[-1].reshape(3, 3))
                oks.append(ok[i])
            except np.linalg.LinAlgError:
                hs.append(np.eye(3))
                oks.append(False)
        hn = np.stack(hs)
        ok = np.asarray(oks)
    t_s = np.zeros((n, 3, 3))
    t_s[:, 0, 0] = ss
    t_s[:, 1, 1] = ss
    t_s[:, 0, 2] = -ss * cs[:, 0, 0]
    t_s[:, 1, 2] = -ss * cs[:, 0, 1]
    t_s[:, 2, 2] = 1.0
    t_d_inv = np.zeros((n, 3, 3))
    t_d_inv[:, 0, 0] = 1.0 / sd
    t_d_inv[:, 1, 1] = 1.0 / sd
    t_d_inv[:, 0, 2] = cd[:, 0, 0]
    t_d_inv[:, 1, 2] = cd[:, 0, 1]
    t_d_inv[:, 2, 2] = 1.0
    h = np.einsum("nij,njk,nkl->nil", t_d_inv, hn, t_s)
    ok = ok & (np.abs(h[:, 2, 2]) > 1e-15) & np.isfinite(h).all(axis=(1, 2))
    h = np.where(
        ok[:, None, None], h / np.where(
            np.abs(h[:, 2:3, 2:3]) > 1e-15, h[:, 2:3, 2:3], 1.0
        ),
        np.eye(3)[None],
    )
    return h, ok


def _normalized_dlt(src, dst):
    """Host DLT with Hartley normalization (for local homographies)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    cs, cd = src.mean(0), dst.mean(0)
    ss = np.sqrt(2) / max(np.linalg.norm(src - cs, axis=1).mean(), 1e-12)
    sd = np.sqrt(2) / max(np.linalg.norm(dst - cd, axis=1).mean(), 1e-12)
    sn = (src - cs) * ss
    dn = (dst - cd) * sd
    a = []
    for (x, y), (u, v) in zip(sn, dn):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    try:
        _, _, vt = np.linalg.svd(np.asarray(a))
    except np.linalg.LinAlgError:
        return None
    hn = vt[-1].reshape(3, 3)
    t_s = np.array([[ss, 0, -ss * cs[0]], [0, ss, -ss * cs[1]], [0, 0, 1]])
    t_d_inv = np.array([[1 / sd, 0, cd[0]], [0, 1 / sd, cd[1]], [0, 0, 1]])
    h = t_d_inv @ hn @ t_s
    if abs(h[2, 2]) < 1e-15:
        return None
    return h / h[2, 2]


class FeatureDetector:
    """Detector over one or more pattern sheets.

    patterns: list of PatternSpec; the tag `index` of each sheet's tags
    identifies which sheet a detected tag belongs to.  ``device``: where
    the images and the refinement live (None: the card, raising without
    one); ``dtype``: their floating type.
    """

    def __init__(self, patterns, options: DetectorOptions = DetectorOptions(),
                 device=None, dtype=torch.float32):
        self.device = config.default_device(device)
        self.dtype = dtype
        self.patterns = patterns
        self.opts = options
        self.corner_maps = pat.corners_for_patterns(patterns)
        # tag index -> (pattern idx, tag info)
        self.tag_lookup = {}
        for pi, spec in enumerate(patterns):
            for tag in spec.tags:
                self.tag_lookup[tag.index] = (pi, tag)
        self.rng = np.random.default_rng(options.seed)
        self.sample_offsets = ref.make_sample_offsets(
            self.rng, options.window_half_size, options.num_samples
        )

    # --------------- refinement of one batch of predictions ---------------

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def _refine_batch(self, image_t, grad_t, predictions, h_locals, spec,
                      image_idx=None):
        """Refine predicted positions. Returns (positions, costs, ok) as
        host arrays.

        Intensity mode runs the patch-resident path (patch_refinement.py)
        on ``image_t``, a stacked (B, H, W) dataset batch with per-feature
        ``image_idx`` (cross-image ring batching, see detect_batch);
        gradient-pair mode runs the whole-image implementation on the
        (H, W) ``image_t`` and its (H, W, 2) gradient ``grad_t``.
        """
        opts = self.opts
        n = predictions.shape[0]
        whs = opts.window_half_size
        offs = self.sample_offsets * whs  # pixel-space window offsets
        # Map window *displacements* to pattern space through the relative
        # local homography (translation zeroed) — the template must be
        # centered exactly on the pattern feature at (0,0), NOT on the
        # (possibly wrong) prediction (reference:
        # cpu_refinement_by_symmetry.h:58-61).  All per-feature math is
        # batched NumPy (no Python loops — weak spot of round 1 on large
        # boards).
        h_rel = h_locals / h_locals[:, 2:3, 2:3]
        h_rel = h_rel.copy()
        h_rel[:, 0:2, 2] = 0.0
        det = np.linalg.det(h_rel)
        ok_h = (np.abs(det) > 1e-12) & (np.abs(np.linalg.det(h_locals)) > 1e-12)
        h_safe = np.where(ok_h[:, None, None], h_rel,
                          np.eye(3)[None])
        h_inv = np.linalg.inv(h_safe)  # (n,3,3)
        q = np.einsum("nij,sj->nsi", h_inv[:, :, :2], offs) + h_inv[:, None, :, 2]
        pattern_samples = q[..., :2] / np.where(
            np.abs(q[..., 2:3]) > 1e-12, q[..., 2:3], 1e-12
        )
        # matching stage on a subset of samples; render anti-aliased (the
        # reference uses 16x AA, cpu_refinement_by_matching.h) by averaging
        # the oracle over the pixel footprint in pattern space
        n_match = max(16, int(opts.matching_fraction * offs.shape[0]))
        sub = self.rng.uniform(-0.5, 0.5, (8, 2))
        # per-feature pattern-units-per-pixel: spectral norm of the full
        # inverse homography's 2×2 linear part (closed form)
        h_inv_full = np.linalg.inv(
            np.where(ok_h[:, None, None], h_locals, np.eye(3)[None])
        )
        m2 = h_inv_full[:, 0:2, 0:2]
        fro2 = np.sum(m2 * m2, axis=(1, 2))
        det2 = np.linalg.det(m2) ** 2
        foot = np.sqrt(
            np.maximum(0.5 * (fro2 + np.sqrt(np.maximum(
                fro2 * fro2 - 4 * det2, 0.0))), 0.0)
        )
        pts = (
            pattern_samples[:, :n_match, None, :]
            + sub[None, None, :, :] * foot[:, None, None, None]
        )
        rendered = spec.intensity(pts.reshape(-1, 2)).reshape(
            n, n_match, sub.shape[0]
        ).mean(-1)
        rendered[~ok_h] = 0.0
        if opts.refinement_type == "gradient":
            # whole-image path for the gradient-pair residual
            pos1, cost1, ok1 = ref.refine_features_matching(
                image_t,
                self._tensor(predictions),
                self._tensor(h_locals),
                self._tensor(pattern_samples[:, :n_match]),
                self._tensor(rendered),
                torch.ones((n, n_match), dtype=torch.bool,
                           device=self.device),
                whs,
            )
            pos2, cost2, ok2 = ref.refine_features_symmetry(
                grad_t,
                pos1,
                self._tensor(h_locals),
                self._tensor(pattern_samples),
                torch.ones((n, offs.shape[0]), dtype=torch.bool,
                           device=self.device),
                whs,
                use_gradient=True,
            )
            ok = (ok1 & ok2).cpu().numpy() & ok_h
            return (pos2.double().cpu().numpy(),
                    cost2.double().cpu().numpy(), ok)

        # --- patch-resident path (intensity refinement): extract ->
        # matching -> re-extract -> symmetry, one read-back of (x, y, cost,
        # ok) per batch ---
        patch = pref.patch_size_for_window(whs)
        packed = pref.refine_two_stage_patches(
            image_t,
            self._tensor(predictions),
            self._tensor(h_locals),
            self._tensor(pattern_samples[:, :n_match]),
            self._tensor(rendered),
            torch.ones((n, n_match), dtype=torch.bool, device=self.device),
            self._tensor(pattern_samples),
            torch.ones((n, offs.shape[0]), dtype=torch.bool,
                       device=self.device),
            whs,
            patch,
            torch.as_tensor(image_idx, device=self.device),
        ).double().cpu().numpy()
        ok = (packed[:, 3] > 0.5) & ok_h
        return packed[:, 0:2], packed[:, 2], ok

    # ------------------------------ detection ------------------------------

    @staticmethod
    def _prep_image(image):
        image = np.asarray(image)
        if image.dtype == np.uint8:
            image = image.astype(np.float64) / 255.0
        return image

    def _seed_predictions(self, image):
        """Host-side tag seeding: AprilTag detect + homography seeds.

        Returns a list of (pattern idx, coords, predictions, h_locals)
        (reference: PredictFeaturesNextToAprilTags,
        feature_detector_tagged_pattern.cc:769)."""
        tags = at.detect_tags(image)
        # sub-pixel refinement of each tag homography against its known
        # bitmap (the contour quads are ~1-2 px biased)
        tags = [at.refine_tag_homography(image, t) for t in tags]
        seed_batches = []
        for det in tags:
            hit = self.tag_lookup.get(det.tag_id)
            if hit is None:
                continue
            pi, tag = hit
            spec = self.patterns[pi]
            f2t = _feature_to_tag_frame(spec, tag)
            h_pat2img = det.h_tag_to_image @ f2t  # feature coords -> pixels
            # predict the ring of features around the tag
            coords = []
            for y in range(tag.y - 2, tag.y + tag.height + 1):
                for x in range(tag.x - 2, tag.x + tag.width + 1):
                    if spec.is_valid_feature_coord(x, y):
                        coords.append((x, y))
            if not coords:
                continue
            pred = _apply_h(h_pat2img, np.asarray(coords, np.float64))
            # to pixel-center convention
            pred = pred - 0.5
            h_locals = np.zeros((len(coords), 3, 3))
            for i, (cx, cy) in enumerate(coords):
                t = np.eye(3)
                t[0, 2], t[1, 2] = cx, cy
                hl = h_pat2img @ t
                # translation column in pixel-center convention
                hl = hl / hl[2, 2]
                hl[0:2, 2] = pred[i]
                h_locals[i] = hl
            seed_batches.append((pi, coords, pred, h_locals))
        return seed_batches

    # board-space neighbor offsets out to Chebyshev radius 4, sorted by
    # euclidean distance — the 12 nearest detections of a frontier
    # candidate live in this window, so the global candidate×detection
    # distance matrix (O(n²) over the whole detection run) collapses to a
    # handful of dict probes per candidate
    _WINDOW_OFFSETS = tuple(sorted(
        ((dx, dy) for dx in range(-4, 5) for dy in range(-4, 5)
         if (dx, dy) != (0, 0)),
        key=lambda o: (o[0] * o[0] + o[1] * o[1], o),
    ))

    def _ring_predictions(self, dets, spec, w_img, h_img, pool=None):
        """Next growth ring of one pattern in one image.

        ``pool``: candidate coords to try (maintained incrementally by the
        caller); None derives it from all current detections (one-shot
        use).  Returns (predictions, h_locals, kept coord list) or None
        (reference: PredictAndDetectFeatures,
        feature_detector_tagged_pattern.cc:958, local homographies from
        the nearest detections via NormalizedDLT :1235)."""
        if len(dets) < 4:
            return None
        if pool is None:
            pool = set()
            for (cx, cy) in dets.keys():
                for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    nb = (cx + dx, cy + dy)
                    if nb not in dets and spec.is_valid_feature_coord(*nb):
                        pool.add(nb)
        if not pool:
            return None
        cand = sorted(pool)
        # nearest detections per candidate from the board-space window;
        # rare sparse candidates (<4 neighbors in radius 4) are skipped
        # this round — they re-enter once the frontier reaches them
        k = 12
        kept_cand, nbr_coords, nbr_pos = [], [], []
        for c in cand:
            cx, cy = c
            found_c, found_p = [], []
            for dx, dy in self._WINDOW_OFFSETS:
                d = dets.get((cx + dx, cy + dy))
                if d is not None:
                    found_c.append((cx + dx, cy + dy))
                    found_p.append(d.position)
                    if len(found_c) == k:
                        break
            if len(found_c) < 4:
                continue
            n0 = len(found_c)
            while len(found_c) < k:  # pad by cycling (weights the DLT)
                found_c.append(found_c[len(found_c) % n0])
                found_p.append(found_p[len(found_p) % n0])
            kept_cand.append(c)
            nbr_coords.append(found_c)
            nbr_pos.append(found_p)
        if not kept_cand:
            return None
        cand = kept_cand
        cand_arr = np.asarray(cand, np.float64)
        h_loc, ok_h = _normalized_dlt_batch(
            np.asarray(nbr_coords, np.float64),
            np.asarray(nbr_pos, np.float64),
        )
        p = _apply_h_batch(h_loc, cand_arr)
        whs = self.opts.window_half_size
        inb = (
            ok_h
            & (p[:, 0] > whs) & (p[:, 0] < w_img - 1 - whs)
            & (p[:, 1] > whs) & (p[:, 1] < h_img - 1 - whs)
        )
        if not inb.any():
            return None
        idx = np.nonzero(inb)[0]
        t = np.tile(np.eye(3), (idx.size, 1, 1))
        t[:, 0, 2] = cand_arr[idx, 0]
        t[:, 1, 2] = cand_arr[idx, 1]
        hl = np.einsum("nij,njk->nik", h_loc[idx], t)
        hl = hl / hl[:, 2:3, 2:3]
        hl[:, 0:2, 2] = p[idx]
        return p[idx], hl, [cand[i] for i in idx]

    def _speculative_rings(self, dets, spec, w_img, h_img, pool):
        """Ring 1 from real detections plus up to speculative_rings-1
        further rings predicted from the previous ring's *predicted*
        positions, concatenated for a single device call.

        Returns (predictions, h_locals, kept coords) or None."""
        ring = self._ring_predictions(dets, spec, w_img, h_img, pool=pool)
        if ring is None:
            return None
        depth = max(1, int(self.opts.speculative_rings))
        if depth == 1:
            return ring
        collected = [ring]
        spec_dets = None
        spec_pool = None
        for _ in range(depth - 1):
            preds, _hl, kept = collected[-1]
            if spec_dets is None:
                spec_dets = dict(dets)
                spec_pool = set(pool)
            for k, c in enumerate(kept):
                spec_dets[c] = FeatureDetection(
                    position=preds[k], coord=c, cost=0.0
                )
            spec_pool.difference_update(kept)
            for (cx, cy) in kept:
                for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    nb = (cx + dx, cy + dy)
                    if nb not in spec_dets and spec.is_valid_feature_coord(*nb):
                        spec_pool.add(nb)
            nxt = self._ring_predictions(
                spec_dets, spec, w_img, h_img, pool=spec_pool
            )
            if nxt is None:
                break
            collected.append(nxt)
        if len(collected) == 1:
            return ring
        preds = np.concatenate([r[0] for r in collected])
        hls = np.concatenate([r[1] for r in collected])
        kept = [c for r in collected for c in r[2]]
        return preds, hls, kept

    def _flat_features(self, detections):
        """Per-pattern detection dicts -> PointFeature list (pixel-corner
        convention, sequential feature ids)."""
        features = []
        for pi, dets in enumerate(detections):
            coord_to_fid = {
                coord: fid for fid, coord in self.corner_maps[pi].items()
            }
            for coord, det in dets.items():
                fid = coord_to_fid.get(coord)
                if fid is None:
                    continue
                features.append(
                    PointFeature(xy=det.position + 0.5, feature_id=fid)
                )
        return features

    def detect(self, image):
        """Detect features. image: grayscale (H, W) float [0,1] or uint8.

        Returns a list of per-pattern dicts {coord: FeatureDetection} plus
        the flat PointFeature list (pixel-corner convention, sequential
        feature ids).
        """
        if self.opts.refinement_type == "gradient":
            return self._detect_gradient(image)
        return self.detect_batch([image])[0]

    def detect_batch(self, images):
        """Detect features in several same-size images jointly.

        Growth rings of different images are independent, so each round's
        candidates from ALL images are refined in ONE batch — the per-ring
        launch and read-back latency (the sequential bottleneck of large
        boards) amortizes across the dataset instead of repeating per
        image.  This is the batch analog of the reference's real-time
        per-image GPU detection (Readme.md:42,188-189).

        Returns a list of (features, per-pattern detection dicts), one
        per image, identical in layout to detect().
        """
        if self.opts.refinement_type == "gradient":
            return [self._detect_gradient(img) for img in images]
        prepped = [self._prep_image(img) for img in images]
        if len({im.shape for im in prepped}) != 1:
            raise ValueError("detect_batch needs same-size images")
        # bound device memory: chunk the batch so the stacked image tensor
        # stays under ~max_batch_pixels (the rest of the pipeline is
        # per-feature and small)
        px_per = prepped[0].size
        per_chunk = max(1, int(self.opts.max_batch_pixels // px_per))
        if len(prepped) > per_chunk:
            out = []
            for s in range(0, len(prepped), per_chunk):
                out.extend(self.detect_batch(prepped[s:s + per_chunk]))
            return out
        h_img, w_img = prepped[0].shape
        n_img = len(prepped)
        images_t = self._tensor(np.stack(prepped))
        all_dets = [
            [dict() for _ in self.patterns] for _ in range(n_img)
        ]

        # --- 1. tag seeding (host, per image, thread pool: the AprilTag
        # decode is NumPy/OpenCV and dominated by GIL-releasing cv2 calls)
        # + one refine per pattern ---
        from concurrent.futures import ThreadPoolExecutor

        if n_img > 1:
            with ThreadPoolExecutor(min(4, n_img)) as ex:
                seeds = list(ex.map(self._seed_predictions, prepped))
        else:
            seeds = [self._seed_predictions(prepped[0])]
        per_pattern = {pi: [] for pi in range(len(self.patterns))}
        for bi, seed_batches in enumerate(seeds):
            for pi, coords, pred, h_locals in seed_batches:
                whs = self.opts.window_half_size
                inb = (
                    (pred[:, 0] > whs) & (pred[:, 0] < w_img - 1 - whs)
                    & (pred[:, 1] > whs) & (pred[:, 1] < h_img - 1 - whs)
                )
                if inb.any():
                    idx = np.nonzero(inb)[0]
                    per_pattern[pi].append(
                        (bi, [coords[i] for i in idx], pred[idx],
                         h_locals[idx])
                    )
        # candidate pools, maintained incrementally: pool = all valid
        # undetected neighbors of current detections (exactly the per-round
        # candidate set of the one-shot form, without the O(n²) rebuild)
        pools = [
            [set() for _ in self.patterns] for _ in range(n_img)
        ]
        new_map = self._refine_scatter(per_pattern, images_t, all_dets)
        self._update_pools(pools, all_dets, new_map)

        # --- 2. growth rounds: all images' rings in one call per pattern.
        # Each round additionally SPECULATES speculative_rings-1 rings
        # ahead: ring k+1 candidates are predicted from ring k's
        # *predicted* (pre-refinement) positions, so one batch carries
        # several rings — the loop is bound by the batches' launches and
        # read-backs, and prediction error stays well inside the
        # refinement window (the refinement is a local solve; a wrong
        # speculative start either converges to the true corner or fails
        # its convergence/validation checks). ---
        ring_pool = ThreadPoolExecutor(min(4, n_img)) if n_img > 1 else None
        try:
            for _ in range(self.opts.max_rounds):
                per_pattern = {pi: [] for pi in range(len(self.patterns))}
                any_ring = False
                tasks = [
                    (bi, pi, spec)
                    for bi in range(n_img)
                    for pi, spec in enumerate(self.patterns)
                ]
                if ring_pool is not None:
                    # per-image ring building is independent host work
                    # (board-space pools + batched NumPy DLTs release the
                    # GIL); serial it was ~40% of batch wall time
                    ring_results = list(ring_pool.map(
                        lambda t: self._speculative_rings(
                            all_dets[t[0]][t[1]], t[2], w_img, h_img,
                            pools[t[0]][t[1]],
                        ),
                        tasks,
                    ))
                else:
                    ring_results = [
                        self._speculative_rings(
                            all_dets[bi][pi], spec, w_img, h_img,
                            pools[bi][pi],
                        )
                        for bi, pi, spec in tasks
                    ]
                for (bi, pi, _spec), rings in zip(tasks, ring_results):
                    if rings is not None:
                        preds, hl, kept = rings
                        per_pattern[pi].append((bi, kept, preds, hl))
                        any_ring = True
                if not any_ring:
                    break
                new_map = self._refine_scatter(per_pattern, images_t, all_dets)
                if not new_map:
                    break
                self._update_pools(pools, all_dets, new_map)
        finally:
            if ring_pool is not None:
                ring_pool.shutdown()

        # --- 3/4. validation + flat outputs, per image ---
        results = []
        for bi in range(n_img):
            dets_img = [
                self._validate(d, (w_img, h_img)) for d in all_dets[bi]
            ]
            results.append((self._flat_features(dets_img), dets_img))
        return results

    def _refine_scatter(self, per_pattern, images_t, all_dets):
        """Refine each pattern's concatenated cross-image batch in one
        device call and scatter accepted detections back.

        Returns {(image idx, pattern idx): [accepted coords]} (empty dict
        when nothing new was detected)."""
        new_map = {}
        for pi, batches in per_pattern.items():
            if not batches:
                continue
            spec = self.patterns[pi]
            preds = np.concatenate([b[2] for b in batches])
            hls = np.concatenate([b[3] for b in batches])
            image_idx = np.concatenate([
                np.full(len(b[1]), b[0], np.int32) for b in batches
            ])
            pos, cost, ok = self._refine_batch(
                images_t, None, preds, hls, spec, image_idx=image_idx
            )
            off = 0
            for bi, kept, p_, h_ in batches:
                for k, c in enumerate(kept):
                    if ok[off + k]:
                        all_dets[bi][pi][c] = FeatureDetection(
                            position=pos[off + k], coord=c,
                            cost=float(cost[off + k]),
                        )
                        new_map.setdefault((bi, pi), []).append(c)
                off += len(kept)
        return new_map

    def _update_pools(self, pools, all_dets, new_map):
        """Incremental candidate-pool maintenance: drop what was just
        detected, add the newly-detected coords' valid undetected
        neighbors."""
        for (bi, pi), new_coords in new_map.items():
            pool = pools[bi][pi]
            dets = all_dets[bi][pi]
            spec = self.patterns[pi]
            pool.difference_update(new_coords)
            for (cx, cy) in new_coords:
                for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    nb = (cx + dx, cy + dy)
                    if nb not in dets and spec.is_valid_feature_coord(*nb):
                        pool.add(nb)

    def _detect_gradient(self, image):
        """Single-image path for the gradient-pair refinement type (uses
        whole-image sampling; not cross-image batched)."""
        image = self._prep_image(image)
        h_img, w_img = image.shape
        image_t = self._tensor(image)
        # central differences (np.gradient is much slower: it allocates
        # per-axis slices through a generic ufunc path)
        gx = np.empty_like(image)
        gx[:, 1:-1] = 0.5 * (image[:, 2:] - image[:, :-2])
        gx[:, 0] = image[:, 1] - image[:, 0]
        gx[:, -1] = image[:, -1] - image[:, -2]
        gy = np.empty_like(image)
        gy[1:-1, :] = 0.5 * (image[2:, :] - image[:-2, :])
        gy[0, :] = image[1, :] - image[0, :]
        gy[-1, :] = image[-1, :] - image[-2, :]
        grad_t = self._tensor(np.stack([gx, gy], axis=-1))

        detections = [dict() for _ in self.patterns]

        for pi, coords, pred, h_locals in self._seed_predictions(image):
            spec = self.patterns[pi]
            whs = self.opts.window_half_size
            inb = (
                (pred[:, 0] > whs) & (pred[:, 0] < w_img - 1 - whs)
                & (pred[:, 1] > whs) & (pred[:, 1] < h_img - 1 - whs)
            )
            if not inb.any():
                continue
            idx = np.nonzero(inb)[0]
            pos, cost, ok = self._refine_batch(
                image_t, grad_t, pred[idx], h_locals[idx], spec
            )
            for k, i in enumerate(idx):
                if ok[k]:
                    detections[pi][tuple(coords[i])] = FeatureDetection(
                        position=pos[k], coord=tuple(coords[i]),
                        cost=float(cost[k]),
                    )

        for _ in range(self.opts.max_rounds):
            new_any = False
            for pi, spec in enumerate(self.patterns):
                ring = self._ring_predictions(
                    detections[pi], spec, w_img, h_img
                )
                if ring is None:
                    continue
                preds, hl, kept = ring
                pos, cost, ok = self._refine_batch(
                    image_t, grad_t, preds, hl, spec
                )
                for k, c in enumerate(kept):
                    if ok[k]:
                        detections[pi][c] = FeatureDetection(
                            position=pos[k], coord=c, cost=float(cost[k])
                        )
                        new_any = True
            if not new_any:
                break

        detections = [
            self._validate(d, (w_img, h_img)) for d in detections
        ]
        return self._flat_features(detections), detections

    # ------------------------------ validation ------------------------------

    def _validate(self, dets, image_size):
        """Outlier + geometric validation of one pattern's detections.

        Deletion-pass parity with the reference (reference:
        feature_detector_tagged_pattern.cc:362-560): quartile cost
        threshold with a stricter factor near the image border, ≥2 axis
        neighbors, opposite-neighbor angle/length collinearity (failure
        deletes the whole triple — any of the three could be the
        outlier), a feature with no testable direction is unvalidated
        and deleted, and perpendicular-direction consistency (≤25°
        between the perpendicular lattice direction at a feature and at
        each axis neighbor).  All passes loop until nothing changes
        (cc:411-414) — implemented as a vectorized parallel fixed point
        over the board lattice (all checks evaluated on each pass's
        snapshot, flagged features deleted together; the perpendicular
        pass deletes one element per failing pair, mirroring the
        reference's delete-the-current-center semantics).  The stable
        set matches the reference's sequential in-pass deletions on all
        tested boards; pathological lattices could differ at the margin
        since the snapshot order is not the map-iteration order.
        """
        opts = self.opts
        if len(dets) < 5:
            # too few detections to estimate a cost threshold (cc:368-371)
            return {}
        coords = np.asarray(list(dets.keys()), np.int64)  # (n, 2) x,y
        pos_l = np.stack([d.position for d in dets.values()])
        cost_l = np.asarray([d.cost for d in dets.values()])
        csort = np.sort(cost_l)
        n = csort.size
        q1 = csort[min(n - 1, int(0.25 * n + 0.5))]
        q3 = csort[min(n - 1, int(0.75 * n + 0.5))]
        iqr = q3 - q1
        thr_global = q3 + opts.cost_quartile_factor * iqr
        thr_border = q3 + opts.cost_quartile_factor_near_border * iqr
        w_img, h_img = image_size
        margin = 2 * opts.window_half_size
        cos_perp = np.cos(np.radians(opts.perpendicular_max_angle_deg))
        cos_opp = np.cos(np.radians(180.0 - opts.collinearity_max_angle_deg))

        # Board-lattice arrays, padded by 2 so ±1/±2 shifts are views.
        off = coords.min(axis=0)
        bw = coords[:, 0].max() - off[0] + 1
        bh = coords[:, 1].max() - off[1] + 1
        pad = 2
        present = np.zeros((bh + 2 * pad, bw + 2 * pad), bool)
        pos = np.zeros((bh + 2 * pad, bw + 2 * pad, 2))
        cost = np.full((bh + 2 * pad, bw + 2 * pad), np.inf)
        iy = coords[:, 1] - off[1] + pad
        ix = coords[:, 0] - off[0] + pad
        present[iy, ix] = True
        pos[iy, ix] = pos_l
        cost[iy, ix] = cost_l

        def sh(a, dx, dy):
            """View of a shifted by (dx, dy): out[y, x] = a[y+dy, x+dx]."""
            return a[pad + dy:a.shape[0] - pad + dy,
                     pad + dx:a.shape[1] - pad + dx]

        core = (slice(pad, bh + pad), slice(pad, bw + pad))
        dirs4 = ((1, 0), (-1, 0), (0, 1), (0, -1))

        near_border = (
            (pos[..., 0] < margin) | (pos[..., 1] < margin)
            | (pos[..., 0] > w_img - 1 - margin)
            | (pos[..., 1] > h_img - 1 - margin)
        )
        cost_bad = cost > np.where(near_border, thr_border, thr_global)

        def opp_fail(v1, v2):
            """Triple-collinearity failure of the two vectors leaving the
            middle feature (length ratio > 1.5 or > 5° off antiparallel,
            CheckOppositeAngleAndLengthCriterion, cc:100-135)."""
            l1 = np.linalg.norm(v1, axis=-1)
            l2 = np.linalg.norm(v2, axis=-1)
            tiny = np.minimum(l1, l2) <= 1e-9
            with np.errstate(invalid="ignore", divide="ignore"):
                ratio = np.maximum(l1, l2) / np.maximum(
                    np.minimum(l1, l2), 1e-30
                )
                cosang = np.sum(v1 * v2, -1) / np.maximum(l1 * l2, 1e-30)
            return tiny | (ratio > opts.collinearity_length_ratio) | (
                cosang > cos_opp
            )

        while True:
            p_core = present[core]
            if not p_core.any():
                break
            delete = np.zeros_like(present)

            # 1. quartile cost (border-strict)
            delete[core] |= p_core & cost_bad[core]

            # 2. < min_axis_neighbors
            nnb = sum(sh(present, dx, dy).astype(np.int8)
                      for dx, dy in dirs4)
            delete[core] |= p_core & (nnb < opts.min_axis_neighbors)

            # 3. opposite triples along each direction: center c with
            # mid=c+d, far=c+2d; failure deletes all three, and a center
            # with no testable direction is unvalidated -> deleted
            validated = np.zeros_like(p_core)
            for dx, dy in dirs4:
                have = (p_core & sh(present, dx, dy)
                        & sh(present, 2 * dx, 2 * dy))
                v1 = pos[core] - sh(pos, dx, dy)
                v2 = sh(pos, 2 * dx, 2 * dy) - sh(pos, dx, dy)
                fail = have & opp_fail(v1, v2)
                validated |= have & ~fail
                delete[core] |= fail
                # flag mid (c+d) and far (c+2d) of failing centers
                fy, fx = np.nonzero(fail)
                delete[fy + pad + dy, fx + pad + dx] = True
                delete[fy + pad + 2 * dy, fx + pad + 2 * dx] = True
            delete[core] |= p_core & ~validated

            # 4. perpendicular-direction consistency: the cross-lattice
            # chord at c vs at each axis neighbor must agree within 25°.
            # Chord = (pos[c+perp]−pos[c]) − (pos[c−perp]−pos[c]) with
            # one-sided fallbacks; two distinct chord axes.
            for axis, (px_, py_) in (("v", (0, 1)), ("h", (1, 0))):
                p1 = sh(present, px_, py_)
                p2 = sh(present, -px_, -py_)
                defined = (p1 | p2) & p_core
                v = np.where(
                    p1[..., None], sh(pos, px_, py_) - pos[core], 0.0
                ) - np.where(
                    p2[..., None], sh(pos, -px_, -py_) - pos[core], 0.0
                )
                nv = np.linalg.norm(v, axis=-1, keepdims=True)
                v = np.where(nv > 1e-12, v / np.maximum(nv, 1e-30), 0.0)
                chord = np.zeros_like(pos)
                chord[core] = v
                cdef = np.zeros_like(present)
                cdef[core] = defined & (nv[..., 0] > 1e-12)
                # neighbors along the directions PERPENDICULAR to the
                # chord axis (chord "v" validates horizontal neighbors).
                # The reference's sequential loop deletes ONLY the current
                # center on failure (feature_detector_tagged_pattern.cc:
                # 600-612) — the neighbor then no longer finds it in the
                # map and survives unless it independently fails.  The
                # vectorized pass mirrors that by deleting only the
                # scan-order-first element of each failing pair; the
                # fixed point re-evaluates the survivor next iteration.
                for dx, dy in ((py_, px_), (-py_, -px_)):
                    if not (dy > 0 or (dy == 0 and dx > 0)):
                        continue  # pair handled from its first element
                    both = (p_core & sh(present, dx, dy)
                            & cdef[core] & sh(cdef, dx, dy))
                    dot = np.sum(chord[core] * sh(chord, dx, dy), -1)
                    delete[core] |= both & (dot < cos_perp)

            delete &= present
            if not delete.any():
                break
            present &= ~delete
            cost[delete] = np.inf

        keep_core = present[core]
        out = {}
        for k, (cx, cy) in enumerate(coords):
            if keep_core[cy - off[1], cx - off[0]]:
                c = (int(cx), int(cy))
                out[c] = dets[c]
        return out

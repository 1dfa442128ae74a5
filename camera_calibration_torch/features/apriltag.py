"""AprilTag (tag36h11) detection: quad extraction + code decoding.

Functional replacement for the reference's vendored AprilTag C library
(reference: applications/camera_calibration/third_party/apriltag, used by
feature_detector_tagged_pattern.cc:316 apriltag_detector_detect): the
calibration detector only needs tag ids + corner positions to seed
feature prediction next to the tags.

Pipeline (host-side; OpenCV for the image-processing primitives):
1. adaptive threshold -> binary image;
2. contour extraction + polygon approximation -> candidate quads;
3. per-quad homography to the canonical 8×8 border frame, bilinear
   sampling of data cells, black/white classification against
   border/field references;
4. decode against the tag36h11 code table over 4 rotations with a
   Hamming tolerance.

Corner order convention: detection.corners are the four outer black
border corners in counter-clockwise order in tag coordinates, starting
at tag coordinate (0, 0) = top-left of the canonical (unrotated) tag.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from camera_calibration_torch.features import tag36h11_data as fam


@dataclasses.dataclass
class TagDetection:
    tag_id: int
    hamming: int
    corners: np.ndarray  # (4, 2) pixel-corner convention, CCW from tag (0,0)
    center: np.ndarray  # (2,)
    h_tag_to_image: np.ndarray  # (3,3): tag border frame [0,8]² -> pixels


def _quad_candidates(gray, min_area=64.0, max_area_frac=0.6):
    import cv2

    img8 = np.clip(gray * 255.0, 0, 255).astype(np.uint8) if gray.dtype != np.uint8 else gray
    img8 = cv2.GaussianBlur(img8, (3, 3), 0.8)  # noise suppression
    h, w = img8.shape
    block = max(15, (min(h, w) // 16) | 1)
    thresh = cv2.adaptiveThreshold(
        img8, 255, cv2.ADAPTIVE_THRESH_MEAN_C, cv2.THRESH_BINARY_INV, block, 8
    )
    contours, _ = cv2.findContours(
        thresh, cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE
    )
    quads = []
    max_area = max_area_frac * h * w
    for c in contours:
        area = cv2.contourArea(c)
        if area < min_area or area > max_area:
            continue
        # Try the raw contour first, then its convex hull (immune to
        # jagged/eroded edges); first 4-vertex convex fit wins.
        hull = cv2.convexHull(c)
        found = False
        for poly in (c, hull):
            peri = cv2.arcLength(poly, True)
            for eps_frac in (0.02, 0.04, 0.07, 0.1):
                approx = cv2.approxPolyDP(poly, eps_frac * peri, True)
                if approx.shape[0] == 4 and cv2.isContourConvex(approx):
                    quads.append(approx[:, 0, :].astype(np.float64))
                    found = True
                    break
            if found:
                break
    return quads


def _order_ccw(quad):
    """Counter-clockwise in image coords (y down => signed area > 0)."""
    a = 0.0
    for i in range(4):
        x0, y0 = quad[i]
        x1, y1 = quad[(i + 1) % 4]
        a += x0 * y1 - x1 * y0
    return quad if a > 0 else quad[::-1].copy()


def _homography_4pt(src, dst):
    a = []
    for (x, y), (u, v) in zip(src, dst):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    _, _, vt = np.linalg.svd(np.asarray(a))
    h = vt[-1].reshape(3, 3)
    return h / h[2, 2]


def _sample_grid(gray, h_tag_to_image, n=10, offset=-1.0):
    """Sample an n×n grid of cell centers in the tag frame.

    The tag border frame spans [0, 8]²; with n=10/offset=-1 the samples
    cover the full 10×10 tag including the outer white ring.
    """
    coords = offset + 0.5 + np.arange(n, dtype=np.float64)
    gx, gy = np.meshgrid(coords, coords)
    pts = np.stack([gx, gy, np.ones_like(gx)])
    q = np.einsum("ij,jkl->ikl", h_tag_to_image, pts)
    px = q[0] / q[2]
    py = q[1] / q[2]
    h, w = gray.shape
    # bilinear sample (pixel-corner convention: subtract 0.5 for centers)
    x = np.clip(px - 0.5, 0, w - 1.001)
    y = np.clip(py - 0.5, 0, h - 1.001)
    x0 = np.clip(np.floor(x).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(int), 0, h - 2)
    tx = x - x0
    ty = y - y0
    v = (
        gray[y0, x0] * (1 - tx) * (1 - ty)
        + gray[y0, x0 + 1] * tx * (1 - ty)
        + gray[y0 + 1, x0] * (1 - tx) * ty
        + gray[y0 + 1, x0 + 1] * tx * ty
    )
    inb = (px >= 0.5) & (px < w - 0.5) & (py >= 0.5) & (py < h - 0.5)
    return v, inb


def _bits_from_cells(cells):
    """36-bit code from an 8×8 cell grid (1 = white)."""
    code = 0
    for i in range(fam.NBITS):
        bit = cells[fam.BIT_Y[i], fam.BIT_X[i]]
        code = (code << 1) | int(bit)
    return code


def _hamming(a, b):
    return (a ^ b).bit_count()


_CODES_ARR = None


def _codes_array():
    """fam.CODES as a (587, 36) uint8 bit matrix for vectorized hamming."""
    global _CODES_ARR
    if _CODES_ARR is None:
        codes = np.asarray(fam.CODES, dtype=np.uint64)
        shifts = np.arange(fam.NBITS - 1, -1, -1, dtype=np.uint64)
        _CODES_ARR = ((codes[:, None] >> shifts[None, :]) & 1).astype(np.uint8)
    return _CODES_ARR


def _best_code_match(code: int):
    """(hamming distance, tag id) of the nearest family code."""
    bits = np.asarray(
        [(code >> s) & 1 for s in range(fam.NBITS - 1, -1, -1)], np.uint8
    )
    dists = np.count_nonzero(_codes_array() != bits[None, :], axis=1)
    tid = int(np.argmin(dists))
    return int(dists[tid]), tid


_TAG_CORNERS = np.array([[0.0, 0.0], [8.0, 0.0], [8.0, 8.0], [0.0, 8.0]])


def _homography_4pt_batch(src, dst):
    """Batched 4-point homographies: src (4,2) shared, dst (Q,4,2)."""
    q = dst.shape[0]
    a = np.zeros((q, 8, 9))
    ones = np.ones(q)
    zeros = np.zeros(q)
    for i, (x, y) in enumerate(src):
        u = dst[:, i, 0]
        v = dst[:, i, 1]
        a[:, 2 * i] = np.stack(
            [x * ones, y * ones, ones, zeros, zeros, zeros,
             -u * x, -u * y, -u], -1
        )
        a[:, 2 * i + 1] = np.stack(
            [zeros, zeros, zeros, x * ones, y * ones, ones,
             -v * x, -v * y, -v], -1
        )
    _, _, vt = np.linalg.svd(a)
    hh = vt[:, -1].reshape(q, 3, 3)
    den = hh[:, 2:3, 2:3]
    den = np.where(np.abs(den) > 1e-12, den, 1e-12)
    return hh / den


def _sample_grid_batch(gray, hs, n=10, offset=-1.0):
    """Batched _sample_grid: hs (Q,3,3) → (grid (Q,n,n), all-in-bounds (Q,))."""
    coords = offset + 0.5 + np.arange(n, dtype=np.float64)
    gx, gy = np.meshgrid(coords, coords)
    pts = np.stack([gx.ravel(), gy.ravel(), np.ones(n * n)])  # (3, S)
    qp = hs @ pts  # (Q, 3, S)
    den = np.where(np.abs(qp[:, 2]) > 1e-12, qp[:, 2], 1e-12)
    px = qp[:, 0] / den
    py = qp[:, 1] / den
    h, w = gray.shape
    x = np.clip(px - 0.5, 0, w - 1.001)
    y = np.clip(py - 0.5, 0, h - 1.001)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, h - 2)
    tx = x - x0
    ty = y - y0
    flat = gray.ravel()
    i00 = y0 * w + x0
    v00 = flat[i00]
    v10 = flat[i00 + 1]
    v01 = flat[i00 + w]
    v11 = flat[i00 + w + 1]
    top = v00 + tx * (v10 - v00)
    bot = v01 + tx * (v11 - v01)
    v = top + ty * (bot - top)
    inb = (
        (px >= 0.5) & (px < w - 0.5) & (py >= 0.5) & (py < h - 0.5)
    ).all(axis=1)
    return v.reshape(-1, n, n), inb


_BORDER_MASK = np.zeros((10, 10), bool)
_BORDER_MASK[1, 1:9] = True
_BORDER_MASK[8, 1:9] = True
_BORDER_MASK[1:9, 1] = True
_BORDER_MASK[1:9, 8] = True
_OUTER_MASK = np.zeros((10, 10), bool)
_OUTER_MASK[0, :] = True
_OUTER_MASK[-1, :] = True
_OUTER_MASK[:, 0] = True
_OUTER_MASK[:, -1] = True


def detect_tags(
    gray,
    max_hamming: int = 1,
    decode_sharpen: bool = True,
):
    """Detect tag36h11 tags in a grayscale image (float [0,1] or uint8).

    Returns a list of TagDetection (pixel-corner convention corners).

    The whole candidate pipeline is batched over the Q contour quads
    (one cornerSubPix call, one batched SVD, one batched grid sample, one
    (Q, 4 rot, 587 codes) hamming table) — a star-pattern image produces
    thousands of false quad candidates, and a per-quad loop pays Python's
    overhead for each.
    """
    gray = np.asarray(gray)
    if gray.dtype == np.uint8:
        grayf = gray.astype(np.float64) / 255.0
    else:
        grayf = gray.astype(np.float64)

    import cv2

    img8 = np.clip(grayf * 255.0, 0, 255).astype(np.uint8)

    quads = [_order_ccw(quad) for quad in _quad_candidates(grayf)]
    if not quads:
        return []
    quads = np.stack(quads).astype(np.float64)  # (Q, 4, 2)
    nq = quads.shape[0]

    # Sub-pixel corner refinement of the coarse contour vertices
    # (the reference's apriltag library fits line segments; cornerSubPix
    # on the saddle-like border corners serves the same purpose).
    try:
        refined = cv2.cornerSubPix(
            img8,
            quads.astype(np.float32).reshape(-1, 1, 2),
            (5, 5),
            (-1, -1),
            (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 20, 0.01),
        ).reshape(nq, 4, 2).astype(np.float64)
        ok = np.linalg.norm(refined - quads, axis=-1) < 4.0
        quads = np.where(ok[..., None], refined, quads)
    except cv2.error:
        pass

    # contour corners are pixel indices; convert to pixel-corner coords.
    # The quad detector finds the outer edge of the black border ring
    # = tag frame [0, 8]².
    corners_img = quads + 0.5
    hs = _homography_4pt_batch(_TAG_CORNERS, corners_img)
    grid, inb = _sample_grid_batch(grayf, hs, n=10, offset=-1.0)

    # reference levels: black = border ring cells, white = outer ring
    black_ref = grid[:, _BORDER_MASK].mean(axis=1)
    white_ref = grid[:, _OUTER_MASK].mean(axis=1)
    keep = inb & (white_ref - black_ref >= 0.1)

    thresh = 0.5 * (black_ref + white_ref)
    data_cells = (grid > thresh[:, None, None])[:, 1:9, 1:9]

    codes_bits = _codes_array()  # (587, 36)
    best_hd = np.full(nq, 99, np.int64)
    best_tid = np.zeros(nq, np.int64)
    best_rot = np.zeros(nq, np.int64)
    for rot in range(4):
        cells = np.rot90(data_cells, rot, axes=(1, 2))
        bits = cells[:, fam.BIT_Y, fam.BIT_X].astype(np.uint8)  # (Q, 36)
        dists = np.count_nonzero(
            bits[:, None, :] != codes_bits[None, :, :], axis=2
        )  # (Q, 587)
        tid = np.argmin(dists, axis=1)
        hd = dists[np.arange(nq), tid]
        upd = keep & (hd < best_hd)
        best_hd = np.where(upd, hd, best_hd)
        best_tid = np.where(upd, tid, best_tid)
        best_rot = np.where(upd, rot, best_rot)

    seen_ids = {}
    for qi in np.nonzero(best_hd <= max_hamming)[0]:
        hd, tid, rot = int(best_hd[qi]), int(best_tid[qi]), int(best_rot[qi])
        # rotate corners so corner 0 corresponds to tag frame (0,0): the
        # grid was rotated by `rot`, so the detected quad is rotated by
        # -rot relative to canonical — shift the corner order.
        corners = np.roll(corners_img[qi], -rot, axis=0)
        h_fixed = _homography_4pt(_TAG_CORNERS, corners)
        det = TagDetection(
            tag_id=tid, hamming=hd, corners=corners,
            center=corners.mean(0), h_tag_to_image=h_fixed,
        )
        prev = seen_ids.get(tid)
        if prev is None or prev.hamming > hd:
            seen_ids[tid] = det
    return list(seen_ids.values())


def refine_tag_homography(grayf, det: TagDetection, iterations: int = 25):
    """Sub-pixel refinement of the tag homography against the known bitmap.

    The contour-based quad corners are biased ~1-2 px outward by the
    threshold/blur pipeline; since the tag id is decoded we can align the
    *known* canonical tag image under the 8-DoF homography with a small
    Gauss-Newton template fit (host-side; one tag is tiny).  Returns a
    TagDetection with refined corners/homography.
    """
    tag_img = render_tag(det.tag_id)  # (10,10), 1=white
    h_img, w_img = grayf.shape
    # sample grid over the tag incl. the outer white ring: tag frame [-1, 9]
    k = 4  # subsamples per cell
    coords = -1.0 + (np.arange(10 * k) + 0.5) / k
    gx, gy = np.meshgrid(coords, coords)
    s = np.stack([gx.ravel(), gy.ravel()], -1)  # (S,2) tag-frame positions
    ix = np.clip(np.floor(s[:, 0] + 1).astype(int), 0, 9)
    iy = np.clip(np.floor(s[:, 1] + 1).astype(int), 0, 9)
    target = tag_img[iy, ix]

    h = det.h_tag_to_image.copy()
    h = h / h[2, 2]

    def sample(hh):
        p = np.concatenate([s, np.ones((s.shape[0], 1))], -1) @ hh.T
        px = p[:, :2] / p[:, 2:3]
        x = np.clip(px[:, 0] - 0.5, 0, w_img - 1.001)
        y = np.clip(px[:, 1] - 0.5, 0, h_img - 1.001)
        x0 = np.clip(np.floor(x).astype(int), 0, w_img - 2)
        y0 = np.clip(np.floor(y).astype(int), 0, h_img - 2)
        tx = (x - x0)[:, None]
        ty = (y - y0)[:, None]
        v00 = grayf[y0, x0][:, None]
        v10 = grayf[y0, x0 + 1][:, None]
        v01 = grayf[y0 + 1, x0][:, None]
        v11 = grayf[y0 + 1, x0 + 1][:, None]
        top = v00 + tx * (v10 - v00)
        bot = v01 + tx * (v11 - v01)
        val = (top + ty * (bot - top))[:, 0]
        gx_ = ((v10 - v00) + ty * ((v11 - v01) - (v10 - v00)))[:, 0]
        gy_ = (bot - top)[:, 0]
        return px, val, np.stack([gx_, gy_], -1)

    def h_params_jac(hh, px):
        """d pixel / d (8 homography params) at tag-frame samples s."""
        x, y = s[:, 0], s[:, 1]
        denom = hh[2, 0] * x + hh[2, 1] * y + 1.0
        t0 = 1.0 / denom
        t1 = -t0 * t0
        numx = hh[0, 0] * x + hh[0, 1] * y + hh[0, 2]
        numy = hh[1, 0] * x + hh[1, 1] * y + hh[1, 2]
        z = np.zeros_like(x)
        row0 = np.stack([x * t0, y * t0, t0, z, z, z, x * numx * t1, y * numx * t1], -1)
        row1 = np.stack([z, z, z, x * t0, y * t0, t0, x * numy * t1, y * numy * t1], -1)
        return np.stack([row0, row1], -2)  # (S,2,8)

    # affine intensity model fitted per iteration (closed form)
    lam = 1e-3
    prev_cost = None
    for _ in range(iterations):
        px, val, grad = sample(h)
        a_mat = np.stack([target, np.ones_like(target)], -1)
        fb, *_ = np.linalg.lstsq(a_mat, val, rcond=None)
        pred = a_mat @ fb
        r = val - pred
        cost = float(r @ r)
        pwh = h_params_jac(h, px)
        jac = np.einsum("sc,scj->sj", grad, pwh)
        big_h = jac.T @ jac
        b = jac.T @ r
        step = np.linalg.solve(big_h + lam * np.eye(8), b)
        h_test = h.copy()
        h_test[0, 0] -= step[0]
        h_test[0, 1] -= step[1]
        h_test[0, 2] -= step[2]
        h_test[1, 0] -= step[3]
        h_test[1, 1] -= step[4]
        h_test[1, 2] -= step[5]
        h_test[2, 0] -= step[6]
        h_test[2, 1] -= step[7]
        _, val_t, _ = sample(h_test)
        pred_t = a_mat @ np.linalg.lstsq(a_mat, val_t, rcond=None)[0]
        r_t = val_t - pred_t
        if r_t @ r_t < cost:
            h = h_test
            lam = max(lam * 0.5, 1e-9)
        else:
            lam *= 4.0
        if prev_cost is not None and abs(prev_cost - cost) < 1e-9 * max(cost, 1.0):
            break
        prev_cost = cost

    tag_corners = np.array([[0.0, 0.0], [8.0, 0.0], [8.0, 8.0], [0.0, 8.0]])
    corners = np.concatenate(
        [tag_corners, np.ones((4, 1))], -1
    ) @ h.T
    corners = corners[:, :2] / corners[:, 2:3]
    return TagDetection(
        tag_id=det.tag_id,
        hamming=det.hamming,
        corners=corners,
        center=corners.mean(0),
        h_tag_to_image=h,
    )


def render_tag(tag_id: int, cell_px: int = 1):
    """Render the canonical 10×10 tag image (1 = white) for a tag id."""
    code = fam.CODES[tag_id]
    img = np.ones((10, 10))
    img[1:9, 1:9] = 0.0  # black border + default-black data field
    bits = [(code >> (fam.NBITS - 1 - i)) & 1 for i in range(fam.NBITS)]
    for i, b in enumerate(bits):
        img[1 + fam.BIT_Y[i], 1 + fam.BIT_X[i]] = float(b)
    if cell_px > 1:
        img = np.kron(img, np.ones((cell_px, cell_px)))
    return img

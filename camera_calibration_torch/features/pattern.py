"""Star calibration pattern: spec, YAML IO, intensity oracle, rendering.

Capability parity with the reference's PatternData (reference:
applications/camera_calibration/src/camera_calibration/feature_detection/
feature_detector_tagged_pattern.h:66-261) and the pattern YAML schema
(reference: applications/camera_calibration/patterns/*.yaml):

- feature coordinates are integers with (0,0) a feature; valid range
  x,y ∈ [0, squares-2] minus AprilTag-covered cells (h:68-86);
- the repeating star pattern has ``num_star_segments`` alternating
  black/white angular segments around each feature
  (PatternIntensityAt, h:115-130);
- feature ids are sequential over all valid coords across the loaded
  patterns (GetCorners, feature_detector_tagged_pattern.cc:739-761).

The intensity oracle is the port's native one (``native/densify.cpp``,
built at first use), with a NumPy version it is tested against; it is used
both for corner refinement (rendering the known pattern) and synthetic
test rendering (the reference's RenderSyntheticDataset analog).

This module is the port's copy of the reference package's
``features/pattern.py``.  Only the PDF writer differs: it writes the same
polygons as a PDF of its own, with no plotting package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AprilTagInfo:
    x: int
    y: int
    width: int
    height: int
    index: int


@dataclasses.dataclass
class PatternSpec:
    num_star_segments: int
    squares_x: int
    squares_y: int
    square_length_in_meters: float
    tags: list = dataclasses.field(default_factory=list)
    page: dict | None = None

    # ------------------------- validity -------------------------

    def is_valid_feature_coord(self, x: int, y: int) -> bool:
        """(reference: feature_detector_tagged_pattern.h:68-86)"""
        if not (0 <= x <= self.squares_x - 2 and 0 <= y <= self.squares_y - 2):
            return False
        for tag in self.tags:
            if (
                tag.x - 1 <= x <= tag.x - 1 + tag.width
                and tag.y - 1 <= y <= tag.y - 1 + tag.height
            ):
                return False
        return True

    def is_valid_pattern_coord(self, x: float, y: float) -> bool:
        """(reference: feature_detector_tagged_pattern.h:88-108)"""
        if not (-1.0 <= x <= self.squares_x - 1.0 and -1.0 <= y <= self.squares_y - 1.0):
            return False
        for tag in self.tags:
            if (
                tag.x - 1 <= x <= tag.x - 1 + tag.width
                and tag.y - 1 <= y <= tag.y - 1 + tag.height
            ):
                return False
        return True

    def valid_feature_coords(self):
        out = []
        for y in range(self.squares_y - 1):
            for x in range(self.squares_x - 1):
                if self.is_valid_feature_coord(x, y):
                    out.append((x, y))
        return out

    # ------------------------- intensity -------------------------

    def intensity(self, positions):
        """Pattern intensity at positions (..., 2) in feature coords.

        1 = white, 0 = black, 0.5 at the (ill-defined) feature centers
        (reference: h:115-130).  The native oracle, built at first use.
        """
        from camera_calibration_torch import native

        return native.pattern_intensity_native(
            np.asarray(positions, np.float64), self.num_star_segments
        )

    def intensity_plain(self, positions):
        """:meth:`intensity` in NumPy (the native oracle's reference)."""
        pos = np.asarray(positions, np.float64)
        # fractional offset in [-0.5, 0.5] (round half away from zero)
        c = pos - np.sign(pos) * np.floor(np.abs(pos) + 0.5)
        sq = np.sum(c * c, axis=-1)
        angle = np.arctan2(c[..., 1], c[..., 0]) - 0.5 * np.pi
        angle = np.where(angle < 0, angle + 2 * np.pi, angle)
        seg = (self.num_star_segments * angle / (2 * np.pi)).astype(np.int64)
        val = np.where(seg % 2 == 0, 1.0, 0.0)
        return np.where(sq < 1e-8, 0.5, val)

    def feature_count(self) -> int:
        return len(self.valid_feature_coords())


def load_pattern_yaml(path) -> PatternSpec:
    """Load a pattern YAML (reference schema: patterns/*.yaml)."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    tags = [
        AprilTagInfo(
            x=int(t["tag_x"]), y=int(t["tag_y"]),
            width=int(t["width"]), height=int(t["height"]),
            index=int(t["index"]),
        )
        for t in doc.get("apriltags", []) or []
    ]
    return PatternSpec(
        num_star_segments=int(doc["num_star_segments"]),
        squares_x=int(doc["squares_x"]),
        squares_y=int(doc["squares_y"]),
        square_length_in_meters=float(doc["square_length_in_meters"]),
        tags=tags,
        page=doc.get("page"),
    )


def save_pattern_yaml(spec: PatternSpec, path):
    import yaml

    doc = {
        "num_star_segments": spec.num_star_segments,
        "squares_x": spec.squares_x,
        "squares_y": spec.squares_y,
        "square_length_in_meters": spec.square_length_in_meters,
    }
    if spec.page:
        doc["page"] = spec.page
    if spec.tags:
        doc["apriltags"] = [
            {
                "tag_x": t.x, "tag_y": t.y, "width": t.width,
                "height": t.height, "index": t.index,
            }
            for t in spec.tags
        ]
    with open(path, "w") as f:
        yaml.safe_dump(doc, f, sort_keys=False)


def corners_for_patterns(patterns):
    """Sequential feature ids across patterns.

    Returns per-pattern dicts {feature_id: (x, y)}
    (reference: GetCorners, feature_detector_tagged_pattern.cc:739-761).
    """
    out = []
    fid = 0
    for spec in patterns:
        d = {}
        for y in range(spec.squares_y - 1):
            for x in range(spec.squares_x - 1):
                if spec.is_valid_feature_coord(x, y):
                    d[fid] = (x, y)
                    fid += 1
        out.append(d)
    return out


def make_tag_renderer(spec: PatternSpec):
    """Tag-overlay callback for render_pattern: draws each configured
    AprilTag (nearest-neighbor cells) into its reserved pattern area."""
    from camera_calibration_torch.features import apriltag as at

    tag_images = {t.index: at.render_tag(t.index) for t in spec.tags}

    def renderer(pat_coords, vals):
        out = vals
        for t in spec.tags:
            img = tag_images[t.index]
            # the tag's 8-cell border frame spans feature coords
            # [t.x-1, t.x-1+width]; the full 10-cell image adds the outer
            # white ring (border frame [-1, 9])
            u = (pat_coords[..., 0] - (t.x - 1)) / t.width * 8.0 + 1.0
            v = (pat_coords[..., 1] - (t.y - 1)) / t.height * 8.0 + 1.0
            inside = (u >= 0) & (u < 10) & (v >= 0) & (v < 10)
            iu = np.clip(u.astype(int), 0, 9)
            iv = np.clip(v.astype(int), 0, 9)
            out = np.where(inside, img[iv, iu], out)
        return out

    return renderer


def render_pattern(
    spec: PatternSpec,
    homography,
    image_size,
    supersample: int = 4,
    background: float = 1.0,
    tag_renderer=None,
):
    """Render the pattern through a homography (image px -> pattern coords).

    Anti-aliased via supersampling, the synthetic-GT approach of the
    reference's RenderSyntheticDataset (reference: tools/
    render_synthetic_dataset.cc:43) and its detector-bias test
    (test/feature_detection_test.cc:48).  ``homography`` maps pixel-corner
    image coordinates to pattern feature coordinates.
    Returns a float image (H, W) in [0, 1].
    """
    w, h = image_size
    ss = supersample
    ys = (np.arange(h * ss) + 0.5) / ss
    xs = (np.arange(w * ss) + 0.5) / ss
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx, gy, np.ones_like(gx)])
    q = np.einsum("ij,jkl->ikl", np.asarray(homography), pts)
    pat = np.stack([q[0] / q[2], q[1] / q[2]], axis=-1)

    inside = (
        (pat[..., 0] >= -1.0)
        & (pat[..., 0] <= spec.squares_x - 1.0)
        & (pat[..., 1] >= -1.0)
        & (pat[..., 1] <= spec.squares_y - 1.0)
    )
    vals = spec.intensity(pat)
    if tag_renderer is not None:
        vals = tag_renderer(pat, vals)
    vals = np.where(inside, vals, background)
    # box-downsample
    vals = vals.reshape(h, ss, w, ss).mean(axis=(1, 3))
    return vals


def _write_pdf(path, width_pt, height_pt, fills):
    """Write a one-page PDF of filled polygons.

    ``fills``: (gray level, [(x, y), ...] in PDF points from the bottom-left
    corner) in painting order."""
    ops = []
    for gray, pts in fills:
        ops.append(f"{gray:g} g {pts[0][0]:.4f} {pts[0][1]:.4f} m")
        ops.extend(f"{x:.4f} {y:.4f} l" for x, y in pts[1:])
        ops.append("h f")
    content = "\n".join(ops).encode()
    objs = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {width_pt:.4f} "
         f"{height_pt:.4f}] /Contents 4 0 R /Resources << >> >>").encode(),
        b"<< /Length %d >>\nstream\n" % len(content) + content
        + b"\nendstream",
    ]
    out = bytearray(b"%PDF-1.4\n")
    offsets = []
    for i, body in enumerate(objs, 1):
        offsets.append(len(out))
        out += b"%d 0 obj\n" % i + body + b"\nendobj\n"
    xref = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objs) + 1)
    for off in offsets:
        out += b"%010d 00000 n \n" % off
    out += b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n" % (
        len(objs) + 1, xref)
    with open(path, "wb") as f:
        f.write(bytes(out))


def save_pattern_pdf(spec: PatternSpec, path, page_margin_m: float = 0.005):
    """Write a print-ready VECTOR PDF of the pattern at true physical scale.

    Matches the reference's PDF generator output role (reference:
    scripts/create_calibration_pattern.py — ReportLab there; here the
    star wedges are exact vector polygons written by :func:`_write_pdf`).
    Each star cell draws its black wedges clipped to the unit cell; the
    AprilTag bitmaps are painted on top of their reserved areas, exactly
    like the raster oracle replaces intensities there.
    """
    cell_m = spec.square_length_in_meters
    sx, sy = spec.squares_x, spec.squares_y
    # pattern coordinate range (feature coords)
    x0, x1 = -1.0, sx - 1.0
    y0, y1 = -1.0, sy - 1.0
    width_m = (x1 - x0) * cell_m + 2 * page_margin_m
    height_m = (y1 - y0) * cell_m + 2 * page_margin_m
    pt_per_m = 72.0 / 0.0254
    fills = []

    def fill(xs, ys, gray):
        """A polygon in pattern coords; pattern y grows downward, like
        the raster."""
        fills.append((gray, [
            ((page_margin_m + (x - x0) * cell_m) * pt_per_m,
             (height_m - page_margin_m - (y - y0) * cell_m) * pt_per_m)
            for x, y in zip(xs, ys)]))

    n_seg = spec.num_star_segments
    corner_angles = np.array([0.25, 0.75, 1.25, 1.75]) * np.pi

    def boundary_point(phi):
        c, s = np.cos(phi), np.sin(phi)
        r = 0.5 / max(abs(c), abs(s))
        return r * c, r * s

    def clip_rect(pts):
        """Sutherland-Hodgman clip of a polygon to the pattern rect."""
        def clip_edge(poly, inside, intersect):
            out = []
            for i, p in enumerate(poly):
                q = poly[i - 1]
                pi, qi = inside(p), inside(q)
                if pi:
                    if not qi:
                        out.append(intersect(q, p))
                    out.append(p)
                elif qi:
                    out.append(intersect(q, p))
            return out

        def ix(q, p, val, axis):
            t = (val - q[axis]) / (p[axis] - q[axis])
            o = q[1 - axis] + t * (p[1 - axis] - q[1 - axis])
            return (val, o) if axis == 0 else (o, val)

        poly = pts
        for axis, val, keep_ge in (
            (0, x0, True), (0, x1, False), (1, y0, True), (1, y1, False),
        ):
            if not poly:
                return []
            poly = clip_edge(
                poly,
                (lambda p, a=axis, v=val, k=keep_ge:
                 (p[a] >= v) if k else (p[a] <= v)),
                lambda q, p, a=axis, v=val: ix(q, p, v, a),
            )
        return poly

    for cy in range(-1, sy):
        for cx in range(-1, sx):
            # cells overlapping a tag area still draw: their star spill
            # outside the tag's white ring is part of the pattern (the
            # raster oracle behaves the same); the tag graphics painted
            # below cover everything inside the ring
            for k in range(n_seg):
                if k % 2 == 0:
                    continue  # white segment
                # intensity(): seg index from angle' = atan2(dy,dx) − π/2
                phi0 = 2 * np.pi * k / n_seg + 0.5 * np.pi
                phi1 = 2 * np.pi * (k + 1) / n_seg + 0.5 * np.pi
                pts = [(0.0, 0.0), boundary_point(phi0)]
                # square corners strictly inside (phi0, phi1)
                for m in range(8):
                    ca = corner_angles[m % 4] + 2 * np.pi * (m // 4)
                    if phi0 < ca < phi1:
                        pts.append(boundary_point(ca))
                pts.append(boundary_point(phi1))
                poly = clip_rect([(cx + p[0], cy + p[1]) for p in pts])
                if len(poly) < 3:
                    continue
                fill([p[0] for p in poly], [p[1] for p in poly], 0.0)

    # AprilTags painted on top (10×10 incl. the outer white ring)
    if spec.tags:
        from camera_calibration_torch.features import apriltag as at

        for t in spec.tags:
            img = at.render_tag(t.index)
            ox, oy = t.x - 1, t.y - 1
            csx = t.width / 8.0
            csy = t.height / 8.0
            fill(
                [ox - csx, ox + t.width + csx, ox + t.width + csx, ox - csx],
                [oy - csy, oy - csy, oy + t.height + csy, oy + t.height + csy],
                1.0,
            )
            for iv in range(10):
                for iu in range(10):
                    if img[iv, iu] >= 0.5:
                        continue
                    bx = ox + (iu - 1) * csx
                    by = oy + (iv - 1) * csy
                    fill(
                        [bx, bx + csx, bx + csx, bx],
                        [by, by, by + csy, by + csy],
                        0.0,
                    )

    _write_pdf(path, width_m * pt_per_m, height_m * pt_per_m, fills)

"""Standalone consumer SDK: use finished calibrations with NumPy only.

Capability parity with the reference's dependency-light generic_models
package (reference: generic_models/src — Eigen-only re-implementations of
CentralGeneric + NoncentralGeneric for *consumers* of a calibration:
load intrinsicsX.yaml, project / unproject / Jacobians; Readme.md:516-540).
Here the only dependency is NumPy (+ PyYAML for loading) — no PyTorch, no
card — so downstream applications can consume calibrations anywhere.
``load_camera`` reads the intrinsics YAML that ``io/state_io.py`` writes.
"""

from __future__ import annotations

import numpy as np


def _cubic_weights(t):
    t = np.asarray(t)
    t2 = t * t
    t3 = t2 * t
    om = 1.0 - t
    return np.stack(
        [
            om * om * om / 6.0,
            (3 * t3 - 6 * t2 + 4) / 6.0,
            (-3 * t3 + 3 * t2 + 3 * t + 1) / 6.0,
            t3 / 6.0,
        ],
        axis=-1,
    )


def _cubic_weight_derivs(t):
    t = np.asarray(t)
    t2 = t * t
    om = 1.0 - t
    return np.stack(
        [
            -om * om / 2.0,
            (9 * t2 - 12 * t) / 6.0,
            (-9 * t2 + 6 * t + 3) / 6.0,
            t2 / 2.0,
        ],
        axis=-1,
    )


class CentralGenericCamera:
    """NumPy CentralGeneric camera (reference: generic_models central)."""

    def __init__(self, grid, width, height, calibration_min_x,
                 calibration_min_y, calibration_max_x, calibration_max_y):
        self.grid = np.asarray(grid, np.float64)  # (Hg, Wg, 3)
        self.width = int(width)
        self.height = int(height)
        self.calibration_min_x = int(calibration_min_x)
        self.calibration_min_y = int(calibration_min_y)
        self.calibration_max_x = int(calibration_max_x)
        self.calibration_max_y = int(calibration_max_y)

    @classmethod
    def load(cls, path):
        import yaml

        with open(path) as f:
            doc = yaml.safe_load(f)
        if doc["type"] != "CentralGenericModel":
            raise ValueError(f"not a CentralGenericModel: {doc['type']}")
        gw, gh = int(doc["grid_width"]), int(doc["grid_height"])
        grid = np.asarray(doc["grid"], np.float64).reshape(gh, gw, 3)
        grid /= np.maximum(np.linalg.norm(grid, axis=-1, keepdims=True), 1e-18)
        return cls(
            grid, doc["width"], doc["height"],
            doc["calibration_min_x"], doc["calibration_min_y"],
            doc["calibration_max_x"], doc["calibration_max_y"],
        )

    # ---------------- coordinate maps ----------------

    def pixel_to_grid(self, xy):
        xy = np.asarray(xy, np.float64)
        gh, gw = self.grid.shape[:2]
        ex = self.calibration_max_x + 1 - self.calibration_min_x
        ey = self.calibration_max_y + 1 - self.calibration_min_y
        gx = 1.0 + (gw - 3.0) * (xy[..., 0] - self.calibration_min_x) / ex
        gy = 1.0 + (gh - 3.0) * (xy[..., 1] - self.calibration_min_y) / ey
        return np.stack([gx, gy], -1)

    def grid_to_pixel(self, gxy):
        gxy = np.asarray(gxy, np.float64)
        gh, gw = self.grid.shape[:2]
        ex = self.calibration_max_x + 1 - self.calibration_min_x
        ey = self.calibration_max_y + 1 - self.calibration_min_y
        px = self.calibration_min_x + (gxy[..., 0] - 1.0) / (gw - 3.0) * ex
        py = self.calibration_min_y + (gxy[..., 1] - 1.0) / (gh - 3.0) * ey
        return np.stack([px, py], -1)

    def in_calibrated_area(self, xy):
        xy = np.asarray(xy)
        return (
            (xy[..., 0] >= self.calibration_min_x)
            & (xy[..., 0] < self.calibration_max_x + 1)
            & (xy[..., 1] >= self.calibration_min_y)
            & (xy[..., 1] < self.calibration_max_y + 1)
        )

    # ---------------- spline eval ----------------

    def _eval(self, gxy, derivs=False):
        gxy = np.atleast_2d(np.asarray(gxy, np.float64))
        gh, gw = self.grid.shape[:2]
        bx = np.clip(np.floor(gxy[:, 0]).astype(int) - 1, 0, gw - 4)
        by = np.clip(np.floor(gxy[:, 1]).astype(int) - 1, 0, gh - 4)
        tx = gxy[:, 0] - (bx + 1)
        ty = gxy[:, 1] - (by + 1)
        wx = _cubic_weights(tx)
        wy = _cubic_weights(ty)
        cols = bx[:, None] + np.arange(4)
        win = np.stack(
            [self.grid[(by + dy)[:, None], cols] for dy in range(4)], axis=1
        )  # (N,4,4,3)
        u = np.einsum("ni,nj,nijc->nc", wy, wx, win)
        if not derivs:
            return u, None
        dwx = _cubic_weight_derivs(tx)
        dwy = _cubic_weight_derivs(ty)
        du_dx = np.einsum("ni,nj,nijc->nc", wy, dwx, win)
        du_dy = np.einsum("ni,nj,nijc->nc", dwy, wx, win)
        return u, np.stack([du_dx, du_dy], -1)

    # ---------------- API ----------------

    def unproject(self, xy):
        """Pixel-corner coords (..., 2) -> unit directions (..., 3)."""
        xy = np.asarray(xy, np.float64)
        flat = xy.reshape(-1, 2)
        u, _ = self._eval(self.pixel_to_grid(flat))
        u /= np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), 1e-18)
        return u.reshape(xy.shape[:-1] + (3,))

    def unproject_with_jacobian(self, xy):
        """(direction, d direction / d pixel (..., 3, 2))."""
        xy = np.asarray(xy, np.float64)
        flat = xy.reshape(-1, 2)
        u, du = self._eval(self.pixel_to_grid(flat), derivs=True)
        norm = np.linalg.norm(u, axis=-1, keepdims=True)
        un = u / norm
        n_jac = (
            np.eye(3)[None] - np.einsum("ni,nj->nij", un, un)
        ) / norm[..., None]
        gh, gw = self.grid.shape[:2]
        sx = (gw - 3.0) / (self.calibration_max_x + 1 - self.calibration_min_x)
        sy = (gh - 3.0) / (self.calibration_max_y + 1 - self.calibration_min_y)
        jac = np.einsum("nij,njk->nik", n_jac, du) * np.array([sx, sy])
        return (
            un.reshape(xy.shape[:-1] + (3,)),
            jac.reshape(xy.shape[:-1] + (3, 2)),
        )

    def project(self, points, max_iterations=100, eps=1e-12):
        """Camera-space points (..., 3) -> (pixels, valid). LM inversion."""
        pts = np.atleast_2d(np.asarray(points, np.float64))
        d = pts / np.maximum(np.linalg.norm(pts, axis=-1, keepdims=True), 1e-18)
        n = d.shape[0]
        center = np.array(
            [
                0.5 * (self.calibration_min_x + self.calibration_max_x + 1),
                0.5 * (self.calibration_min_y + self.calibration_max_y + 1),
            ]
        )
        g = self.pixel_to_grid(np.tile(center, (n, 1)))
        gh, gw = self.grid.shape[:2]
        lo = self.pixel_to_grid(
            np.array([[self.calibration_min_x, self.calibration_min_y]])
        )[0]
        hi = self.pixel_to_grid(
            np.array(
                [[self.calibration_max_x + 0.999, self.calibration_max_y + 0.999]]
            )
        )[0]
        lam = np.full(n, -1.0)
        for _ in range(max_iterations):
            u, du = self._eval(g, derivs=True)
            norm = np.linalg.norm(u, axis=-1, keepdims=True)
            un = u / norm
            proj = du - un[..., None] * np.einsum("nc,nck->nk", un, du)[:, None, :]
            jac = proj / norm[..., None]
            r = un - d
            cost = np.sum(r * r, -1)
            h00 = np.sum(jac[:, :, 0] ** 2, -1)
            h11 = np.sum(jac[:, :, 1] ** 2, -1)
            h01 = np.sum(jac[:, :, 0] * jac[:, :, 1], -1)
            b0 = np.sum(jac[:, :, 0] * r, -1)
            b1 = np.sum(jac[:, :, 1] * r, -1)
            lam = np.where(lam < 0, 0.01 * 0.5 * (h00 + h11), lam)
            det = (h00 + lam) * (h11 + lam) - h01 * h01
            det = np.where(np.abs(det) > 1e-30, det, 1e-30)
            s0 = ((h11 + lam) * b0 - h01 * b1) / det
            s1 = ((h00 + lam) * b1 - h01 * b0) / det
            g_test = np.clip(g - np.stack([s0, s1], -1), lo, hi)
            u_t, _ = self._eval(g_test)
            un_t = u_t / np.maximum(
                np.linalg.norm(u_t, axis=-1, keepdims=True), 1e-18
            )
            cost_t = np.sum((un_t - d) ** 2, -1)
            accept = cost_t < cost
            g = np.where(accept[:, None], g_test, g)
            lam = np.where(accept, 0.5 * lam, 2.0 * lam)
            if cost.max() < eps:
                break
        u, _ = self._eval(g)
        un = u / np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), 1e-18)
        valid = np.sum((un - d) ** 2, -1) < 1e4 * eps
        px = self.grid_to_pixel(g)
        return px.reshape(np.shape(points)[:-1] + (2,)), valid.reshape(
            np.shape(points)[:-1]
        )


class NoncentralGenericCamera:
    """NumPy NoncentralGeneric camera: per-pixel observation lines."""

    def __init__(self, direction_grid, point_grid, **kw):
        self._dir = CentralGenericCamera(direction_grid, **kw)
        self.point_grid = np.asarray(point_grid, np.float64)
        self._org = CentralGenericCamera(point_grid, **kw)

    @classmethod
    def load(cls, path):
        import yaml

        with open(path) as f:
            doc = yaml.safe_load(f)
        if doc["type"] != "NoncentralGenericModel":
            raise ValueError(f"not a NoncentralGenericModel: {doc['type']}")
        gw, gh = int(doc["grid_width"]), int(doc["grid_height"])
        dg = np.asarray(doc["direction_grid"], np.float64).reshape(gh, gw, 3)
        dg /= np.maximum(np.linalg.norm(dg, axis=-1, keepdims=True), 1e-18)
        pg = np.asarray(doc["point_grid"], np.float64).reshape(gh, gw, 3)
        kw = dict(
            width=doc["width"], height=doc["height"],
            calibration_min_x=doc["calibration_min_x"],
            calibration_min_y=doc["calibration_min_y"],
            calibration_max_x=doc["calibration_max_x"],
            calibration_max_y=doc["calibration_max_y"],
        )
        return cls(dg, pg, **kw)

    def unproject(self, xy):
        """Pixel (..., 2) -> (unit direction, line origin)."""
        d = self._dir.unproject(xy)
        xy = np.asarray(xy, np.float64)
        flat = xy.reshape(-1, 2)
        o, _ = self._org._eval(self._org.pixel_to_grid(flat))
        return d, o.reshape(xy.shape[:-1] + (3,))


def load_camera(path):
    """Load any supported intrinsics YAML as an SDK camera object."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    t = doc["type"]
    if t == "CentralGenericModel":
        return CentralGenericCamera.load(path)
    if t == "NoncentralGenericModel":
        return NoncentralGenericCamera.load(path)
    raise ValueError(
        f"SDK supports generic models; use camera_calibration_torch.io."
        f"state_io.load_camera_model for {t}"
    )

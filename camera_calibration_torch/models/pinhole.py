"""Pinhole camera for synthetic ground truth: dense direction images and
synthetic observations; not itself a calibration target.

Pixel-corner convention: ``pixel = (fx·x/z + cx, fy·y/z + cy)`` with cx,cy
measured from the image corner.
"""

from __future__ import annotations

import dataclasses

import torch

from camera_calibration_torch.config import default_device


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int = 640
    height: int = 480


def make_pinhole(fx, fy, cx, cy, width, height, dtype=torch.float64,
                 device=None):
    device = default_device(device)

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    return PinholeCamera(fx=t(fx), fy=t(fy), cx=t(cx), cy=t(cy),
                         width=int(width), height=int(height))


def project(cam: PinholeCamera, points):
    """Camera-space points (..., 3) -> (pixel-corner coords (..., 2),
    valid): z > 0 and inside the image."""
    z = points[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, 1e-12)
    u = cam.fx * points[..., 0] / safe_z + cam.cx
    v = cam.fy * points[..., 1] / safe_z + cam.cy
    valid = ((z > 1e-12) & (u >= 0.0) & (u < cam.width) & (v >= 0.0)
             & (v < cam.height))
    return torch.stack([u, v], dim=-1), valid


def unproject(cam: PinholeCamera, pixels):
    """Pixel-corner coords (..., 2) -> unit directions (..., 3)."""
    x = (pixels[..., 0] - cam.cx) / cam.fx
    y = (pixels[..., 1] - cam.cy) / cam.fy
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def direction_image(cam: PinholeCamera, dtype=torch.float64):
    """Dense (H, W, 3) unit-direction image sampled at pixel centers."""
    dev = cam.fx.device
    yy, xx = torch.meshgrid(
        torch.arange(cam.height, dtype=dtype, device=dev) + 0.5,
        torch.arange(cam.width, dtype=dtype, device=dev) + 0.5,
        indexing="ij")
    return unproject(cam, torch.stack([xx, yy], dim=-1))

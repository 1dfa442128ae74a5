"""COLMAP text-model interchange.

The counterpart of the reference package's ``io/colmap.py``: read and
write COLMAP's ``cameras.txt`` / ``images.txt`` / ``points3D.txt``, with
the same text.

Camera model mapping:
- COLMAP OPENCV / FULL_OPENCV  <-> CentralOpenCVModel
- COLMAP THIN_PRISM_FISHEYE    <-> CentralThinPrismFisheyeModel
- PINHOLE                      <-> PinholeCamera
Generic spline models have no COLMAP counterpart; fit a parametric model
first (``report/fitting_report.py``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from camera_calibration_torch.config import default_device
from camera_calibration_torch.models import parametric as pm
from camera_calibration_torch.models import pinhole as ph


@dataclasses.dataclass
class ColmapImage:
    image_id: int
    q: np.ndarray  # (4,) wxyz — image_tr_world rotation
    t: np.ndarray  # (3,)
    camera_id: int
    name: str
    points2d: list  # [(x, y, point3d_id)]


@dataclasses.dataclass
class ColmapModel:
    cameras: dict  # camera_id -> model object
    images: list  # [ColmapImage]
    points3d: dict  # point3d_id -> (xyz (3,), rgb (3,), error, track)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _camera_to_colmap(cam):
    if isinstance(cam, ph.PinholeCamera):
        return "PINHOLE", cam.width, cam.height, [
            float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy)]
    if isinstance(cam, pm.CentralOpenCVModel):
        p = _np(cam.params)
        # COLMAP FULL_OPENCV: fx fy cx cy k1 k2 p1 p2 k3 k4 k5 k6
        return "FULL_OPENCV", cam.width, cam.height, [
            p[0], p[1], p[2], p[3], p[4], p[5], p[10], p[11],
            p[6], p[7], p[8], p[9]]
    if isinstance(cam, pm.CentralThinPrismFisheyeModel):
        if not cam.use_equidistant_projection:
            # COLMAP's THIN_PRISM_FISHEYE always applies the equidistant
            # pre-step: exporting a model without it would change it
            raise TypeError(
                "CentralThinPrismFisheyeModel without the equidistant "
                "projection step has no COLMAP counterpart "
                "(COLMAP THIN_PRISM_FISHEYE is always equidistant); "
                "re-fit with use_equidistant_projection=True or use "
                "FULL_OPENCV via CentralOpenCVModel")
        p = _np(cam.params)
        # COLMAP THIN_PRISM_FISHEYE: fx fy cx cy k1 k2 p1 p2 k3 k4 sx1 sy1
        return "THIN_PRISM_FISHEYE", cam.width, cam.height, [
            p[0], p[1], p[2], p[3], p[4], p[5], p[8], p[9],
            p[6], p[7], p[10], p[11]]
    raise TypeError(
        f"no COLMAP model for {type(cam).__name__}; fit a parametric model")


def _camera_from_colmap(model_name, width, height, params,
                        dtype=torch.float64, device=None):
    device = default_device(device)
    params = np.asarray(params, np.float64)
    if model_name == "PINHOLE":
        return ph.make_pinhole(params[0], params[1], params[2], params[3],
                               width, height, dtype=dtype, device=device)
    if model_name == "SIMPLE_PINHOLE":
        return ph.make_pinhole(params[0], params[0], params[1], params[2],
                               width, height, dtype=dtype, device=device)
    if model_name not in ("OPENCV", "FULL_OPENCV", "THIN_PRISM_FISHEYE"):
        raise ValueError(f"unsupported COLMAP camera model: {model_name}")
    full = np.zeros(12)
    full[:4] = params[:4]
    full[4] = params[4]  # k1
    full[5] = params[5]  # k2
    if model_name in ("OPENCV", "FULL_OPENCV"):
        full[10] = params[6]  # p1
        full[11] = params[7]  # p2
        if model_name == "FULL_OPENCV":
            full[6:10] = params[8:12]  # k3..k6
        return pm.CentralOpenCVModel(
            params=torch.as_tensor(full, dtype=dtype, device=device),
            width=width, height=height)
    full[8] = params[6]  # p1
    full[9] = params[7]  # p2
    full[6] = params[8]  # k3
    full[7] = params[9]  # k4
    full[10] = params[10]  # sx1
    full[11] = params[11]  # sy1
    # COLMAP's THIN_PRISM_FISHEYE includes the atan(r)/r equidistant
    # pre-step: use_equidistant_projection=True
    return pm.CentralThinPrismFisheyeModel(
        params=torch.as_tensor(full, dtype=dtype, device=device),
        width=width, height=height, use_equidistant_projection=True)


def write_model(path, model: ColmapModel):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "cameras.txt"), "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cid, cam in model.cameras.items():
            name, w, h, params = _camera_to_colmap(cam)
            f.write(f"{cid} {name} {w} {h} "
                    + " ".join("%.12g" % p for p in params) + "\n")
    with open(os.path.join(path, "images.txt"), "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for im in model.images:
            f.write(f"{im.image_id} "
                    + " ".join("%.12g" % v for v in [
                        im.q[0], im.q[1], im.q[2], im.q[3],
                        im.t[0], im.t[1], im.t[2]])
                    + f" {im.camera_id} {im.name}\n")
            f.write(" ".join(f"%.12g %.12g {int(pid)}" % (x, y)
                             for (x, y, pid) in im.points2d) + "\n")
    with open(os.path.join(path, "points3D.txt"), "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for pid, (xyz, rgb, err, track) in model.points3d.items():
            f.write(f"{pid} "
                    + " ".join("%.12g" % v for v in xyz)
                    + f" {int(rgb[0])} {int(rgb[1])} {int(rgb[2])} %.12g "
                    % err
                    + " ".join(f"{a} {b}" for a, b in track) + "\n")


def read_model(path, dtype=torch.float64, device=None) -> ColmapModel:
    """A COLMAP text model; its cameras' tensors in ``dtype`` on
    ``device`` (default: the card)."""
    cameras = {}
    with open(os.path.join(path, "cameras.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cameras[int(parts[0])] = _camera_from_colmap(
                parts[1], int(parts[2]), int(parts[3]),
                [float(v) for v in parts[4:]], dtype=dtype, device=device)
    images = []
    with open(os.path.join(path, "images.txt")) as f:
        # keep blank lines: an image with no 2D points still owns its
        # (empty) second line
        lines = [ln.rstrip("\n").strip() for ln in f
                 if not ln.strip().startswith("#")]
    while lines and not lines[-1]:
        lines.pop()
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        pts = []
        if i + 1 < len(lines) and lines[i + 1]:
            vals = lines[i + 1].split()
            for k in range(0, len(vals), 3):
                pts.append((float(vals[k]), float(vals[k + 1]),
                            int(vals[k + 2])))
        images.append(ColmapImage(
            image_id=int(parts[0]),
            q=np.asarray([float(v) for v in parts[1:5]]),
            t=np.asarray([float(v) for v in parts[5:8]]),
            camera_id=int(parts[8]),
            name=parts[9] if len(parts) > 9 else "",
            points2d=pts))
    points3d = {}
    p3d_path = os.path.join(path, "points3D.txt")
    if os.path.exists(p3d_path):
        with open(p3d_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                track = [(int(parts[k]), int(parts[k + 1]))
                         for k in range(8, len(parts) - 1, 2)]
                points3d[int(parts[0])] = (
                    np.asarray([float(v) for v in parts[1:4]]),
                    np.asarray([int(v) for v in parts[4:7]]),
                    float(parts[7]), track)
    return ColmapModel(cameras=cameras, images=images, points3d=points3d)


def export_ba_state(path, state, dataset, image_used, fid_to_idx,
                    camera_index=None):
    """Export a calibration to a COLMAP text model.

    Per-imageset images with rig-composed poses; pattern points as the 3D
    points.  Parametric intrinsics export directly; generic models raise
    (fit a parametric model first).
    """
    from camera_calibration_torch.ops import se3

    cameras = {ci + 1: m for ci, m in enumerate(state.intrinsics)
               if camera_index is None or ci == camera_index}
    images = []
    img_id = 1
    n_cams = len(state.intrinsics)
    for si, used in enumerate(image_used):
        if not used:
            continue
        for ci in range(n_cams):
            if camera_index is not None and ci != camera_index:
                continue
            q, t = se3.se3_compose(
                state.cam_q_rig[ci], state.cam_t_rig[ci],
                state.rig_q_global[si], state.rig_t_global[si])
            feats = dataset.imagesets[si].features[ci] if dataset else []
            pts2d = [(float(f.xy[0]), float(f.xy[1]),
                      fid_to_idx.get(f.feature_id, -1) + 1) for f in feats]
            name = ""
            if dataset and dataset.imagesets[si].filenames:
                name = dataset.imagesets[si].filenames[0]
            images.append(ColmapImage(
                image_id=img_id, q=_np(q), t=_np(t), camera_id=ci + 1,
                name=name or f"imageset{si}_cam{ci}.png", points2d=pts2d))
            img_id += 1
    pts = _np(state.points)
    points3d = {i + 1: (pts[i], np.array([128, 128, 128]), 0.0, [])
                for i in range(pts.shape[0])}
    write_model(path, ColmapModel(cameras=cameras, images=images,
                                  points3d=points3d))

"""BA-state directory IO in the reference's YAML schema.

Layout (reference: applications/camera_calibration/src/camera_calibration/
io/calibration_io.cc:432-464): ``intrinsicsX.yaml`` per camera +
``camera_tr_rig.yaml`` + ``rig_tr_global.yaml`` + ``points.yaml`` (plus
convenience .obj point/pose exports).  Camera YAML schemas per model:
calibration_io.cc:526-642 (grid stored row-major, x,y,z per knot); pose
YAML: calibration_io.cc:787-…; points: calibration_io.cc:890-935.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from camera_calibration_torch.ba.state import BAState
from camera_calibration_torch.config import default_device
from camera_calibration_torch.models import central_generic as cg
from camera_calibration_torch.models import noncentral_generic as ncg
from camera_calibration_torch.models import parametric as pm


def _np(a):
    """NumPy copy of an array or a tensor on any device."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _t(a, dtype, device):
    return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                           device=device)


def save_camera_model(model, path, dtype_str="%.14g"):
    """(reference: calibration_io.cc:526-642)"""

    def fmt_list(arr):
        return "[" + ", ".join(dtype_str % v for v in _np(arr).ravel()) + "]"

    lines = []
    if isinstance(model, cg.CentralGenericModel):
        lines += [
            "type : CentralGenericModel",
            f"width : {model.width}",
            f"height : {model.height}",
            f"calibration_min_x : {model.calibration_min_x}",
            f"calibration_min_y : {model.calibration_min_y}",
            f"calibration_max_x : {model.calibration_max_x}",
            f"calibration_max_y : {model.calibration_max_y}",
            f"grid_width : {model.grid.shape[1]}",
            f"grid_height : {model.grid.shape[0]}",
            "# The grid is stored in row-major order, top to bottom. "
            "Each row is stored left to right. Each grid point is stored as x, y, z.",
            "grid : " + fmt_list(model.grid),
        ]
    elif isinstance(model, ncg.NoncentralGenericModel):
        lines += [
            "type : NoncentralGenericModel",
            f"width : {model.width}",
            f"height : {model.height}",
            f"calibration_min_x : {model.calibration_min_x}",
            f"calibration_min_y : {model.calibration_min_y}",
            f"calibration_max_x : {model.calibration_max_x}",
            f"calibration_max_y : {model.calibration_max_y}",
            f"grid_width : {model.direction_grid.shape[1]}",
            f"grid_height : {model.direction_grid.shape[0]}",
            "# The grids are stored in row-major order, top to bottom. "
            "Each row is stored left to right. Each grid point is stored as x, y, z.",
            "point_grid : " + fmt_list(model.point_grid),
            "direction_grid : " + fmt_list(model.direction_grid),
        ]
    elif isinstance(model, pm.CentralThinPrismFisheyeModel):
        lines += [
            "type : CentralThinPrismFisheyeModel",
            f"width : {model.width}",
            f"height : {model.height}",
            "use_equidistant_projection : "
            + ("true" if model.use_equidistant_projection else "false"),
            "parameters : " + fmt_list(model.params),
        ]
    elif isinstance(model, pm.CentralOpenCVModel):
        lines += [
            "type : CentralOpenCVModel",
            f"width : {model.width}",
            f"height : {model.height}",
            "parameters : " + fmt_list(model.params),
        ]
    elif isinstance(model, pm.CentralRadialModel):
        lines += [
            "type : CentralRadialModel",
            f"width : {model.width}",
            f"height : {model.height}",
            "parameters : " + fmt_list(model.params),
        ]
    else:
        raise TypeError(f"cannot save model type {type(model)}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_camera_model(path, dtype=torch.float64, device=None):
    """A camera model from its YAML file, on ``device`` (default: the
    card).  Needs PyYAML."""
    import yaml

    device = default_device(device)

    with open(path) as f:
        doc = yaml.safe_load(f)
    t = doc["type"]
    if t == "CentralGenericModel":
        gw, gh = int(doc["grid_width"]), int(doc["grid_height"])
        grid = np.asarray(doc["grid"], np.float64).reshape(gh, gw, 3)
        norms = np.linalg.norm(grid, axis=-1, keepdims=True)
        grid = grid / np.maximum(norms, 1e-18)
        return cg.CentralGenericModel(
            grid=_t(grid, dtype, device),
            width=int(doc["width"]),
            height=int(doc["height"]),
            calibration_min_x=int(doc["calibration_min_x"]),
            calibration_min_y=int(doc["calibration_min_y"]),
            calibration_max_x=int(doc["calibration_max_x"]),
            calibration_max_y=int(doc["calibration_max_y"]),
        )
    if t == "NoncentralGenericModel":
        gw, gh = int(doc["grid_width"]), int(doc["grid_height"])
        pg = np.asarray(doc["point_grid"], np.float64).reshape(gh, gw, 3)
        dg = np.asarray(doc["direction_grid"], np.float64).reshape(gh, gw, 3)
        dg = dg / np.maximum(np.linalg.norm(dg, axis=-1, keepdims=True), 1e-18)
        return ncg.NoncentralGenericModel(
            direction_grid=_t(dg, dtype, device),
            point_grid=_t(pg, dtype, device),
            width=int(doc["width"]),
            height=int(doc["height"]),
            calibration_min_x=int(doc["calibration_min_x"]),
            calibration_min_y=int(doc["calibration_min_y"]),
            calibration_max_x=int(doc["calibration_max_x"]),
            calibration_max_y=int(doc["calibration_max_y"]),
        )
    if t == "CentralThinPrismFisheyeModel":
        return pm.CentralThinPrismFisheyeModel(
            params=_t(doc["parameters"], dtype, device),
            width=int(doc["width"]),
            height=int(doc["height"]),
            use_equidistant_projection=bool(doc["use_equidistant_projection"]),
        )
    if t == "CentralOpenCVModel":
        return pm.CentralOpenCVModel(
            params=_t(doc["parameters"], dtype, device),
            width=int(doc["width"]),
            height=int(doc["height"]),
        )
    if t == "CentralRadialModel":
        return pm.CentralRadialModel(
            params=_t(doc["parameters"], dtype, device),
            width=int(doc["width"]),
            height=int(doc["height"]),
        )
    raise ValueError(f"cannot load camera model type: {t}")


def save_poses(used, qs, ts, path):
    """(reference: calibration_io.cc:787-…; Eigen-coefficient quaternions)"""
    lines = [
        "# Each pose gives the B_tr_A transformation (i.e., A to B with "
        "right-multiplication), where the spaces A and B are defined by the "
        "filename. Quaternions are written as used by the Eigen library.",
        f"pose_count: {len(used)}",
        "poses:",
    ]
    qs = _np(qs)
    ts = _np(ts)
    for i, u in enumerate(used):
        if not u:
            continue
        q = qs[i]  # wxyz
        t = ts[i]
        lines += [
            f"  - index: {i}",
            "    tx: %.14g" % t[0],
            "    ty: %.14g" % t[1],
            "    tz: %.14g" % t[2],
            "    qx: %.14g" % q[1],
            "    qy: %.14g" % q[2],
            "    qz: %.14g" % q[3],
            "    qw: %.14g" % q[0],
        ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    # convenience .obj of pose positions (reference writes these too)
    with open(str(path) + ".obj", "w") as f:
        for i, u in enumerate(used):
            if u:
                t = ts[i]
                f.write("v %.14g %.14g %.14g 1 0 0\n" % (t[0], t[1], t[2]))


def load_poses(path, count=None):
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    n = int(doc["pose_count"]) if count is None else count
    used = [False] * n
    qs = np.tile(np.array([1.0, 0, 0, 0]), (n, 1))
    ts = np.zeros((n, 3))
    for p in doc.get("poses") or []:
        i = int(p["index"])
        used[i] = True
        qs[i] = [p["qw"], p["qx"], p["qy"], p["qz"]]
        ts[i] = [p["tx"], p["ty"], p["tz"]]
    return used, qs, ts


def save_points(points, feature_id_to_point_index, path):
    """(reference: calibration_io.cc:890-935)"""
    pts = _np(points)
    lines = [
        "# Each point is stored as x, y, z.",
        "points : ["
        + ", ".join("%.14g" % v for v in pts.ravel())
        + "]",
        "feature_id_to_point_index:",
    ]
    for fid, idx in feature_id_to_point_index.items():
        lines += [f"  - feature_id: {fid}", f"    point_index: {idx}"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(str(path) + ".obj", "w") as f:
        for p in pts:
            f.write("v %.14g %.14g %.14g 0 0 1\n" % (p[0], p[1], p[2]))


def load_points(path):
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    pts = np.asarray(doc["points"], np.float64).reshape(-1, 3)
    mapping = {
        int(e["feature_id"]): int(e["point_index"])
        for e in doc.get("feature_id_to_point_index") or []
    }
    return pts, mapping


def save_ba_state(base_path, state: BAState, image_used,
                  feature_id_to_point_index):
    """(reference: calibration_io.cc:432-464 SaveBAState)"""
    os.makedirs(base_path, exist_ok=True)
    save_poses(
        image_used,
        state.rig_q_global,
        state.rig_t_global,
        os.path.join(base_path, "rig_tr_global.yaml"),
    )
    n_cam = state.cam_q_rig.shape[0]
    save_poses(
        [True] * n_cam,
        state.cam_q_rig,
        state.cam_t_rig,
        os.path.join(base_path, "camera_tr_rig.yaml"),
    )
    for ci, model in enumerate(state.intrinsics):
        save_camera_model(
            model, os.path.join(base_path, f"intrinsics{ci}.yaml")
        )
    save_points(
        state.points,
        feature_id_to_point_index,
        os.path.join(base_path, "points.yaml"),
    )


def load_ba_state(base_path, dtype=torch.float64, device=None):
    """Returns (BAState on ``device`` (default: the card), image_used,
    feature_id_to_point_index).  Needs PyYAML."""
    device = default_device(device)
    used, rq, rt = load_poses(os.path.join(base_path, "rig_tr_global.yaml"))
    _, cq, ct = load_poses(os.path.join(base_path, "camera_tr_rig.yaml"))
    models = []
    ci = 0
    while True:
        p = os.path.join(base_path, f"intrinsics{ci}.yaml")
        if not os.path.exists(p):
            break
        models.append(load_camera_model(p, dtype=dtype, device=device))
        ci += 1
    pts, mapping = load_points(os.path.join(base_path, "points.yaml"))
    state = BAState(
        rig_q_global=_t(rq, dtype, device),
        rig_t_global=_t(rt, dtype, device),
        cam_q_rig=_t(cq, dtype, device),
        cam_t_rig=_t(ct, dtype, device),
        points=_t(pts, dtype, device),
        intrinsics=tuple(models),
    )
    return state, used, mapping

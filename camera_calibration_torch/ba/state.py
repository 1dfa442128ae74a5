"""Bundle-adjustment state and tangent.

``BAState`` holds rig poses per imageset, camera-in-rig extrinsics, 3D
pattern points and per-camera intrinsics models.  A point in global
(pattern) space maps to camera space as ``x_cam = R_c (R_r x + t_r) + t_c``.

The tangent has 6 DoF per imageset pose, 6 per camera extrinsic, 3 per
point, and per camera 2 (central) or 5 (noncentral) per intrinsics-grid
knot or the parameter vector of a parametric model.
Flattened, it is laid out in field order: ``rig``, ``cam``, ``points``,
then ``intr[c]`` for each camera.
"""

from __future__ import annotations

import dataclasses

import torch

from camera_calibration_torch.models import protocol
from camera_calibration_torch.models.base import replace
from camera_calibration_torch.models.noncentral_generic import (
    NoncentralGenericModel,
)
from camera_calibration_torch.ops import se3


@dataclasses.dataclass(frozen=True)
class BAState:
    rig_q_global: torch.Tensor  # (M, 4) wxyz
    rig_t_global: torch.Tensor  # (M, 3)
    cam_q_rig: torch.Tensor  # (C, 4)
    cam_t_rig: torch.Tensor  # (C, 3)
    points: torch.Tensor  # (P, 3)
    intrinsics: tuple  # per-camera models


@dataclasses.dataclass(frozen=True)
class BATangent:
    rig: torch.Tensor  # (M, 6) = (ω, δt)
    cam: torch.Tensor  # (C, 6)
    points: torch.Tensor  # (P, 3)
    intr: tuple  # per camera: knot field (gh, gw, K) or parameters (P,)

    def leaves(self):
        return (self.rig, self.cam, self.points) + tuple(self.intr)

    def map(self, f, *others):
        """Apply ``f`` leaf-wise to this tangent and ``others``."""
        return BATangent(
            rig=f(self.rig, *(o.rig for o in others)),
            cam=f(self.cam, *(o.cam for o in others)),
            points=f(self.points, *(o.points for o in others)),
            intr=tuple(
                f(a, *(o.intr[i] for o in others))
                for i, a in enumerate(self.intr)
            ),
        )

    def ravel(self):
        """The flat vector in field order (rig, cam, points, intr[c])."""
        return torch.cat([x.reshape(-1) for x in self.leaves()])

    def unravel(self, flat):
        """A tangent shaped like this one from a flat vector."""
        out, off = [], 0
        for x in self.leaves():
            out.append(flat[off:off + x.numel()].reshape(x.shape))
            off += x.numel()
        return BATangent(rig=out[0], cam=out[1], points=out[2],
                         intr=tuple(out[3:]))

    def dot(self, other):
        return sum(torch.sum(a * b) for a, b in zip(self.leaves(),
                                                     other.leaves()))


def zero_tangent(state: BAState) -> BATangent:
    return BATangent(
        rig=state.rig_t_global.new_zeros(state.rig_q_global.shape[:1] + (6,)),
        cam=state.cam_t_rig.new_zeros(state.cam_q_rig.shape[:1] + (6,)),
        points=torch.zeros_like(state.points),
        intr=tuple(protocol.intrinsics_tangent_zero(m) for m in state.intrinsics),
    )


def retract(state: BAState, tangent: BATangent, scale=1.0) -> BAState:
    """Apply a tangent update to every variable group.

    Rotations take a left-multiplicative exp-map update, translations and
    points an additive one, grid knots a 2-DoF unit-direction retraction.
    """
    rig_q, rig_t = se3.retract_pose(
        state.rig_q_global, state.rig_t_global, scale * tangent.rig
    )
    cam_q, cam_t = se3.retract_pose(
        state.cam_q_rig, state.cam_t_rig, scale * tangent.cam
    )
    return BAState(
        rig_q_global=rig_q,
        rig_t_global=rig_t,
        cam_q_rig=cam_q,
        cam_t_rig=cam_t,
        points=state.points + scale * tangent.points,
        intrinsics=tuple(
            protocol.intrinsics_retract(m, g, scale)
            for m, g in zip(state.intrinsics, tangent.intr)
        ),
    )


def fix_gauge_mask(state: BAState, freeze=()) -> BATangent:
    """Multipliers that freeze the first camera's extrinsics (the rig
    anchor) and every group named in ``freeze`` ("poses", "extrinsics",
    "points", "intrinsics")."""
    freeze = set(freeze)
    rig_mask = torch.full(
        state.rig_q_global.shape[:1] + (6,), 0.0 if "poses" in freeze else 1.0,
        dtype=state.rig_t_global.dtype, device=state.rig_t_global.device,
    )
    cam_mask = torch.full(
        state.cam_q_rig.shape[:1] + (6,), 0.0 if "extrinsics" in freeze else 1.0,
        dtype=state.cam_t_rig.dtype, device=state.cam_t_rig.device,
    )
    cam_mask[0] = 0.0
    pts_mask = torch.full_like(state.points, 0.0 if "points" in freeze else 1.0)
    intr_scale = 0.0 if "intrinsics" in freeze else 1.0
    return BATangent(
        rig=rig_mask,
        cam=cam_mask,
        points=pts_mask,
        intr=tuple(
            torch.full_like(protocol.intrinsics_tangent_zero(m), intr_scale)
            for m in state.intrinsics
        ),
    )


def apply_freeze(state_old: BAState, state_new: BAState, freeze=()) -> BAState:
    """Restore frozen variable groups exactly from the pre-step state (the
    retraction's renormalizations could otherwise move them by an ulp)."""
    freeze = set(freeze)
    if not freeze:
        return state_new

    def pick(group, name):
        return getattr(state_old if group in freeze else state_new, name)

    return BAState(
        rig_q_global=pick("poses", "rig_q_global"),
        rig_t_global=pick("poses", "rig_t_global"),
        cam_q_rig=pick("extrinsics", "cam_q_rig"),
        cam_t_rig=pick("extrinsics", "cam_t_rig"),
        points=pick("points", "points"),
        intrinsics=pick("intrinsics", "intrinsics"),
    )


def broadcast_rows(arr, idx, grid_shape, axis):
    """arr[idx] — or, in (M, P) grid layout, the equivalent broadcast.

    axis 0: idx is the imageset column (row m repeated P times);
    axis 1: idx is the point column (rows 0..P-1 tiled M times).
    """
    if grid_shape is not None:
        m, p = grid_shape
        if axis == 0 and arr.shape[0] == m:
            return arr[:, None].expand((m, p) + arr.shape[1:]).reshape(
                (m * p,) + arr.shape[1:])
        if axis == 1 and arr.shape[0] == p:
            return arr[None].expand((m, p) + arr.shape[1:]).reshape(
                (m * p,) + arr.shape[1:])
    return arr[idx]


def transform_to_camera(state: BAState, imageset_idx, camera_idx, points,
                        grid_shape=None):
    """(x_cam, x_rig) for observations: gather poses, apply the rig chain."""
    rq = broadcast_rows(state.rig_q_global, imageset_idx, grid_shape, 0)
    rt = broadcast_rows(state.rig_t_global, imageset_idx, grid_shape, 0)
    cq = state.cam_q_rig[camera_idx]
    ct = state.cam_t_rig[camera_idx]
    x_rig = se3.quat_rotate(rq, points) + rt
    return se3.quat_rotate(cq, x_rig) + ct, x_rig


def scale_state(state: BAState, factor) -> BAState:
    """Scale the metric scale of the reconstruction (reference package
    ``ba/state.py:189-211``): translations and points scale, and so does a
    noncentral model's line-origin grid (camera-frame meters); direction
    grids and parametric models (pixel-space) are scale-invariant."""
    return BAState(
        rig_q_global=state.rig_q_global,
        rig_t_global=state.rig_t_global * factor,
        cam_q_rig=state.cam_q_rig,
        cam_t_rig=state.cam_t_rig * factor,
        points=state.points * factor,
        intrinsics=tuple(
            replace(m, point_grid=m.point_grid * factor)
            if isinstance(m, NoncentralGenericModel) else m
            for m in state.intrinsics),
    )

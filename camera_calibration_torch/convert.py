"""Carry states, models and observation tables into the port.

The reference package's ``BAState``, camera models and
``ObservationTable`` are given as numpy arrays: either a dict keyed by the
field names or any object with those attributes (array-likes are read with
``numpy.asarray``).  A model with a ``direction_grid`` is noncentral, one
with a ``grid`` central; one with ``params`` is parametric, and its kind
comes from its class name or, for a dict, from its ``kind`` key (see
:data:`PARAMETRIC_KINDS`).  The converters build the port's objects on a
device, by default the card.  Floating arrays keep their dtype unless
``dtype`` is given; index columns become int64.
"""

from __future__ import annotations

import numpy as np
import torch

from camera_calibration_torch.ba.dataset import ObservationTable, table_from_numpy
from camera_calibration_torch.ba.state import BAState
from camera_calibration_torch.config import default_device
from camera_calibration_torch.models.central_generic import CentralGenericModel
from camera_calibration_torch.models.noncentral_generic import (
    NoncentralGenericModel,
)
from camera_calibration_torch.models.parametric import (
    CentralOpenCVModel, CentralRadialModel, CentralThinPrismFisheyeModel,
)

_MODEL_INTS = ("width", "height", "calibration_min_x", "calibration_min_y",
               "calibration_max_x", "calibration_max_y")
# A parametric model's kind, by class name or by a dict's ``kind`` key.
PARAMETRIC_KINDS = {
    "CentralThinPrismFisheyeModel": CentralThinPrismFisheyeModel,
    "thin_prism_fisheye": CentralThinPrismFisheyeModel,
    "CentralOpenCVModel": CentralOpenCVModel,
    "opencv": CentralOpenCVModel,
    "CentralRadialModel": CentralRadialModel,
    "radial": CentralRadialModel,
}
_KIND_NAMES = {CentralThinPrismFisheyeModel: "thin_prism_fisheye",
               CentralOpenCVModel: "opencv", CentralRadialModel: "radial"}
_STATE_ARRAYS = ("rig_q_global", "rig_t_global", "cam_q_rig", "cam_t_rig",
                 "points")


def _get(obj, name, default=None):
    if isinstance(obj, dict):
        return obj.get(name, default)
    return getattr(obj, name, default)


def _tensor(a, device, dtype=None):
    t = torch.as_tensor(np.array(a), device=device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def central_generic_model(model, device=None, dtype=None) -> CentralGenericModel:
    device = default_device(device)
    return CentralGenericModel(
        grid=_tensor(_get(model, "grid"), device, dtype),
        **{k: int(_get(model, k, 0)) for k in _MODEL_INTS},
    )


def noncentral_generic_model(model, device=None,
                             dtype=None) -> NoncentralGenericModel:
    device = default_device(device)
    return NoncentralGenericModel(
        direction_grid=_tensor(_get(model, "direction_grid"), device, dtype),
        point_grid=_tensor(_get(model, "point_grid"), device, dtype),
        **{k: int(_get(model, k, 0)) for k in _MODEL_INTS},
    )


def parametric_model(model, device=None, dtype=None):
    """A ThinPrismFisheye, OpenCV or Radial model: the kind from the class
    name or the ``kind`` key; ``params``, ``width``, ``height`` and, for
    ThinPrismFisheye, ``use_equidistant_projection`` carried across."""
    device = default_device(device)
    kind = (model.get("kind") if isinstance(model, dict)
            else type(model).__name__)
    if kind not in PARAMETRIC_KINDS:
        raise ValueError(f"unknown parametric model kind {kind!r}: give one "
                         f"of {sorted(PARAMETRIC_KINDS)}")
    cls = PARAMETRIC_KINDS[kind]
    fields = dict(params=_tensor(_get(model, "params"), device, dtype),
                  width=int(_get(model, "width", 0)),
                  height=int(_get(model, "height", 0)))
    if cls is CentralThinPrismFisheyeModel:
        fields["use_equidistant_projection"] = bool(
            _get(model, "use_equidistant_projection", True))
    return cls(**fields)


def camera_model(model, device=None, dtype=None):
    """The port's model of the fields it finds: ``direction_grid`` makes a
    NoncentralGeneric model, ``grid`` a CentralGeneric one, ``params`` a
    parametric one (:func:`parametric_model`)."""
    if _get(model, "direction_grid") is not None:
        return noncentral_generic_model(model, device, dtype)
    if _get(model, "grid") is not None:
        return central_generic_model(model, device, dtype)
    return parametric_model(model, device, dtype)


def ba_state(state, device=None, dtype=None) -> BAState:
    device = default_device(device)
    return BAState(
        **{k: _tensor(_get(state, k), device, dtype) for k in _STATE_ARRAYS},
        intrinsics=tuple(camera_model(m, device, dtype)
                         for m in _get(state, "intrinsics")),
    )


def observation_table(table, device=None, dtype=None) -> ObservationTable:
    return table_from_numpy(
        *(np.array(_get(table, k)) for k in
          ("imageset", "camera", "point", "pixel", "valid")),
        grid_shape=_get(table, "grid_shape"),
        device=default_device(device), dtype=dtype,
    )


def _numpy(t):
    return t.detach().cpu().numpy()


def _model_to_numpy(m):
    if isinstance(m, NoncentralGenericModel):
        return {"direction_grid": _numpy(m.direction_grid),
                "point_grid": _numpy(m.point_grid)}
    if isinstance(m, CentralGenericModel):
        return _numpy(m.grid)
    out = {"kind": _KIND_NAMES[type(m)], "params": _numpy(m.params),
           "width": m.width, "height": m.height}
    if isinstance(m, CentralThinPrismFisheyeModel):
        out["use_equidistant_projection"] = m.use_equidistant_projection
    return out


def state_to_numpy(state: BAState) -> dict:
    """The state's arrays as numpy.  Intrinsics: a tuple with, per camera,
    the grid of a central model, a dict of both grids (``direction_grid``,
    ``point_grid``) of a noncentral one, or a dict that
    :func:`parametric_model` reads back (``kind``, ``params``, ``width``,
    ``height`` and ``use_equidistant_projection`` where it applies) of a
    parametric one."""
    out = {k: _numpy(getattr(state, k)) for k in _STATE_ARRAYS}
    out["intrinsics"] = tuple(_model_to_numpy(m) for m in state.intrinsics)
    return out

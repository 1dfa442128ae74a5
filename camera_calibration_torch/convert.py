"""Carry states, models and observation tables into the port.

The reference package's ``BAState``, ``CentralGenericModel`` and
``ObservationTable`` are given as numpy arrays: either a dict keyed by the
field names or any object with those attributes (array-likes are read with
``numpy.asarray``).  The converters build the port's objects on a device,
by default the card.  Floating arrays keep their dtype unless ``dtype`` is
given; index columns become int64.
"""

from __future__ import annotations

import numpy as np
import torch

from camera_calibration_torch.ba.dataset import ObservationTable, table_from_numpy
from camera_calibration_torch.ba.state import BAState
from camera_calibration_torch.config import default_device
from camera_calibration_torch.models.central_generic import CentralGenericModel

_MODEL_INTS = ("width", "height", "calibration_min_x", "calibration_min_y",
               "calibration_max_x", "calibration_max_y")
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


def ba_state(state, device=None, dtype=None) -> BAState:
    device = default_device(device)
    return BAState(
        **{k: _tensor(_get(state, k), device, dtype) for k in _STATE_ARRAYS},
        intrinsics=tuple(central_generic_model(m, device, dtype)
                         for m in _get(state, "intrinsics")),
    )


def observation_table(table, device=None, dtype=None) -> ObservationTable:
    return table_from_numpy(
        *(np.array(_get(table, k)) for k in
          ("imageset", "camera", "point", "pixel", "valid")),
        grid_shape=_get(table, "grid_shape"),
        device=default_device(device), dtype=dtype,
    )


def state_to_numpy(state: BAState) -> dict:
    """The state's arrays as numpy (intrinsics as a tuple of grids)."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in _STATE_ARRAYS}
    out["intrinsics"] = tuple(m.grid.detach().cpu().numpy()
                              for m in state.intrinsics)
    return out

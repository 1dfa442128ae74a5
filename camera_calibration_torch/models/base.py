"""Camera-model conventions shared by every model.

Models are frozen dataclasses: tensors hold the parameters, plain Python
fields hold the configuration (image size, calibrated area).  A model is
updated by building a new one with :func:`replace`.

Pixel conventions: "pixel-corner" coordinates put the origin at the
top-left corner of the top-left pixel, so the center of pixel (i, j) is
(i + 0.5, j + 0.5); observations are stored in pixel-corner convention.
"""

from __future__ import annotations

import dataclasses


def replace(model, **kwargs):
    return dataclasses.replace(model, **kwargs)


def cast_floating(obj, dtype=None, device=None):
    """``obj`` with every floating-point tensor moved to ``device`` and cast
    to ``dtype`` (either may be None: unchanged), through dataclasses,
    tuples and lists (a model, a BAState, observation tables).  Integer
    and boolean tensors only move; other fields are kept."""
    import torch

    if isinstance(obj, torch.Tensor):
        # move first: the cast then runs on the target device
        if device is not None:
            obj = obj.to(device)
        if dtype is not None and obj.is_floating_point():
            obj = obj.to(dtype)
        return obj
    if isinstance(obj, (tuple, list)):
        return type(obj)(cast_floating(x, dtype, device) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: cast_floating(getattr(obj, f.name), dtype, device)
            for f in dataclasses.fields(obj) if f.init})
    return obj

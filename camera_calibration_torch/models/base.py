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

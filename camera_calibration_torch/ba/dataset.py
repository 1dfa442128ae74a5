"""Observation tables for device-side bundle adjustment.

An ``ObservationTable`` holds the observations of one camera as columns
(imageset, camera and point indices, measured pixel, validity).  Validity
masks replace dynamic sizes, so padded rows contribute nothing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ObservationTable:
    """Columnar observation table.

    When ``grid_shape=(M, P)`` is set the table is in *grid layout*: row
    ``m * P + p`` holds the observation of point ``p`` in imageset ``m``
    (invalid where unobserved).  Segment reductions are then reshapes and
    axis sums, and state gathers are broadcasts.
    """

    imageset: torch.Tensor  # (N,) int64
    camera: torch.Tensor  # (N,) int64
    point: torch.Tensor  # (N,) int64 — index into the points array
    pixel: torch.Tensor  # (N, 2)
    valid: torch.Tensor  # (N,) bool
    grid_shape: tuple | None = None  # (M, P) when in grid layout

    @property
    def count(self):
        return self.pixel.shape[0]


def split_by_camera(obs: ObservationTable, segments) -> tuple:
    """Split a camera-sorted table into per-camera tables ((start, count)
    slices)."""
    return tuple(
        ObservationTable(
            imageset=obs.imageset[s:s + c],
            camera=obs.camera[s:s + c],
            point=obs.point[s:s + c],
            pixel=obs.pixel[s:s + c],
            valid=obs.valid[s:s + c],
        )
        for s, c in segments
    )


def pad_table(obs: ObservationTable, multiple: int) -> ObservationTable:
    """Pad a table's observation axis to a multiple (invalid rows).

    Index columns are padded with their last entry (not 0), so a pose-major
    sorted table stays sorted; padded rows are invalid and contribute zeros.
    """
    n = obs.count
    cap = ((n + multiple - 1) // multiple) * multiple
    if cap == n:
        return obs
    pad = cap - n

    def pad_idx(a):
        if a.shape[0]:
            fill = a[-1:].expand(pad)
        else:
            fill = torch.zeros(pad, dtype=a.dtype, device=a.device)
        return torch.cat([a, fill])

    return ObservationTable(
        imageset=pad_idx(obs.imageset),
        camera=pad_idx(obs.camera),
        point=pad_idx(obs.point),
        pixel=torch.cat([obs.pixel, obs.pixel.new_zeros((pad, 2))]),
        valid=torch.cat([obs.valid, obs.valid.new_zeros(pad)]),
    )


def to_grid_layout(
    obs: ObservationTable, n_imagesets: int, n_points: int
) -> ObservationTable:
    """Re-lay a (single-camera) table into dense (M, P) grid layout.

    Row ``m * P + p`` of the result is the observation of point ``p`` in
    imageset ``m`` (invalid where unobserved).  At most one observation per
    (imageset, point) pair is assumed, as a board point appears once per
    image.
    """
    m, p = int(n_imagesets), int(n_points)
    dev = obs.pixel.device
    valid = obs.valid
    slot = (obs.imageset * p + obs.point)[valid]
    pixel = obs.pixel.new_zeros((m * p, 2))
    pixel[slot] = obs.pixel[valid]
    vout = torch.zeros(m * p, dtype=torch.bool, device=dev)
    vout[slot] = True
    cam0 = int(obs.camera[0]) if obs.count else 0
    return ObservationTable(
        imageset=torch.arange(m, device=dev).repeat_interleave(p),
        camera=torch.full((m * p,), cam0, dtype=torch.int64, device=dev),
        point=torch.arange(p, device=dev).repeat(m),
        pixel=pixel,
        valid=vout,
        grid_shape=(m, p),
    )


def table_from_numpy(imageset, camera, point, pixel, valid, grid_shape=None,
                     *, device, dtype=None) -> ObservationTable:
    """An ObservationTable on ``device`` from array-likes."""
    pixel = np.asarray(pixel)
    return ObservationTable(
        imageset=torch.as_tensor(np.asarray(imageset, np.int64), device=device),
        camera=torch.as_tensor(np.asarray(camera, np.int64), device=device),
        point=torch.as_tensor(np.asarray(point, np.int64), device=device),
        pixel=torch.as_tensor(pixel, dtype=dtype, device=device),
        valid=torch.as_tensor(np.asarray(valid, bool), device=device),
        grid_shape=None if grid_shape is None else tuple(int(v) for v in grid_shape),
    )

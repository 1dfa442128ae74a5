"""Calibration datasets and observation tables for device-side bundle
adjustment.

A ``Dataset`` holds per-camera image sizes, a list of imagesets (one time
instant across the rig, with per-camera feature lists) and the known pattern
geometries that map a feature id to its position on the board.  An
``ObservationTable`` holds the observations of one camera as columns
(imageset, camera and point indices, measured pixel, validity).  Validity
masks replace dynamic sizes, so padded rows contribute nothing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from camera_calibration_torch.config import default_device


@dataclasses.dataclass
class PointFeature:
    """One detected feature."""

    xy: np.ndarray  # (2,) pixel-corner convention
    feature_id: int


@dataclasses.dataclass
class Imageset:
    """Features of all cameras at one instant."""

    features: list[list[PointFeature]]  # [camera][feature]
    filenames: list[str] | None = None


@dataclasses.dataclass
class KnownGeometry:
    """A pattern sheet: cell length and feature id -> integer position."""

    cell_length_in_meters: float
    feature_id_to_position: dict[int, tuple[float, float]]


@dataclasses.dataclass
class Dataset:
    """A full calibration dataset."""

    num_cameras: int
    image_sizes: list[tuple[int, int]]  # (width, height) per camera
    imagesets: list[Imageset] = dataclasses.field(default_factory=list)
    known_geometries: list[KnownGeometry] = dataclasses.field(
        default_factory=list)

    def feature_id_count(self) -> int:
        m = -1
        for g in self.known_geometries:
            if g.feature_id_to_position:
                m = max(m, max(g.feature_id_to_position.keys()))
        for s in self.imagesets:
            for feats in s.features:
                for f in feats:
                    m = max(m, f.feature_id)
        return m + 1

    def merge(self, other: "Dataset") -> None:
        """Merge another dataset into this one for joint calibration.

        The other dataset's pattern sheets become new known geometries: its
        feature ids are offset past this dataset's largest, so corners of
        distinct printouts never alias, and its imagesets are appended.
        Raises ValueError on a camera-count or image-size mismatch.
        """
        if self.num_cameras != other.num_cameras:
            raise ValueError(
                f"cannot merge datasets with {self.num_cameras} vs "
                f"{other.num_cameras} cameras")
        for ci in range(self.num_cameras):
            if tuple(self.image_sizes[ci]) != tuple(other.image_sizes[ci]):
                raise ValueError(
                    f"camera {ci} image size mismatch: "
                    f"{self.image_sizes[ci]} vs {other.image_sizes[ci]}")
        offset = self.feature_id_count()
        for g in other.known_geometries:
            self.known_geometries.append(KnownGeometry(
                cell_length_in_meters=g.cell_length_in_meters,
                feature_id_to_position={
                    fid + offset: pos
                    for fid, pos in g.feature_id_to_position.items()}))
        for s in other.imagesets:
            self.imagesets.append(Imageset(
                features=[[PointFeature(xy=np.asarray(f.xy),
                                        feature_id=f.feature_id + offset)
                           for f in feats] for feats in s.features],
                filenames=list(s.filenames) if s.filenames else None))


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


def pad_table(obs: ObservationTable, multiple: int = 1,
              count: int | None = None) -> ObservationTable:
    """Pad a table's observation axis (invalid rows) to a multiple of
    ``multiple``, or to exactly ``count`` rows when that is given.

    Index columns are padded with their last entry (not 0), so a pose-major
    sorted table stays sorted; padded rows are invalid and contribute zeros.
    """
    n = obs.count
    cap = ((n + multiple - 1) // multiple) * multiple if count is None \
        else count
    if cap < n:
        raise ValueError(f"cannot pad {n} rows to {cap}")
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


def build_per_camera_tables(
    dataset: Dataset,
    feature_id_to_point_index: dict[int, int],
    *,
    image_used=None,
    dtype=torch.float64,
    device=None,
) -> tuple:
    """One ObservationTable per camera from a Dataset, on ``device``
    (default: the card).

    ``image_used``: optional per-imageset bool mask; imagesets beyond its
    length count as used (images appended after a resume).
    """
    device = default_device(device)
    tables = []
    for ci in range(dataset.num_cameras):
        ims, ptids, pixels = [], [], []
        for i, s in enumerate(dataset.imagesets):
            if image_used is not None and i < len(image_used) \
                    and not image_used[i]:
                continue
            for f in s.features[ci]:
                if f.feature_id in feature_id_to_point_index:
                    ims.append(i)
                    ptids.append(feature_id_to_point_index[f.feature_id])
                    pixels.append(np.asarray(f.xy, np.float64))
        n = len(ims)
        tables.append(table_from_numpy(
            ims, np.full(n, ci), ptids,
            np.stack(pixels) if n else np.zeros((0, 2)), np.ones(n, bool),
            device=device, dtype=dtype))
    return tuple(tables)


def build_observation_table(
    dataset: Dataset,
    feature_id_to_point_index: dict[int, int],
    *,
    pad_to: int | None = None,
    dtype=torch.float64,
    device=None,
) -> ObservationTable:
    """Flatten a Dataset into one padded ObservationTable on ``device``
    (default: the card); rows past the observations are invalid zeros."""
    device = default_device(device)
    ims, cams, pts, pix = [], [], [], []
    for si, s in enumerate(dataset.imagesets):
        for ci, feats in enumerate(s.features):
            for f in feats:
                if f.feature_id in feature_id_to_point_index:
                    ims.append(si)
                    cams.append(ci)
                    pts.append(feature_id_to_point_index[f.feature_id])
                    pix.append(np.asarray(f.xy, np.float64))
    n = len(ims)
    cap = pad_to or max(1, n)
    if n > cap:
        raise ValueError(f"pad_to={cap} < observation count {n}")

    def pad_i(a):
        out = np.zeros(cap, np.int64)
        out[:n] = a
        return out

    pixel = np.zeros((cap, 2), np.float64)
    if n:
        pixel[:n] = np.stack(pix)
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return table_from_numpy(pad_i(ims), pad_i(cams), pad_i(pts), pixel, valid,
                            device=device, dtype=dtype)

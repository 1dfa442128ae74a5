"""Binary dataset IO in the ``dataset.bin`` format.

Format: ``calib_data`` magic, u32 version 0,
u32 num_cameras + per-camera u32 width/height, u32 num_imagesets each with
u32-length filename and per-camera feature lists (f32 x, f32 y, i32 id),
u32 num_known_geometries each with f32 cell length and (i32 id, i32 x,
i32 y) position entries.  Little-endian throughout.
"""

from __future__ import annotations

import struct

import numpy as np

from camera_calibration_torch.ba.dataset import (
    Dataset,
    Imageset,
    KnownGeometry,
    PointFeature,
)

MAGIC = b"calib_data"


def save_dataset(path, dataset: Dataset):
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", 0))
        f.write(struct.pack("<I", dataset.num_cameras))
        for (w, h) in dataset.image_sizes:
            f.write(struct.pack("<II", w, h))
        f.write(struct.pack("<I", len(dataset.imagesets)))
        for i, s in enumerate(dataset.imagesets):
            filename = b""
            if s.filenames:
                filename = (s.filenames[0] or "").encode()
            f.write(struct.pack("<I", len(filename)))
            f.write(filename)
            for ci in range(dataset.num_cameras):
                feats = s.features[ci] if ci < len(s.features) else []
                f.write(struct.pack("<I", len(feats)))
                for feat in feats:
                    f.write(
                        struct.pack(
                            "<ffi",
                            float(feat.xy[0]),
                            float(feat.xy[1]),
                            int(feat.feature_id),
                        )
                    )
        f.write(struct.pack("<I", len(dataset.known_geometries)))
        for g in dataset.known_geometries:
            f.write(struct.pack("<f", g.cell_length_in_meters))
            f.write(struct.pack("<I", len(g.feature_id_to_position)))
            # sorted by feature id: any order reads back the same, and
            # sorting makes the bytes reproducible
            for fid in sorted(g.feature_id_to_position):
                pos = g.feature_id_to_position[fid]
                f.write(struct.pack("<iii", int(fid), int(pos[0]), int(pos[1])))


def load_datasets(paths) -> Dataset:
    """Load one or more dataset.bin files and merge them for joint
    calibration.

    ``paths`` may be a single path, a comma-separated string, or a list.
    Later files' feature IDs are offset so pattern sheets from different
    recordings stay distinct (``Dataset.merge``).
    """
    if isinstance(paths, str):
        paths = [p for p in paths.split(",") if p]
    merged = None
    for p in paths:
        ds = load_dataset(p)
        if merged is None:
            merged = ds
        else:
            merged.merge(ds)
    if merged is None:
        raise ValueError("no dataset files given")
    return merged


def load_dataset(path) -> Dataset:
    with open(path, "rb") as f:
        data = f.read()
    if data[:10] != MAGIC:
        raise ValueError(f"not a calib_data file: {path}")
    off = 10

    def read(fmt):
        nonlocal off
        size = struct.calcsize(fmt)
        out = struct.unpack_from("<" + fmt, data, off)
        off += size
        return out

    (version,) = read("I")
    if version != 0:
        raise ValueError(f"unsupported dataset version {version}")
    (num_cameras,) = read("I")
    image_sizes = [tuple(read("II")) for _ in range(num_cameras)]
    (num_imagesets,) = read("I")
    imagesets = []
    for _ in range(num_imagesets):
        (name_len,) = read("I")
        filename = data[off : off + name_len].decode()
        off += name_len
        features = []
        for _ci in range(num_cameras):
            (n,) = read("I")
            feats = []
            for _k in range(n):
                x, y, fid = read("ffi")
                feats.append(PointFeature(xy=np.array([x, y]), feature_id=fid))
            features.append(feats)
        imagesets.append(Imageset(features=features, filenames=[filename]))
    (num_geom,) = read("I")
    geoms = []
    for _ in range(num_geom):
        (cell,) = read("f")
        (n,) = read("I")
        mapping = {}
        for _k in range(n):
            fid, x, y = read("iii")
            mapping[fid] = (x, y)
        geoms.append(
            KnownGeometry(cell_length_in_meters=cell, feature_id_to_position=mapping)
        )
    return Dataset(
        num_cameras=num_cameras,
        image_sizes=image_sizes,
        imagesets=imagesets,
        known_geometries=geoms,
    )

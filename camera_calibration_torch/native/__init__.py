"""Native (C++) host components of dense initialization, bound with ctypes.

``densify.cpp`` rasterizes detected pattern squares into per-pixel pattern
points through per-square 4-point homographies, and evaluates the star
pattern's intensity.  At first use it is compiled with
``g++ -O3 -shared -fPIC`` into ``camera_calibration_torch/_build/<hash of
the source and flags>/``, so an edited source rebuilds and an unchanged one
is loaded from disk.  A failed build raises with the compiler's message:
there is no quiet fallback.  ``init.dense_init.densify_matches_plain`` is
the NumPy version that the tests hold the native one against.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "densify.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIB_NAME = f"libcct_native_{sys.implementation.cache_tag}.so"

_state = {"lib": None}

# Calls per native function (reset with reset_calls).
calls: collections.Counter = collections.Counter()


def reset_calls() -> None:
    calls.clear()


def source_hash() -> str:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``densify.cpp`` if needed; return the shared library's path."""
    out_dir = BUILD_ROOT / source_hash()
    so = out_dir / LIB_NAME
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = ["g++", *FLAGS, str(SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError("g++ not found: it is needed to build "
                           f"{SRC.name}") from exc
    if r.returncode != 0:
        raise RuntimeError(f"building {SRC.name} failed ({' '.join(cmd)}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, so)
    return so


def lib():
    """The loaded library (built at first use)."""
    if _state["lib"] is None:
        handle = ctypes.CDLL(str(build()))
        handle.densify_matches.restype = ctypes.c_long
        handle.densify_matches.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # corners_img
            ctypes.POINTER(ctypes.c_long),  # cells
            ctypes.c_long,  # n_squares
            ctypes.c_double,  # cell_len
            ctypes.POINTER(ctypes.c_double),  # r_kg
            ctypes.POINTER(ctypes.c_double),  # t_kg
            ctypes.c_long,  # bw
            ctypes.c_long,  # bh
            ctypes.c_double,  # scale_x
            ctypes.c_double,  # scale_y
            ctypes.POINTER(ctypes.c_double),  # pts
            ctypes.POINTER(ctypes.c_ubyte),  # valid
        ]
        handle.pattern_intensity.restype = None
        handle.pattern_intensity.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),
        ]
        _state["lib"] = handle
    return _state["lib"]


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def densify_matches_native(corners_img, cells, cell_len, r_kg, t_kg,
                           bw, bh, scale_x, scale_y, pts, valid):
    """Rasterize squares into (pts, valid) buffers in place.

    corners_img: (n, 4, 2) float64; cells: (n, 2) int64; pts: (bh, bw, 3)
    float64 (NaN-initialized); valid: (bh, bw) uint8.
    Returns the number of newly written pixels.
    """
    corners_img = np.ascontiguousarray(corners_img, np.float64)
    cells = np.ascontiguousarray(cells, np.int64)
    r_kg = np.ascontiguousarray(r_kg, np.float64)
    t_kg = np.ascontiguousarray(t_kg, np.float64)
    if not (pts.flags["C_CONTIGUOUS"] and valid.flags["C_CONTIGUOUS"]):
        raise ValueError("pts and valid must be C-contiguous")
    if pts.dtype != np.float64 or valid.dtype != np.uint8:
        raise TypeError("pts must be float64 and valid uint8")
    handle = lib()
    calls["densify_matches"] += 1
    return handle.densify_matches(
        _ptr(corners_img, ctypes.c_double),
        _ptr(cells, ctypes.c_long),
        corners_img.shape[0],
        float(cell_len),
        _ptr(r_kg, ctypes.c_double),
        _ptr(t_kg, ctypes.c_double),
        int(bw), int(bh), float(scale_x), float(scale_y),
        _ptr(pts, ctypes.c_double),
        _ptr(valid, ctypes.c_ubyte),
    )


def pattern_intensity_native(positions, num_segments):
    """Star-pattern intensity at (..., 2) positions: 1 white, 0 black, 0.5
    at the centers."""
    positions = np.ascontiguousarray(positions, np.float64)
    flat = positions.reshape(-1, 2)
    out = np.empty(flat.shape[0], np.float64)
    handle = lib()
    calls["pattern_intensity"] += 1
    handle.pattern_intensity(
        _ptr(flat, ctypes.c_double), flat.shape[0], int(num_segments),
        _ptr(out, ctypes.c_double),
    )
    return out.reshape(positions.shape[:-1])

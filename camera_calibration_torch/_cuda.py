"""Build, load and call the hand-written CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface.  At first use the sources are compiled
with ``nvcc`` for ``sm_90a``, one process per source, all started together,
then linked into one shared library that is loaded with ``ctypes``.  The
build lands in ``camera_calibration_torch/_build/<hash of the sources and
flags>/``, so an edited source rebuilds and an unchanged one is loaded from
disk.  The build reads nothing but this package's sources.

Every C entry point launches on the stream it is given (PyTorch's current
stream), does not synchronise, allocates nothing, and returns
``cudaGetLastError()``; :func:`check` turns a non-zero status into an
exception.  :data:`launches` counts, per kernel, the wrapper calls that
launched it.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = (
    "project.cu",
    "project_noncentral.cu",
    "schur_legs.cu",
    "window_apply_j.cu",
    "window_apply_jtw.cu",
    "window_block_diag.cu",
)
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]
LIB_NAME = "libcct_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points and their argument types (pointers and the stream as
# c_void_p, so ctypes never truncates them to 32 bits).
SIGNATURES = {
    # dirs, g0, grid, n, gh, gw, lo_x, lo_y, hi_x, hi_y, iters, eps,
    # g_out, cost_out, stream
    "cct_project": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _I, _F,
                    _P, _P, _P],
    # dirs, g0, grid, t1, t2, n, gh, gw, lo_x, lo_y, hi_x, hi_y, iters,
    # eps, inv_sx, inv_sy, g_out, cost_out, ppx_out, jwin_out, base_out,
    # stream
    "cct_project_blocks": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F,
                           _I, _F, _F, _F, _P, _P, _P, _P, _P, _P],
    # points, init (or None), dirs, origins, n, gh, gw, min_x, min_y, ext_x,
    # ext_y, cx, cy, lo_x, lo_y, hi_x, hi_y, iters, eps, px_out, g_out,
    # cost_out, valid_out, stream
    "cct_project_noncentral": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F,
                               _F, _F, _F, _F, _F, _F, _I, _F, _P, _P, _P,
                               _P, _P],
    # jwin, base, base_sn, base_sc, tangent, n, gh, gw, k, elem_bytes, out,
    # stream (elem_bytes: 4 for a float32 j_win, 2 for a bfloat16 one)
    "cct_window_apply_j": [_P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P],
    # jwin, base, base_sn, base_sc, ws, n, gh, gw, k, elem_bytes, band_rows,
    # partial, nblocks, out, stream
    "cct_window_apply_jtw": [_P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P,
                             _I, _P, _P],
    # jwin, base, base_sn, base_sc, w, n, gh, gw, k, elem_bytes (4 only),
    # band_rows, partial, nblocks, out, stream
    "cct_window_block_diag": [_P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I,
                              _P, _I, _P, _P],
    # jrig, jcam, jpt, w, s_intr, x_rig, x_cam, m, p, elem_bytes, rows,
    # t_in (or None), partial, tickets, t_out, stream
    "cct_schur_point_leg": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                            _P, _P, _P, _P],
    # jrig, jcam, jpt, w, s_intr, x_rig, x_cam (the three or none), t,
    # d_inv, m, p, elem_bytes, ws_out, rig_out, accumulate, cam_partial,
    # tickets, cam_out, stream
    "cct_schur_pose_leg": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _P, _P, _I, _P, _P, _P, _P],
    # m, p, elem_bytes, out (4 ints): cct_schur_point_leg's launch plan
    "cct_schur_point_leg_plan": [_I, _I, _I, _P],
    # blocks (0: cct_project, 1: cct_project_blocks), gh, gw: the kernel's
    # blocks that fit on one SM, its threads per block, one block's shared
    # memory
    "cct_project_blocks_per_sm": [_I, _I, _I],
    "cct_project_threads": [_I, _I, _I],
    "cct_project_smem_bytes": [_I, _I, _I],
    # blocks, gh, gw: 1 where the kernel stages its fields in shared memory,
    # 0 where it reads them from device memory
    "cct_project_staged": [_I, _I, _I],
    # gh, gw, out (4 ints): cct_project_noncentral's launch plan
    "cct_project_noncentral_plan": [_I, _I, _P],
    # k, n, out (3 ints): cct_window_apply_j's launch plan
    "cct_window_apply_j_plan": [_I, _I, _P],
    # k, gh, gw, elem_bytes: blocks of the reduction's partial pass that
    # fit on one SM
    "cct_window_apply_jtw_blocks_per_sm": [_I, _I, _I, _I],
    "cct_window_block_diag_blocks_per_sm": [_I, _I, _I, _I],
    # k, gh, gw, elem_bytes: shared memory of one block of the partial pass
    "cct_window_apply_jtw_smem_bytes": [_I, _I, _I, _I],
    "cct_window_block_diag_smem_bytes": [_I, _I, _I, _I],
    # k, gh, gw, elem_bytes: grid rows per band of the partial pass
    "cct_window_apply_jtw_band_rows": [_I, _I, _I, _I],
    "cct_window_block_diag_band_rows": [_I, _I, _I, _I],
}

# Entry points that return another type than an int status or count.
RESTYPES = {
    "cct_project_smem_bytes": ctypes.c_longlong,
    "cct_window_apply_jtw_smem_bytes": ctypes.c_longlong,
    "cct_window_block_diag_smem_bytes": ctypes.c_longlong,
}

# Shared memory one block may use on Hopper (227 KB); one SM's (228 KB),
# of which each resident block takes 1 KB for the system; threads of one
# SM.
MAX_SMEM_BYTES = 232448
SM_SMEM_BYTES = 233472
BLOCK_RESERVED_SMEM = 1024
SM_THREADS = 2048

# Launches per kernel, counted by the wrappers (reset with reset_launches).
launches: collections.Counter = collections.Counter()

_state = {"lib": None}
# The library's C entries, looked up once each (name -> ctypes function).
_entries: dict = {}


def reset_launches() -> None:
    launches.clear()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH + FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if needed; return the build directory."""
    out_dir = BUILD_ROOT / source_hash()
    if (out_dir / LIB_NAME).exists():
        return out_dir
    nvcc = nvcc_path()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_ROOT / f"tmp-{os.getpid()}-{out_dir.name}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    procs = []
    for src in SOURCES:
        obj = tmp / (Path(src).stem + ".o")
        cmd = [nvcc, *ARCH, *FLAGS, "-I", str(CSRC), "-c", str(CSRC / src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    (tmp / "ptxas.txt").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp / LIB_NAME),
         *[str(obj) for _s, obj, _p in procs], "-lcudart"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("linking the kernels failed:\n" + link.stdout)
    try:
        os.replace(tmp, out_dir)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return out_dir


def build_log() -> str:
    """The ``-Xptxas -v`` report of the current build (registers, shared
    memory and spills of every kernel)."""
    return (build() / "ptxas.txt").read_text()


def lib():
    """The loaded kernel library (built at first use)."""
    if _state["lib"] is None:
        handle = ctypes.CDLL(str(build() / LIB_NAME))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        _state["lib"] = handle
    return _state["lib"]


def launch(name: str, *args, counted: str | None = None) -> None:
    """Call C entry ``cct_<name>`` on the current stream; count it (under
    ``counted``, the kernel variant's name, where given) and raise on a
    non-zero ``cudaError_t``.  The stream is PyTorch's current stream of the
    current device, read as its raw handle (no Stream object a call)."""
    entry = _entries.get(name)
    if entry is None:
        entry = _entries[name] = getattr(lib(), "cct_" + name)
    status = entry(*args, torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device()))
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
    launches[counted or name] += 1


def check_smem(nbytes: int, name: str) -> None:
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(
            f"{name}: needs {nbytes} bytes of shared memory per block, above "
            f"the {MAX_SMEM_BYTES}-byte limit of one Hopper block"
        )


def require_cuda_f32(name: str, dtypes=(torch.float32,), **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of one of
    ``dtypes`` (float32 unless a kernel also reads another type)."""
    for key, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is not on the card")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {key} must be one of {dtypes} on the "
                            f"card, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def num_sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def persistent_blocks(n: int, tile: int, blocks_per_sm: int,
                      num_sms: int) -> int:
    """Blocks of a persistent kernel that walks N items in tiles of
    ``tile``: at most as many as are resident on the card at once, and no
    more than it takes to give every block the same number of tiles (but
    for the last few)."""
    tiles = -(-n // tile)
    per_block = -(-tiles // (blocks_per_sm * num_sms))
    return -(-tiles // per_block)

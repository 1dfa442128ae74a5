"""The pose and point legs of the point-eliminated Schur matvec on grid
tables: CUDA kernels and their plain PyTorch versions.

One camera's observation table in grid layout holds row ``n = m·P + p``
for imageset m and point p, with the Jacobian blocks ``j_rig``, ``j_cam``
(n, 2, 6), ``j_point`` (n, 2, 3) and the weight (n,).  With the
intrinsics part ``s_intr = J_intr·x_intr`` (n, 2) computed apart (the
window kernels or a dense einsum), the two passes of the reduced matvec
are (``csrc/schur_legs.cu``):

- :func:`point_leg` (pass A): ``s = J_rig·x_rig[m] + J_cam·x_cam + s_intr``
  and ``t[p] = t_in[p] + Σ_m J_pointᵀ·w·s`` (P, 3);
- :func:`pose_leg` (pass B): ``y = D⁻¹·t`` with the damped 3×3 inverses,
  ``ws = w·(s − J_point·y)`` (n, 2), returned for ``J_intrᵀ·ws``; the
  rig rows ``Σ_p J_rigᵀ·ws`` and the camera's ``Σ J_camᵀ·ws`` written into
  the caller's views of its flat output.  With no ``x`` (the reduced
  right-hand side) s is 0.

The grid einsums of the plain versions (:func:`grid_jv_imageset` and its
kin) are the ones the solve's per-group legs use.  A tensor on the CPU
goes to the plain version; a CUDA float32 or bfloat16 set of Jacobians
with float32 vectors goes to the kernel; anything else raises.  On tables
sharded in bands of imagesets each band is a grid of its own (M its
imagesets), given the band's rows of ``x_rig`` and ``rig_out``.  The kernels'
launches are counted as ``schur_point_leg`` and ``schur_pose_leg``
(``_bf16`` for bfloat16 Jacobians, the CG matvecs' copies).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from camera_calibration_torch import _cuda
from camera_calibration_torch.ba import residuals as res

JACOBIAN_DTYPES = (torch.float32, torch.bfloat16)


# The grid einsums of a table in grid layout (row n = m·P + p): J·v and
# JᵀW·s against per-imageset (M, k) and per-point (P, k) vectors.  The
# solve's per-group legs (``lm_pcg._jv_imageset`` and its kin) and the plain
# passes below both use them.  A (bfloat16) Jacobian meets the vector's type.


def grid_jv_imageset(j, arr, grid_shape):
    """``J[n]·arr[m]``: einsum('mpik,mk->mpi'), (n, 2)."""
    j = res.as_dtype_of(j, arr)
    jg = j.reshape(tuple(grid_shape) + j.shape[1:])
    return torch.einsum("mpik,mk->mpi", jg, arr).reshape(j.shape[:2])


def grid_jv_point(j, arr, grid_shape):
    """``J[n]·arr[p]``: einsum('mpik,pk->mpi'), (n, 2)."""
    j = res.as_dtype_of(j, arr)
    jg = j.reshape(tuple(grid_shape) + j.shape[1:])
    return torch.einsum("mpik,pk->mpi", jg, arr).reshape(j.shape[:2])


def grid_jtw_imageset(j, ws, grid_shape):
    """``Σ_p J[n]ᵀ·ws[n]``: einsum('mpik,mpi->mk'), (M, k)."""
    j = res.as_dtype_of(j, ws)
    gs = tuple(grid_shape)
    return torch.einsum("mpik,mpi->mk", j.reshape(gs + j.shape[1:]),
                        ws.reshape(gs + (2,)))


def grid_jtw_point(j, ws, grid_shape):
    """``Σ_m J[n]ᵀ·ws[n]``: einsum('mpik,mpi->pk'), (P, k)."""
    j = res.as_dtype_of(j, ws)
    gs = tuple(grid_shape)
    return torch.einsum("mpik,mpi->pk", j.reshape(gs + j.shape[1:]),
                        ws.reshape(gs + (2,)))


def _s_plain(j_rig, j_cam, s_intr, x_rig, x_cam, grid_shape):
    """J_rig·x_rig[m] + J_cam·x_cam + s_intr: (n, 2)."""
    s = grid_jv_imageset(j_rig, x_rig, grid_shape)
    s = s + torch.einsum("nik,k->ni", res.as_dtype_of(j_cam, x_cam), x_cam)
    return s + s_intr


def point_leg_plain(j_rig, j_cam, j_point, weight, s_intr, x_rig, x_cam,
                    grid_shape, t_in=None):
    """Pass A in plain PyTorch: ``t_in + Σ_m J_pointᵀ·w·s`` (P, 3)."""
    s = _s_plain(j_rig, j_cam, s_intr, x_rig, x_cam, grid_shape)
    t = grid_jtw_point(j_point, s * weight[:, None], grid_shape)
    return t if t_in is None else t_in + t


def pose_leg_plain(j_rig, j_cam, j_point, weight, s_intr, x_rig, x_cam, t,
                   d_inv, grid_shape, rig_out, cam_out, accumulate=False):
    """Pass B in plain PyTorch; returns ws (n, 2) and writes (adds, where
    ``accumulate``) ``Σ_p J_rigᵀ·ws`` into ``rig_out`` (M, 6) and writes
    ``Σ J_camᵀ·ws`` into ``cam_out`` (6,).  ``x_rig`` None: s = 0."""
    y = torch.einsum("pjk,pk->pj", d_inv, t)
    u2 = grid_jv_point(j_point, y, grid_shape)
    if x_rig is None:
        diff = -u2
    else:
        diff = _s_plain(j_rig, j_cam, s_intr, x_rig, x_cam, grid_shape) - u2
    ws = diff * weight[:, None]
    rig = grid_jtw_imageset(j_rig, ws, grid_shape)
    if accumulate:
        rig_out.add_(rig)
    else:
        rig_out.copy_(rig)
    cam_out.copy_(torch.einsum("nik,ni->k", res.as_dtype_of(j_cam, ws), ws))
    return ws


# --------------------------------- kernels ---------------------------------


def _check(name, j_rig, j_cam, j_point, weight, grid_shape, **vectors):
    """Raise unless the kernel takes these inputs (types and layouts first,
    then the device); returns (M, P, element bytes)."""
    m, p = (int(v) for v in grid_shape)
    n = m * p
    dtype = j_rig.dtype
    if dtype not in JACOBIAN_DTYPES:
        raise TypeError(f"{name}: the Jacobians must be one of "
                        f"{JACOBIAN_DTYPES}, got {dtype}")
    for key, j, shape in (("j_rig", j_rig, (n, 2, 6)),
                          ("j_cam", j_cam, (n, 2, 6)),
                          ("j_point", j_point, (n, 2, 3))):
        if j.dtype != dtype:
            raise TypeError(f"{name}: {key} is {j.dtype}, j_rig {dtype}")
        if tuple(j.shape) != shape or not j.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous {shape} for "
                             f"the {m}x{p} grid, got {tuple(j.shape)}")
    vectors["weight"] = (weight, (n,))
    for key, (v, shape) in vectors.items():
        if v is None:
            continue
        if v.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {v.dtype}")
        if tuple(v.shape) != shape or not v.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous {shape}, got "
                             f"{tuple(v.shape)}")
    tensors = [j_rig, j_cam, j_point] + [v for v, _ in vectors.values()
                                         if v is not None]
    dev = j_rig.device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name}: every tensor must be on the card of "
                         "j_rig")
    elem = j_rig.element_size()
    # the kernels read a slot's rows as 16-, 8- or 4-byte words
    for key, j, align in (("j_rig", j_rig, 4 * elem), ("j_cam", j_cam,
                                                       4 * elem),
                          ("j_point", j_point, 2 * elem)):
        if j.data_ptr() % align:
            raise ValueError(f"{name}: {key} must be {align}-byte aligned")
    return m, p, elem


def _counted(name, j):
    return name + "_bf16" if j.dtype == torch.bfloat16 else name


@functools.cache
def point_leg_plan(m: int, p: int, elem_bytes: int, device_index: int):
    """The kernel library's launch plan of :func:`point_leg`
    (``cct_schur_point_leg_plan``): threads per block, point tiles, chunks
    of rows, rows per chunk."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        status = _cuda.lib().cct_schur_point_leg_plan(m, p, elem_bytes, out)
    if status != 0:
        raise RuntimeError(f"cct_schur_point_leg_plan: CUDA error {status}")
    return dict(zip(("threads", "tiles", "chunks", "rows"), out))


# Ticket counters of the kernels' last-block sums: zeros, and every launch
# leaves them zero, so the launches of one stream, which run in order, share
# them.  Each stream has its own, so two solves on two streams never count
# into one.  A stream being captured into a CUDA graph takes fresh zeros at
# each call: the graph sets them at every replay, and no buffer of the
# graph's memory is kept for launches outside it.
_tickets: dict = {}


def _tickets_for(device, n: int):
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(max(n, 64), dtype=torch.int32, device=device)
    key = (device.index, torch._C._cuda_getCurrentRawStream(device.index))
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = _tickets[key] = torch.zeros(max(n, 64), dtype=torch.int32,
                                        device=device)
    return t


def point_leg(j_rig, j_cam, j_point, weight, s_intr, x_rig, x_cam,
              grid_shape, t_in=None):
    """Pass A: ``t_in + Σ_m J_pointᵀ·w·(J_rig·x_rig[m] + J_cam·x_cam +
    s_intr)`` (P, 3), a new tensor."""
    if j_rig.device.type == "cpu":
        return point_leg_plain(j_rig, j_cam, j_point, weight, s_intr, x_rig,
                               x_cam, grid_shape, t_in)
    name = "schur_point_leg"
    m, p = (int(v) for v in grid_shape)
    m, p, elem = _check(name, j_rig, j_cam, j_point, weight, grid_shape,
                        s_intr=(s_intr, (m * p, 2)), x_rig=(x_rig, (m, 6)),
                        x_cam=(x_cam, (6,)), t_in=(t_in, (p, 3)))
    if s_intr is None or x_rig is None or x_cam is None:
        raise ValueError(f"{name}: s_intr, x_rig and x_cam are required")
    dev = j_rig.device
    plan = point_leg_plan(m, p, elem, dev.index)
    partial = torch.empty(plan["chunks"] * 3 * p, dtype=torch.float32,
                          device=dev)
    t_out = torch.empty((p, 3), dtype=torch.float32, device=dev)
    _cuda.launch(name, j_rig.data_ptr(), j_cam.data_ptr(), j_point.data_ptr(),
                 weight.data_ptr(), s_intr.data_ptr(), x_rig.data_ptr(),
                 x_cam.data_ptr(), m, p, elem, plan["rows"],
                 None if t_in is None else t_in.data_ptr(),
                 partial.data_ptr(),
                 _tickets_for(dev, plan["tiles"]).data_ptr(),
                 t_out.data_ptr(), counted=_counted(name, j_rig))
    return t_out


def pose_leg(j_rig, j_cam, j_point, weight, s_intr, x_rig, x_cam, t, d_inv,
             grid_shape, rig_out, cam_out, accumulate=False):
    """Pass B: returns ``ws = w·(s − J_point·D⁻¹t)`` (n, 2) and writes
    ``Σ_p J_rigᵀ·ws`` into ``rig_out`` (M, 6; added to where
    ``accumulate``) and ``Σ J_camᵀ·ws`` into ``cam_out`` (6,).  ``x_rig``,
    ``x_cam`` and ``s_intr`` None: s = 0 (the reduced right-hand side)."""
    if j_rig.device.type == "cpu":
        return pose_leg_plain(j_rig, j_cam, j_point, weight, s_intr, x_rig,
                              x_cam, t, d_inv, grid_shape, rig_out, cam_out,
                              accumulate)
    name = "schur_pose_leg"
    m, p = (int(v) for v in grid_shape)
    m, p, elem = _check(name, j_rig, j_cam, j_point, weight, grid_shape,
                        s_intr=(s_intr, (m * p, 2)), x_rig=(x_rig, (m, 6)),
                        x_cam=(x_cam, (6,)), t=(t, (p, 3)),
                        d_inv=(d_inv, (p, 3, 3)), rig_out=(rig_out, (m, 6)),
                        cam_out=(cam_out, (6,)))
    given = [v is not None for v in (s_intr, x_rig, x_cam)]
    if any(given) != all(given) or t is None or d_inv is None:
        raise ValueError(f"{name}: give s_intr, x_rig and x_cam together, "
                         "and t and d_inv")
    dev = j_rig.device
    ws = torch.empty((m * p, 2), dtype=torch.float32, device=dev)
    cam_partial = torch.empty(m * 6, dtype=torch.float32, device=dev)

    def ptr(v):
        return None if v is None else v.data_ptr()

    _cuda.launch(name, j_rig.data_ptr(), j_cam.data_ptr(), j_point.data_ptr(),
                 weight.data_ptr(), ptr(s_intr), ptr(x_rig), ptr(x_cam),
                 t.data_ptr(), d_inv.data_ptr(), m, p, elem, ws.data_ptr(),
                 rig_out.data_ptr(), int(accumulate), cam_partial.data_ptr(),
                 _tickets_for(dev, 1).data_ptr(), cam_out.data_ptr(),
                 counted=_counted(name, j_rig))
    return ws

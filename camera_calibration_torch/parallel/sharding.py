"""Multi-device scaling: observation sharding over a process group.

The reference is a single-node, single-GPU tool; the reference package
scales by sharding the per-camera observation tables along their
observation axis over a device mesh while the state (poses, points,
intrinsics) is replicated, and lets XLA GSPMD turn every sum over
observations into partial sums and an all-reduce.  The port does the
same over ``torch.distributed``, one process (rank) per device, with the
sums written out:

- :func:`shard_observations` gives each rank a slice of every camera's
  table and returns the slices as :class:`ShardedTables`, a tuple that
  carries its process group (:class:`Shard`).  A flat table is padded to
  a multiple of the world size (``pad_table``: invalid rows of weight 0,
  which add exact zeros) and cut into equal row ranges; a table in grid
  layout is cut into bands of whole imagesets, so each rank keeps the
  (imageset, point) layout of its band.
- The BA step (``ba/lm_pcg.py``) sees the group on the tables and sums
  across ranks at every point where it sums over observations: the
  tangent of each JᵀW·s (the gradient, the right-hand side, every CG
  matvec, the back-substitution), the whole block diagonal of JᵀWJ (the
  ``window_block_diag`` kernel's per-knot blocks included), the paired
  and full costs of the accept test, and the normal equations that
  ``schur_direct_solve`` assembles.  After each all-reduce every rank
  holds the same bits, so the host decisions (the accept test, the CG
  stop, λ) agree on every rank.  Unsharded tables call no collective.
- The state is replicated: :func:`replicate` broadcasts it from rank 0.
- :func:`shard_grid_blocks` splits, in addition, the per-knot work of the
  grid intrinsics by bands of knot rows.

The backend follows the tables' device: NCCL for CUDA tensors, gloo for
CPU tensors (:func:`backend_for`); a group of the other kind raises.
"""

from __future__ import annotations

import collections
import dataclasses

import torch
import torch.distributed as dist

from camera_calibration_torch.ba.dataset import ObservationTable, pad_table

# Collective calls made by the BA step and the helpers below, by kind
# ("all_reduce", "all_gather", "broadcast"); cleared by reset_collectives.
collectives: collections.Counter = collections.Counter()


def reset_collectives() -> None:
    collectives.clear()


def backend_for(device) -> str:
    """The process-group backend for tensors on ``device``: ``nccl`` for
    the card, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


@dataclasses.dataclass(frozen=True)
class Shard:
    """Where a rank's tables sit: its process group (None = the default
    group), rank and world size, whether the grid intrinsics' per-knot
    work is split by knot rows too (:func:`shard_grid_blocks`), and, per
    table, the first imageset of a grid-layout table's band (None for a
    flat table; empty where the tables were not cut by
    :func:`shard_observations`)."""

    group: object
    rank: int
    world_size: int
    grid_blocks: bool = False
    band_starts: tuple = ()


class ShardedTables(tuple):
    """A rank's per-camera observation tables, with their :class:`Shard`."""

    def __new__(cls, tables, shard: Shard):
        obj = super().__new__(cls, tables)
        obj.shard = shard
        return obj


def shard_of(data):
    """The :class:`Shard` of sharded tables, None for plain ones."""
    return getattr(data, "shard", None)


def _require_group(group, device):
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialized: call "
            "parallel.distributed.initialize first")
    backend = str(dist.get_backend(group)).lower()
    want = backend_for(device)
    if backend != want:
        raise ValueError(f"tables on {torch.device(device)} need a {want} "
                         f"process group, not {backend}")


def _rows(seg, rows, grid_shape=None):
    return ObservationTable(
        imageset=seg.imageset[rows], camera=seg.camera[rows],
        point=seg.point[rows], pixel=seg.pixel[rows], valid=seg.valid[rows],
        grid_shape=grid_shape)


def shard_observations(data, group=None):
    """This rank's slice of per-camera tables (see the module docstring).

    Every rank passes the same tables; each keeps its rows.  Returns
    :class:`ShardedTables`.  A table in grid layout ``(M, P)`` gives rank
    r the imagesets ``[r·M // W, (r+1)·M // W)`` (grid shape ``(m, P)``);
    the step then gathers its pose rows by index.  Lay tables out before
    sharding (``lm_pcg.maybe_grid_layout``): ``optimize`` keeps sharded
    tables as they are.
    """
    data = tuple(data)
    device = data[0].pixel.device if data else torch.device("cpu")
    _require_group(group, device)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    out, starts = [], []
    for seg in data:
        if seg.grid_shape is not None:
            m, p = seg.grid_shape
            m0, m1 = m * rank // world, m * (rank + 1) // world
            out.append(_rows(seg, slice(m0 * p, m1 * p), (m1 - m0, p)))
            starts.append(m0)
            continue
        seg = pad_table(seg, world)
        n = seg.count // world
        out.append(_rows(seg, slice(rank * n, (rank + 1) * n)))
        starts.append(None)
    return ShardedTables(out, Shard(group, rank, world,
                                    band_starts=tuple(starts)))


def shard_grid_blocks(data):
    """The same sharded tables, with the grid intrinsics' per-knot work
    split by bands of knot rows as well: each rank inverts and applies
    the damped per-knot preconditioner blocks of its band of
    ``ceil(gh / W)`` rows and the bands are all-gathered.  Parametric
    intrinsics stay replicated.  The analog of the reference package's
    ``shard_grid_blocks``; the state itself stays replicated."""
    shard = shard_of(data)
    if shard is None:
        raise ValueError("shard_grid_blocks needs sharded tables "
                         "(shard_observations)")
    return ShardedTables(tuple(data),
                         dataclasses.replace(shard, grid_blocks=True))


def knot_band(gh, shard: Shard):
    """(first, end) knot rows of this rank's band of a ``gh``-row grid, and
    the band height every rank pads to."""
    rows = -(-gh // shard.world_size)
    r0 = min(gh, shard.rank * rows)
    return r0, min(gh, r0 + rows), rows


def all_reduce_sum(shard: Shard, tensors):
    """Each tensor summed over the ranks of ``shard``'s group, in one
    collective (flattened and concatenated).  Returns a list."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=shard.group)
    collectives["all_reduce"] += 1
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(t.shape))
        off += t.numel()
    return out


def all_gather_rows(shard: Shard, band, rows):
    """Bands of rows (each rank's ``band`` padded to ``rows`` rows) gathered
    in rank order into one tensor."""
    pad = rows - band.shape[0]
    if pad:
        band = torch.cat([band, band.new_zeros((pad,) + band.shape[1:])])
    parts = [torch.empty_like(band) for _ in range(shard.world_size)]
    dist.all_gather(parts, band.contiguous(), group=shard.group)
    collectives["all_gather"] += 1
    return torch.cat(parts)


def _map_tensors(obj, fn):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_tensors(x, fn) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def replicate(tree, group=None):
    """Rank 0's values of every tensor of ``tree`` (a state, a model, a
    tuple of tensors) on every rank, by broadcast; returns new tensors."""
    def bcast(t):
        _require_group(group, t.device)
        out = t.detach().clone().contiguous()
        dist.broadcast(out, src=dist.get_global_rank(group, 0)
                       if group is not None else 0, group=group)
        collectives["broadcast"] += 1
        return out

    return _map_tensors(tree, bcast)

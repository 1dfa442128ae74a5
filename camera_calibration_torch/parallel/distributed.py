"""Multi-host distribution helpers over ``torch.distributed``.

The reference is single-process; the reference package spans hosts with
``jax.distributed`` and a global device mesh.  In the port one process
drives one device, so one host with several cards and several hosts are
the same thing: a process group whose ranks each hold a slice of the
observation tables.  The recipe:

1. every process calls :func:`initialize` (arguments, or the ``RANK``,
   ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` variables of
   ``torchrun``);
2. :func:`global_group` is the group of all processes;
3. each process passes its LOCAL rows of the observation tables to
   :func:`shard_observations_multihost`; the state is made the same
   everywhere with :func:`replicate_multihost`;
4. ``lm_pcg.optimize`` runs unchanged on every process: the step sums
   over the group wherever it sums over observations
   (``parallel/sharding.py``).

A two-process gloo version of this path runs on the CPU in the tests
(``tests/test_torch_sharding.py``).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from camera_calibration_torch.ba.dataset import pad_table
from camera_calibration_torch.config import default_device
from camera_calibration_torch.parallel import sharding


def initialize(address=None, world_size=None, rank=None, device=None,
               timeout_seconds=300.0):
    """Initialize the default process group; False when single-process.

    address: ``host:port`` (or a ``tcp://`` URL) of rank 0's store, else
    ``MASTER_ADDR``/``MASTER_PORT``; world_size, rank: else ``WORLD_SIZE``
    and ``RANK``.  With neither an address nor a world size this is a
    single process and nothing is initialized.  device: where this
    process computes (default: the card, ``cuda:<LOCAL_RANK>``); it picks
    the backend, NCCL on the card and gloo on the CPU.  A backend that
    fails to initialize raises.
    """
    env = os.environ
    if address is None and "MASTER_ADDR" in env:
        address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if address is None and world_size is None:
        return False
    if address is None or world_size is None or rank is None:
        raise ValueError("a process group needs an address, a world size "
                         "and a rank")
    device = default_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    url = address if "://" in address else f"tcp://{address}"
    dist.init_process_group(
        sharding.backend_for(device), init_method=url,
        world_size=int(world_size), rank=int(rank),
        timeout=datetime.timedelta(seconds=timeout_seconds))
    return True


def global_group():
    """The group of all processes (the default group)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "initialize first")
    return dist.group.WORLD


def shard_observations_multihost(local_data, group=None):
    """Sharded tables from this process's own rows of each camera.

    local_data: per-camera ObservationTables holding THIS process's rows
    (flat layout; the indices refer to the replicated state).  The row
    counts are equalized per camera: an all-gather of the counts, then
    invalid rows (weight 0) pad each table to the largest.  Returns
    :class:`sharding.ShardedTables`.
    """
    local_data = tuple(local_data)
    device = local_data[0].pixel.device if local_data else torch.device("cpu")
    sharding._require_group(group, device)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    counts = torch.tensor([seg.count for seg in local_data], dtype=torch.int64,
                          device=device)
    every = [torch.empty_like(counts) for _ in range(world)]
    dist.all_gather(every, counts, group=group)
    sharding.collectives["all_gather"] += 1
    n_max = torch.stack(every).amax(dim=0).tolist()
    out = [pad_table(seg, count=n) for seg, n in zip(local_data, n_max)]
    return sharding.ShardedTables(out, sharding.Shard(group, rank, world))


def replicate_multihost(tree, group=None):
    """The same values on every process: rank 0's, by broadcast."""
    return sharding.replicate(tree, group)

"""Multi-host deployment: the same SPMD program in every process
(counterpart of ``omg_tools_tpu.parallel.multihost``).

Every process runs this same program under ``torch.distributed``, one
process a device.  The processes form a hybrid (data, fleet) device mesh
whose **'data' (scenario) dimension spans hosts** and whose **'fleet'
(consensus) dimension stays inside one host**, so the ADMM neighbor
exchange and the fleet's residual reductions never cross the slow
network; scenario parallelism has no hot-loop communication at all.

Three entry points:

- :func:`initialize` -- wire this process into the job; driven by
  torchrun's standard variables (``MASTER_ADDR``, ``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``), so the same script runs under any launcher
  that sets them.
- :func:`hybrid_mesh` -- build the (data, fleet) DeviceMesh with the
  fleet dimension host-local (ranks grouped by host, torchrun's
  ``LOCAL_WORLD_SIZE`` ranks a host).
- :func:`make_hybrid_dual_update` -- a batch of independent fleet-ADMM
  instances: B fleets x N vehicles, B split over 'data', N over 'fleet'.
  The per-rank block update is the single-host mesh path's
  (:mod:`.fleet_mesh`), on the rank's whole slab of instances at once.

A process holds one device, so "process-local" and "rank-local" are the
same rows here.

Scenario (pure data) parallelism needs no new machinery: give each rank
its rows with :func:`shard_batch` and run the ordinary
:class:`~omg_tools_torch.problems.batch.BatchedP2PRunner` rollout on them.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._pytree import tree_map

from ..problems.batch import resolve_device
from .fleet_mesh import (TIMEOUT, _block, _gathered, all_reduce, axis_size,
                         build_local_dual_update, mesh_device,
                         one_rank_group, rank_device)

__all__ = ["initialize", "hybrid_mesh", "shard_batch",
           "process_local_batch", "make_hybrid_dual_update",
           "shard_hybrid_state"]


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, device=None):
    """Join the multi-host job.  Arguments default to torchrun's standard
    variables (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``),
    so one script works under any launcher that sets them.  A
    single-process run (no variables, no arguments) is a no-op that
    returns False; the mesh builders then make a group of this process
    alone.  The backend follows ``device`` (None: CUDA): NCCL, with gloo
    beside it for CPU tensors, or gloo on the CPU."""
    init_method = f"tcp://{coordinator_address}"
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        # torchrun's store (its agent may host it at that address)
        coordinator_address, init_method = os.environ["MASTER_ADDR"], "env://"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if num_processes <= 1 or coordinator_address is None:
        return False
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo",
        init_method=init_method, world_size=num_processes, rank=process_id,
        timeout=TIMEOUT)
    return True


def hybrid_mesh(fleet_size=None, data_axis="data", fleet_axis="fleet",
                device=None):
    """Build the (data, fleet) hybrid DeviceMesh of every rank, on
    ``device``'s type (None: CUDA).  Ranks are grouped by host
    (``LOCAL_WORLD_SIZE`` consecutive ranks a host, as torchrun numbers
    them; one host without it) and the fleet dimension is carved out of
    each host's ranks, so fleet collectives stay inside a host.

    fleet_size defaults to the per-host rank count (one fleet instance
    per host).  It must divide the per-host rank count; the data
    dimension takes everything else (hosts x leftover local factor)."""
    device = resolve_device(device)
    one_rank_group(device)
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    # the hosts are alike: every rank saw the same per-host count
    spread = torch.tensor([local, -local], device=rank_device(device.type))
    dist.all_reduce(spread, op=dist.ReduceOp.MAX)
    counts = {int(spread[0]), -int(spread[1])}
    assert len(counts) == 1 and world % local == 0, \
        f"heterogeneous hosts: {counts} ranks a host, {world} in all"
    if fleet_size is None:
        fleet_size = local
    assert local % fleet_size == 0, \
        f"fleet axis {fleet_size} must divide local device count {local}"
    # (hosts, local) -> (hosts * local/fleet, fleet): each data row's fleet
    # block lives inside one host
    grid = torch.arange(world).reshape(world // fleet_size, fleet_size)
    return DeviceMesh(device.type, grid, mesh_dim_names=(data_axis,
                                                         fleet_axis))


def _rank_index(mesh, axes):
    """This rank's position in the flattened ``axes`` of the mesh, and
    their total size."""
    index, n = 0, 1
    for a in axes:
        size = axis_size(mesh, a)
        index = index * size + mesh.get_local_rank(a)
        n *= size
    return index, n


def shard_batch(mesh, tree, batch_axes=None):
    """This rank's rows of every array's leading (batch) axis, split over
    ALL mesh dimensions (flattened) -- the pure scenario-parallel layout --
    on the mesh's device.  Arrays whose leading dim does not divide the
    rank count are replicated (every rank gets all of it).  Each process
    holds the same global value; with one device a process, this rank's
    rows are its process's (use :func:`process_local_batch` when each
    process made only its own)."""
    if batch_axes is None:
        batch_axes = tuple(mesh.mesh_dim_names)
    index, n = _rank_index(mesh, batch_axes)
    device = mesh_device(mesh)

    def place(a):
        if not isinstance(a, (torch.Tensor, np.ndarray)):
            return a
        a = torch.as_tensor(a)
        if a.dim() >= 1 and a.shape[0] % n == 0:
            a = _block(a, index, n)
        return a.to(device)

    return tree_map(place, tree)


def process_local_batch(mesh, global_shape_tree, local_tree,
                        batch_axes=None):
    """Multi-host scatter: each process holds only its LOCAL rows of the
    scenario batch (it made or loaded them itself; nothing is broadcast).
    With one device a process, the process-local rows are this rank's:
    they go to the mesh's device as they are, after a check against the
    global shapes (``global_shape_tree``: the full batch sizes)."""
    if batch_axes is None:
        batch_axes = tuple(mesh.mesh_dim_names)
    _, n = _rank_index(mesh, batch_axes)
    device = mesh_device(mesh)

    def place(shape, a):
        shape = getattr(shape, "shape", shape)
        a = torch.as_tensor(a)
        assert tuple(shape) == (a.shape[0] * n,) + tuple(a.shape[1:]), \
            f"local rows {tuple(a.shape)} of {tuple(shape)} over {n} ranks"
        return a.to(device)

    return tree_map(place, global_shape_tree, local_tree,
                    is_leaf=lambda x: hasattr(x, "shape") or (
                        isinstance(x, (tuple, torch.Size)) and all(
                            isinstance(d, int) for d in x)))


def shard_hybrid_state(mesh, *arrays, data_axis="data",
                       fleet_axis="fleet"):
    """This rank's slab of (B, N, ...) fleet-instance state: its rows of B
    over 'data' and of N over 'fleet', on the mesh's device (with one
    device a process, the process-local slab)."""
    nd, nf = axis_size(mesh, data_axis), axis_size(mesh, fleet_axis)
    d, f = mesh.get_local_rank(data_axis), mesh.get_local_rank(fleet_axis)
    device = mesh_device(mesh)
    return tuple(_block(_block(torch.as_tensor(a), d, nd).transpose(0, 1),
                        f, nf).transpose(0, 1).to(device) for a in arrays)


def make_hybrid_dual_update(admm_problem, mesh, data_axis="data",
                            fleet_axis="fleet", outer_iter: int = 4):
    """One ADMM iteration for a BATCH of independent fleet instances:
    X:(B, N, n_x), P:(B, N, n_p), Z:(B, N, n_sh), L:(B, N, 2, n_sh) with B
    split over the 'data' dimension and N over 'fleet'.  The per-rank
    block update (x-solve, ring exchange, z-projection, multiplier step)
    is the single-host one (:func:`.fleet_mesh.build_local_dual_update`)
    on the rank's slab of B_local instances x blk vehicles, whose x-updates
    are ONE batched solve of B_local * blk lanes; the ring stays on the
    fleet group, so nothing in the iteration crosses hosts but the
    residuals, reduced over the whole mesh (one scalar pair for the job).

    Returns (step, rel) -- call ``step(X, Pp, Z, L, rel_b)`` with this
    rank's slab of each operand (:func:`shard_hybrid_state`; ``rel_b`` is
    rel broadcast to (B,) + rel.shape); every rank gets the whole batch's
    (X, Z, L, pri, dua)."""
    fleet_group = mesh.get_group(fleet_axis)
    data_group = mesh.get_group(data_axis)
    _local, rel = build_local_dual_update(admm_problem, fleet_group,
                                          axis_size(mesh, fleet_axis),
                                          outer_iter=outer_iter)
    device = mesh_device(mesh)

    def step(X, Pp, Z, L, rel_b):
        dtype = torch.as_tensor(X).dtype
        Xn, Zn, Ln, pri, dua = _local(*(
            torch.as_tensor(a).to(device=device, dtype=dtype)
            for a in (X, Pp, Z, L, rel_b)))
        pri, dua = all_reduce(torch.stack([pri, dua]), data_group, "max")
        out = tuple(_gathered(_gathered(a, fleet_group, 1), data_group, 0)
                    for a in (Xn, Zn, Ln))
        return out + (pri, dua)

    return step, rel

"""Mesh-sharded consensus ADMM: vehicles distributed over the ranks of a
``torch.distributed`` device mesh (counterpart of
``omg_tools_tpu.parallel.fleet_mesh``).

The fleet axis maps onto a dimension of a
:class:`torch.distributed.device_mesh.DeviceMesh` whose dimension names are
the JAX package's axis names (``"fleet"``, ``"data"``).  One process runs
each rank and holds one device; each rank owns a contiguous block of
vehicles, its x-updates run as one batched solve of the group template's
solver (whose Newton steps go to K1 on the card), and the neighbor
exchange of shared coefficients and multipliers is one ring step between
the group's neighbours.  Every rank calls the same functions (SPMD), and
the results are gathered, so every rank returns the whole fleet, as the
JAX package's global arrays hold it.

The collectives of every mesh function (this module, ``fleet_runner`` and
``multihost``) go through the layer below, which translates the JAX
package's:

- ``lax.ppermute`` on the ring into ``dist.batch_isend_irecv`` between
  the group's neighbours (:func:`ring_pull`); in a one-rank group the
  operand itself, as ``ppermute`` over one device returns it;
- ``lax.psum`` / ``lax.pmax`` into ``dist.all_reduce`` with ``SUM`` /
  ``MAX`` (:func:`all_reduce`);
- ``lax.all_gather(tiled=True)`` into ``dist.all_gather_into_tensor``
  (:func:`all_gather`).

It counts its calls by kind in :data:`collectives` (``p2p``,
``all_reduce``, ``all_gather``), as ``psd_solve.launches`` counts K1.
Collectives run outside captured CUDA graphs: the solver's graphs hold
its Newton steps only.

Entry point: ``make_mesh_dual_update(admm_problem, mesh)`` returns a
function advancing one ADMM iteration for the whole fleet:
    (X, P, Z, L) -> (X, Z, L, pri_res, dual_res)
with X:(N, n_x), P:(N, n_p), Z:(N, n_sh) (edge k = (k, k+1)),
L:(N, 2, n_sh) (slots [next-edge, prev-edge]), given whole or as this
rank's block (:func:`shard_fleet_state`).
"""

from __future__ import annotations

import datetime
import socket
import warnings
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["make_mesh_dual_update", "shard_fleet_state",
           "build_local_dual_update", "collectives", "ring_pull",
           "all_reduce", "all_gather"]

# the process groups' timeout: a collective whose peer hangs fails after it
TIMEOUT = datetime.timedelta(seconds=120)

# calls of the collective layer by kind; set to 0 by the caller
collectives = Counter(p2p=0, all_reduce=0, all_gather=0)


# -- the collective layer -----------------------------------------------------

def ring_pull(t, group, shift):
    """``t`` of the rank ``shift`` steps along the group's ring (+1: the
    next rank, -1: the previous one): ``lax.ppermute`` with the
    permutation ``[(i, (i - shift) % n)]``.  A one-rank group returns
    ``t`` itself."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    me = dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    t = t.contiguous()
    recv = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, ranks[(me - shift) % n], group=group),
           dist.P2POp(dist.irecv, recv, ranks[(me + shift) % n],
                      group=group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    collectives["p2p"] += 1
    return recv


def all_reduce(t, group, op="sum"):
    """``lax.psum`` (``op="sum"``) or ``lax.pmax`` (``"max"``) of ``t``
    over the group; ``t`` is left as it was."""
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=group)
    collectives["all_reduce"] += 1
    return out


def all_gather(t, group):
    """``lax.all_gather(t, tiled=True)``: the group's blocks stacked along
    the leading axis, in rank order."""
    n = dist.get_world_size(group)
    t = t.contiguous()
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    with warnings.catch_warnings():
        # newer torch names it all_gather_single; the card's torch has only
        # all_gather_into_tensor
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, t, group=group)
    collectives["all_gather"] += 1
    return out


def rank_device(device_type):
    """The device of type ``device_type`` that this process holds."""
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def mesh_device(mesh):
    """The device this rank holds in ``mesh``."""
    return rank_device(mesh.device_type)


def axis_size(mesh, axis):
    return mesh.size(mesh.mesh_dim_names.index(axis))


def one_rank_group(device):
    """A process group of this process alone (127.0.0.1, a free port),
    for a run that no launcher started: NCCL for CUDA with gloo beside it
    for CPU tensors, gloo for the CPU.  A group that exists is kept."""
    if dist.is_initialized():
        return False
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group(
        "cpu:gloo,cuda:nccl" if torch.device(device).type == "cuda"
        else "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
        rank=0, timeout=TIMEOUT)
    return True


# -- placement ---------------------------------------------------------------

def _block(a, index, n):
    """Rows ``index`` of ``n`` equal contiguous blocks of ``a``."""
    b = a.shape[0] // n
    return a[index * b:(index + 1) * b]


def shard_fleet_state(mesh, axis, *arrays):
    """This rank's contiguous block of rows of each per-vehicle array (the
    leading axis split over the mesh dimension ``axis``), on the mesh's
    device."""
    n = axis_size(mesh, axis)
    me = mesh.get_local_rank(axis)
    device = mesh_device(mesh)
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        assert a.shape[0] % n == 0, \
            f"{a.shape[0]} rows do not split over {n} ranks"
        out.append(_block(a, me, n).to(device))
    return tuple(out)


# -- the block update ------------------------------------------------------------

def build_local_dual_update(admm_problem, axis, n_dev: int,
                            outer_iter: int = 4):
    """The per-rank block update for the circular-graph consensus ADMM.
    ``axis`` is the process group of the mesh dimension the fleet is split
    over (``mesh.get_group("fleet")``; the JAX package's axis name), of
    ``n_dev`` ranks.  Returns (_local, rel) where ``_local(X, Pp, Z, L,
    rel_l)`` advances one iteration on this rank's block of vehicles and
    rel is the (N, n_sh) per-vehicle shared-offset table to split
    alongside the state.

    ``_local`` takes a block of vehicles (blk, ...) or a slab of fleet
    instances (B, blk, ...): the slab's B * blk x-updates are one batched
    solve, and the ring exchange moves every instance's boundary row in
    one step."""
    ap = admm_problem
    assert ap.N > 2, "mesh path expects the N>2 circular layout"
    assert len(ap.groups) == 1, "mesh path expects a homogeneous fleet"
    assert ap.N % n_dev == 0, "fleet size must divide the mesh axis"
    group = ap.groups[0]
    solver = group.template._solver
    rho = ap.rho
    # consensus algebra at t0 = 0 (identity future-piece transform): the
    # mesh path advances whole knot intervals in the init phase
    host = dict(lb=np.asarray(group.lb), ub=np.asarray(group.ub),
                z_projT=np.ascontiguousarray(ap._projection_for(None).T))
    S_idx = np.asarray(group.S_idx)
    rel = np.stack([ap._rel_offsets(i) for i in range(ap.N)])
    assert dist.get_world_size(axis) == n_dev, \
        f"the group has {dist.get_world_size(axis)} ranks, not {n_dev}"
    consts = {}

    def const(X):
        key = (X.dtype, X.device)
        if key not in consts:
            consts[key] = {k: torch.as_tensor(v, dtype=X.dtype,
                                              device=X.device)
                           for k, v in host.items()}
            consts[key]["S_idx"] = torch.as_tensor(S_idx, device=X.device)
        return consts[key]

    def _local(X, Pp, Z, L, rel_l):
        slab = X.dim() == 3
        if not slab:
            X, Pp, Z, L, rel_l = (a[None] for a in (X, Pp, Z, L, rel_l))
        c = const(X)
        B, blk, n_x = X.shape
        st = solver(X.reshape(B * blk, n_x), Pp.reshape(B * blk, -1),
                    c["lb"], c["ub"], outer_iter=outer_iter)
        Xn = st.x.reshape(B, blk, n_x)
        S = Xn[..., c["S_idx"]] + rel_l
        # neighbor exchange: s_{i+1} for edge i.  Within the block it is a
        # shift; the block's last row takes the next rank's first, and
        # S and the prev-edge multiplier ride one ring step
        nxt = ring_pull(torch.cat([S[:, :1], L[:, :1, 1]], dim=-1), axis, 1)
        n_sh = S.shape[-1]
        S_next = torch.cat([S[:, 1:], nxt[..., :n_sh]], dim=1)
        L_next = torch.cat([L[:, 1:, 1], nxt[..., n_sh:]], dim=1)
        avg = 0.5 * (S + L[:, :, 0] / rho + S_next + L_next / rho)
        Zn = avg @ c["z_projT"]
        # the multiplier step needs z of edge i (local) and edge i-1 (the
        # previous rank's last row for the block's first)
        Z_prev = torch.cat([ring_pull(Zn[:, -1:], axis, -1), Zn[:, :-1]],
                           dim=1)
        L0 = L[:, :, 0] + rho * (S - Zn)
        L1 = L[:, :, 1] + rho * (S - Z_prev)
        Ln = torch.stack([L0, L1], dim=2)
        pri = torch.maximum((S - Zn).abs().amax(), (S - Z_prev).abs().amax())
        dua = rho * (Zn - Z).abs().amax()
        pri, dua = all_reduce(torch.stack([pri, dua]), axis, "max")
        if not slab:
            Xn, Zn, Ln = Xn[0], Zn[0], Ln[0]
        return Xn, Zn, Ln, pri, dua

    return _local, rel


def _gathered(t, group, dim):
    """The group's blocks of ``t`` along ``dim``, in rank order."""
    if dim == 0:
        return all_gather(t, group)
    return all_gather(t.movedim(dim, 0), group).movedim(0, dim)


def make_mesh_dual_update(admm_problem, mesh, axis: str = "fleet",
                          outer_iter: int = 4):
    """The one-iteration ADMM update of an initialized ADMMProblem (N > 2,
    circular graph) with its vehicles split over the mesh dimension
    ``axis``, whose size N must be divisible by.  Returns ``step(X, Pp, Z,
    L) -> (X, Z, L, pri, dua)``: it takes the fleet's state whole (the
    same on every rank) or as this rank's block (:func:`shard_fleet_state`)
    and returns the whole fleet's on every rank."""
    group = mesh.get_group(axis)
    n_dev = axis_size(mesh, axis)
    me = mesh.get_local_rank(axis)
    device = mesh_device(mesh)
    _local, rel = build_local_dual_update(admm_problem, group, n_dev,
                                          outer_iter=outer_iter)
    N = admm_problem.N

    def step(X, Pp, Z, L):
        dtype = torch.as_tensor(X).dtype
        args = [torch.as_tensor(a).to(device=device, dtype=dtype)
                for a in (X, Pp, Z, L)]
        if args[0].shape[0] == N:
            args = [_block(a, me, n_dev) for a in args]
        rel_l = _block(torch.as_tensor(rel, dtype=dtype, device=device),
                       me, n_dev)
        Xn, Zn, Ln, pri, dua = _local(*args, rel_l)
        return (_gathered(Xn, group, 0), _gathered(Zn, group, 0),
                _gathered(Ln, group, 0), pri, dua)

    return step

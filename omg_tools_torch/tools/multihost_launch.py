#!/usr/bin/env python
"""Multi-host SPMD launcher: run the SAME program in every process
(counterpart of the JAX package's ``tools/multihost_launch.py``).

    python -m omg_tools_torch.tools.multihost_launch \
        --coordinator host0:8476 --num-processes 4 --process-id $I \
        [--program fleet|rollout] [--device cuda|cpu]

or, with torchrun's standard variables instead of the flags:

    torchrun --nnodes 2 --nproc-per-node 4 ... \
        -m omg_tools_torch.tools.multihost_launch --program fleet

Each process holds one device and joins the job through
``torch.distributed`` (NCCL on the card, gloo on the CPU), builds the
hybrid (data, fleet) mesh (the fleet dimension: one host's ranks,
``LOCAL_WORLD_SIZE`` of them; the data dimension across hosts; see
``omg_tools_torch/parallel/multihost.py``), runs the selected program,
and prints one line, ``MULTIHOST_RESULT {json}``, with rank-local
checksums, so that a harness can verify the agreement across processes
against a single-process reference run.

Programs
--------
fleet    B independent formation-ADMM fleet instances; B over 'data', the
         N vehicles of each instance over 'fleet'.  One dual iteration.
rollout  scenario-parallel batched MPC rollout, its scenarios split over
         all ranks.

``--device`` replaces the JAX launcher's ``--cpu-devices``: a process
holds one device, so a CPU test starts one process a rank.
"""

import argparse
import json

import numpy as np
import torch


def parse_args():
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--program", choices=["fleet", "rollout"],
                   default="fleet")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="this process's device (cpu: testing)")
    p.add_argument("--fleet-n", type=int, default=4)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--steps", type=int, default=1)
    return p.parse_args()


def build_formation(N, device=None):
    """The canonical regular-polygon formation problem (shared by the
    launcher and the verifying harness so both build identical NLPs)."""
    from omg_tools_torch import (Holonomic, Fleet, Environment, Square,
                                 FormationPoint2point)
    from omg_tools_torch.environment.shapes import RegularPolyhedron
    vehicles = [Holonomic() for _ in range(N)]
    fleet = Fleet(vehicles)
    configuration = RegularPolyhedron(0.2, N, np.pi / 4).vertices.T
    fleet.set_configuration(configuration.tolist())
    fleet.set_initial_conditions(
        (np.array([-1.5, -1.5]) + configuration).tolist())
    fleet.set_terminal_conditions(
        (np.array([2.0, 2.0]) + configuration).tolist())
    environment = Environment(room={"shape": Square(5.0)})
    admm = FormationPoint2point(fleet, environment,
                                options={"horizon_time": 10, "rho": 1.0,
                                         "device": device})
    admm.set_options({"verbose": 0})
    admm.init()
    return admm


def run_fleet(mesh, args):
    """B independent fleet instances over ('data', 'fleet')."""
    from omg_tools_torch.parallel.multihost import (make_hybrid_dual_update,
                                                    shard_hybrid_state)
    N = args.fleet_n
    B = args.batch
    admm = build_formation(N, args.device)
    grp = admm.groups[0]
    step, rel = make_hybrid_dual_update(admm, mesh, outer_iter=1)
    P0 = admm._pack_params(grp, 0.0)
    # B identical instances (checksum simplicity); real deployments feed
    # per-instance scenario parameters here
    X, Pp, Z, L, relb = (
        torch.as_tensor(a).expand((B,) + a.shape)
        for a in (grp.X, P0, admm.Z, admm.L, rel))
    X, Pp, Z, L, relb = shard_hybrid_state(mesh, X, Pp, Z, L, relb)
    Xn, Zn, Ln, pri, dua = step(X, Pp, Z, L, relb)
    # rank-local checksum over this rank's slab of the result
    local = shard_hybrid_state(mesh, Xn)[0]
    return {"pri": float(pri), "dua": float(dua),
            "x_local_sum": float(local.sum()), "x_shape": list(Xn.shape),
            "x_local": local.cpu().numpy().tolist()}


def rollout_batch(B, device=None):
    """The rollout program's float64 runner and its B scenarios
    ``(x0, p0, state)``: the bench scene's Holonomic with one circle,
    starts and goals drawn from numpy seed 0."""
    from omg_tools_torch import (Holonomic, Environment, Obstacle, Circle,
                                 Square, Point2point)
    from omg_tools_torch.problems.batch import BatchedP2PRunner
    vehicle = Holonomic()
    vehicle.set_initial_conditions([-1.5, -1.5])
    vehicle.set_terminal_conditions([2.0, 2.0])
    environment = Environment(room={"shape": Square(5.0)})
    environment.add_obstacle(Obstacle(
        {"position": [1.5, 0.5]}, shape=Circle(0.4)))
    problem = Point2point(vehicle, environment, freeT=False,
                          options={"device": device})
    problem.set_options({"verbose": 0})
    problem.init()
    runner = BatchedP2PRunner(problem, dtype=torch.float64, device=device)
    rng = np.random.default_rng(0)
    starts = np.tile([-1.5, -1.5], (B, 1)) + rng.uniform(-0.2, 0.2, (B, 2))
    goals = np.tile([2.0, 2.0], (B, 1)) + rng.uniform(-0.2, 0.2, (B, 2))
    return runner, runner.make_batch(starts, goals)


def run_rollout(mesh, args):
    """Scenario-parallel batched MPC over all ranks (no hot-loop
    communication: each rank rolls out its own scenarios)."""
    import torch.distributed as dist
    from omg_tools_torch.parallel.fleet_mesh import all_reduce
    from omg_tools_torch.parallel.multihost import shard_batch
    B = max(args.batch, dist.get_world_size())
    runner, batch = rollout_batch(B, args.device)
    x0, p0, state = shard_batch(mesh, batch)
    consts = runner.consts()
    # the cold solve and the rollout decide lane by lane (no decision over
    # the batch: no rescue lanes here), so this rank's rows are the
    # whole batch's
    st = runner.init_solver_state(x0, p0, consts)
    roll = runner.rollout_fn(args.steps, outer_iter=1)
    carry, states = roll(st, p0, state, consts)
    feas_max = all_reduce(carry[0].feas.max(), None, "max")   # every rank
    return {"feas_max": float(feas_max),
            "states_local_sum": float(states.sum()),
            "states_shape": [B] + list(states.shape[1:]),
            "states_local": states.cpu().numpy().tolist()}


def main():
    args = parse_args()
    import torch.distributed as dist
    from omg_tools_torch.parallel import multihost
    distributed = multihost.initialize(args.coordinator, args.num_processes,
                                       args.process_id, device=args.device)
    mesh = multihost.hybrid_mesh(device=args.device)
    result = run_fleet(mesh, args) if args.program == "fleet" else \
        run_rollout(mesh, args)
    result.update({
        "process_id": dist.get_rank(),
        "num_processes": dist.get_world_size(),
        "distributed": distributed,
        "mesh": {a: int(s) for a, s in
                 zip(mesh.mesh_dim_names, mesh.shape)},
    })
    dist.destroy_process_group()
    print("MULTIHOST_RESULT " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

"""One rank of the port's mesh tests: joins a gloo process group on
127.0.0.1, builds a formation, runs the mesh functions of
``omg_tools_torch.parallel`` on the CPU in float64, and prints one JSON
line, ``MESH_RANK {...}``, of its results and its collective counts.

    python tests/torch_mesh_rank.py --rank R --world W --port P \
        --program mesh|dual|mixed

Programs:

mesh   bench.py's formation_holonomic (four Holonomic, rho 0.5, a 0.4 m
       circle) on the cut x-update budget (2 outer x 4 inner):
       ``mesh_iterate_fn(2)`` on a W-rank "fleet" mesh; with W <= 2 also
       ``mesh_rollout_fn(4)`` at update_time 0.5 (a knot at period 2) and
       one ``make_mesh_dual_update`` step;
dual   the multi-host launcher's formation (four Holonomic, rho 1.0, no
       obstacle, the template's full budget): one ``make_mesh_dual_update``
       step at outer_iter 1 -- what the launcher's ``fleet`` program
       computes for each fleet instance;
mixed  2 Holonomic + 2 HolonomicOrient on the cut budget (two
       vehicle-type groups): ``mesh_iterate_fn(2)``;
card   one rank on the card (NCCL, gloo beside it): the mesh program's
       scene on the card, its cold solves (``make_state``) the start of
       ``mesh_iterate_fn(2)`` on a CUDA mesh and on a CPU mesh, and of the
       CPU's run from that start moved by 1e-15 (relative).

The test files start the ranks as subprocesses with timeouts of their own
(the process group's is 120 s), so a hang fails a test, not the run.
"""

import argparse
import datetime
import importlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

N = 4
BUDGET = {"outer_iter": 2, "inner_iter": 4}     # tests/test_torch_fleet.py
TIMEOUT_S = 300         # a process's, beside the other test workers'

UPDATE_TIME = 0.5
ROLLOUT_STEPS = 4
DUAL_OUTER = 4


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Processes:
    """Processes started at once (one torch thread each) and read on the
    first ``results()``: the JSON of each one's last ``<tag> {...}``
    line, in process order.  A process that runs over TIMEOUT_S is killed
    and fails the caller."""

    def __init__(self, commands, tag, **env):
        self.tag = tag
        env = {**os.environ, "OMP_NUM_THREADS": "1", **env}
        env.pop("XLA_FLAGS", None)
        self.procs = [subprocess.Popen(
            c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=os.path.join(HERE, "..")) for c in commands]
        self._results = None

    def results(self):
        if self._results is None:
            out = []
            try:
                for p in self.procs:
                    text, _ = p.communicate(timeout=TIMEOUT_S)
                    assert p.returncode == 0, \
                        f"process failed:\n{text[-3000:]}"
                    line = [ln for ln in text.splitlines()
                            if ln.startswith(self.tag + " ")]
                    assert line, f"no result line:\n{text[-3000:]}"
                    out.append(json.loads(line[-1][len(self.tag) + 1:]))
            finally:
                self.kill()
            self._results = out
        return self._results

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def world(size, program="mesh"):
    """This script's ranks of one world, started (see Processes)."""
    port = free_port()
    return Processes([[sys.executable, os.path.abspath(__file__), "--rank",
                       str(r), "--world", str(size), "--port", str(port),
                       "--program", program] for r in range(size)],
                     "MESH_RANK")


def bench_formation(T, mixed=False, device="cpu"):
    """bench.py's formation_holonomic scene on the cut budget, built by
    the package ``T`` (the port on the CPU, or the JAX package); with
    ``mixed`` every second vehicle a HolonomicOrient and no obstacle
    (tests/test_fleet_runner.py:189-214)."""
    RegularPolyhedron = importlib.import_module(
        T.__name__ + ".environment.shapes").RegularPolyhedron
    vehicles = [T.HolonomicOrient() if mixed and i % 2 else T.Holonomic()
                for i in range(N)]
    fleet = T.Fleet(vehicles)
    configuration = RegularPolyhedron(0.2, N, np.pi / 4).vertices.T
    fleet.set_configuration(configuration.tolist())
    init = [list(p) for p in np.array([-1.5, -1.5]) + configuration]
    term = [list(p) for p in np.array([2.0, 2.0]) + configuration]
    if mixed:
        for i in (1, 3):                       # orientation states
            init[i] = init[i] + [0.0]
            term[i] = term[i] + [0.0]
    fleet.set_initial_conditions(init)
    fleet.set_terminal_conditions(term)
    env = T.Environment(room={"shape": T.Square(5.0)})
    if not mixed:
        env.add_obstacle(T.Obstacle({"position": [1.5, 0.5]},
                                    shape=T.Circle(0.4)))
    options = {"horizon_time": 10, "verbose": 0, "rho": 0.5,
               "device_loop": False, "solver_options": BUDGET}
    if T.__name__ == "omg_tools_torch":
        options["device"] = device
    problem = T.FormationPoint2point(fleet, env, options=options)
    problem.init()
    return problem


def inputs(problem):
    """The fleet's start: per-group X and P, Z, L (as ``make_state``
    packs them, without its cold solves)."""
    Xs = tuple(torch.as_tensor(g.X) for g in problem.groups)
    Ps = tuple(torch.as_tensor(problem._pack_params(g, 0.0))
               for g in problem.groups)
    return Xs, Ps, torch.as_tensor(problem.Z), torch.as_tensor(problem.L)


def card_vs_cpu(T, mesh_cpu):
    """Phase 21 (c) of chip_smoke.py: ``mesh_iterate_fn(2)`` in float64
    on the card and on the CPU from the card's cold solves."""
    from torch.distributed.device_mesh import init_device_mesh
    from omg_tools_torch.parallel import FleetRunner
    problem = bench_formation(T, device="cuda")
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("fleet",))
    cuda = FleetRunner(problem, dtype=torch.float64, device="cuda",
                       mesh=mesh)
    carry = cuda.make_state(0.0)
    start = tuple(a.cpu() for a in (carry.st[0].x, carry.Pp[0], carry.Z,
                                    carry.L))
    (_, Zg, _), _ = cuda.mesh_iterate_fn(2)(*start)
    cpu = FleetRunner(problem, dtype=torch.float64, device="cpu",
                      mesh=mesh_cpu)
    (_, Zc, _), _ = cpu.mesh_iterate_fn(2)(*start)
    rng = np.random.default_rng(0)
    moved = start[0] * (1.0 + 1e-15 * torch.as_tensor(
        rng.standard_normal(tuple(start[0].shape))))
    (_, Zm, _), _ = cpu.mesh_iterate_fn(2)(moved, *start[1:])
    return {"card_vs_cpu_Z": float((Zg.cpu() - Zc).abs().max()),
            "cpu_sensitivity": float((Zm - Zc).abs().max()),
            "finite": bool(torch.isfinite(Zg).all())}


def listed(x):
    if isinstance(x, (tuple, list)):
        return [listed(a) for a in x]
    return x.detach().cpu().numpy().tolist()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--program", choices=["mesh", "dual", "mixed", "card"],
                    default="mesh")
    args = ap.parse_args()
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    import omg_tools_torch as T
    from omg_tools_torch.parallel import (FleetRunner, fleet_mesh,
                                          make_mesh_dual_update)
    dist.init_process_group(
        "cpu:gloo,cuda:nccl" if args.program == "card" else "gloo",
        init_method=f"tcp://127.0.0.1:{args.port}",
        world_size=args.world, rank=args.rank,
        timeout=datetime.timedelta(seconds=120))
    mesh = init_device_mesh("cpu", (args.world,), mesh_dim_names=("fleet",))
    out = {"rank": args.rank, "world": args.world}
    if args.program == "card":
        out["card"] = card_vs_cpu(T, mesh)
    elif args.program == "dual":
        from omg_tools_torch.tools.multihost_launch import build_formation
        problem = build_formation(N, "cpu")
        (X,), (P,), Z, L = inputs(problem)
        step = make_mesh_dual_update(problem, mesh, outer_iter=1)
        Xn, Zn, Ln, pri, dua = step(X, P, Z, L)
        out["dual"] = {"X": listed(Xn), "Z": listed(Zn), "L": listed(Ln),
                       "pri": float(pri), "dua": float(dua)}
    else:
        problem = bench_formation(T, mixed=args.program == "mixed")
        Xs, Ps, Z, L = inputs(problem)
        runner = FleetRunner(problem, dtype=torch.float64, mesh=mesh,
                             device="cpu")
        before = dict(fleet_mesh.collectives)
        (Xo, Zo, Lo), (pri, dua) = runner.mesh_iterate_fn(2)(Xs, Ps, Z, L)
        out["iterate"] = {"X": listed(Xo), "Z": listed(Zo), "L": listed(Lo),
                          "pri": listed(pri), "dua": listed(dua),
                          "collectives": {k: fleet_mesh.collectives[k]
                                          - before.get(k, 0)
                                          for k in fleet_mesh.collectives}}
        if args.program == "mesh" and args.world <= 2:
            roll = FleetRunner(problem, dtype=torch.float64, mesh=mesh,
                               device="cpu", update_time=UPDATE_TIME)
            (_, Zr, _), (pri, dua, states) = roll.mesh_rollout_fn(
                ROLLOUT_STEPS)(Xs, Ps, Z, L)
            out["rollout"] = {"pri": listed(pri), "dua": listed(dua),
                              "states": listed(states), "Z": listed(Zr)}
            step = make_mesh_dual_update(problem, mesh,
                                         outer_iter=DUAL_OUTER)
            Xn, Zn, Ln, pri, dua = step(Xs[0], Ps[0], Z, L)
            out["dual"] = {"X": listed(Xn), "Z": listed(Zn),
                           "L": listed(Ln), "pri": float(pri),
                           "dua": float(dua)}
    dist.destroy_process_group()
    print("MESH_RANK " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

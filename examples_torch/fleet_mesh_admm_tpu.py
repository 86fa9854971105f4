"""Fleet (model) parallelism: distributed-ADMM formation with vehicles
split over the ranks of a device mesh; the neighbor exchange is one ring
step between ranks (the reference's in-process communicate(),
admm.py:468-475, mapped onto torch.distributed).  The JAX package's
examples/fleet_mesh_admm_tpu.py on omg_tools_torch, through the
FleetRunner mesh path.  Alone it runs as one rank on the card (the mesh is
the trivial one-rank ring); under torchrun, one rank a card:

    python examples_torch/fleet_mesh_admm_tpu.py
    torchrun --nproc-per-node 4 examples_torch/fleet_mesh_admm_tpu.py
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
from omg_tools_torch import (Holonomic, Fleet, Environment, Square,
                             FormationPoint2point)
from omg_tools_torch.environment.shapes import RegularPolyhedron
from omg_tools_torch.parallel import multihost
from omg_tools_torch.parallel.fleet_mesh import one_rank_group
from omg_tools_torch.parallel.fleet_runner import FleetRunner

# torchrun's variables join the job; alone, a group of this rank only
if not multihost.initialize():
    one_rank_group("cuda")
n_dev = dist.get_world_size()
N = max(4, n_dev)
vehicles = [Holonomic() for _ in range(N)]
fleet = Fleet(vehicles)
configuration = RegularPolyhedron(0.2, N, np.pi / 4).vertices.T
fleet.set_configuration(configuration.tolist())
fleet.set_initial_conditions((np.array([-1.5, -1.5]) + configuration).tolist())
fleet.set_terminal_conditions((np.array([2.0, 2.0]) + configuration).tolist())
environment = Environment(room={"shape": Square(5.0)})
problem = FormationPoint2point(fleet, environment,
                               options={"horizon_time": 10, "rho": 0.5,
                                        "device_loop": False})
problem.set_options({"verbose": 0})
problem.init()

mesh = init_device_mesh("cuda", (min(n_dev, N),), mesh_dim_names=("fleet",))
runner = FleetRunner(problem, mesh=mesh)
carry = runner.make_state(0.0)
X0 = torch.cat(carry.X, dim=0)
P0 = torch.cat(carry.Pp, dim=0)
step = runner.mesh_iterate_fn(3)
# pre-place once (host padding, this rank's block), iterate on the device
placed = step.prepare(X0, P0, carry.Z, carry.L)
(_, _, _), (pri, dua) = step.run_placed(placed)
pri, dua = pri.cpu().numpy(), dua.cpu().numpy()
if dist.get_rank() == 0:
    print(f"fleet_mesh_admm_tpu: {N} vehicles on {mesh.size()} ranks, "
          f"residuals pri={pri[-1]:.2e} dual={dua[-1]:.2e}")
dist.destroy_process_group()
assert pri[-1] < pri[0], (pri[0], pri[-1])

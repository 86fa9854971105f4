"""ADMM against dual decomposition on the same quadrotor formation: the
JAX package's examples/compare_distributed_optimization_quadrotors.py on
omg_tools_torch (omgtools' example of the same name).  The ADMM
formation takes the device consensus loop on the card, the dual
decomposition the host loop."""
import numpy as np
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
from omg_tools_torch import (Quadrotor, Fleet, Environment, Square,
                             FormationPoint2point,
                             FormationPoint2pointDualDecomposition, Simulator)
from _smoke import SMOKE

n_steps = 3 if SMOKE else 12
for cls, name in ((FormationPoint2point, "ADMM"),
                  (FormationPoint2pointDualDecomposition, "DD")):
    N = 3
    vehicles = [Quadrotor(0.2) for _ in range(N)]
    fleet = Fleet(vehicles)
    configuration = [[0.0, -0.3], [0.45, 0.15], [-0.45, 0.15]]
    fleet.set_configuration(configuration)
    fleet.set_initial_conditions(
        (np.array([-1.5, -1.5]) + np.asarray(configuration)).tolist())
    fleet.set_terminal_conditions(
        (np.array([2.0, 2.0]) + np.asarray(configuration)).tolist())
    environment = Environment(room={"shape": Square(5.0)})
    opts = {"horizon_time": 5.0}
    opts.update({"rho": 3.0} if name == "ADMM" else {"alpha": 0.3})
    problem = cls(fleet, environment, options=opts)
    problem.set_options({"verbose": 0})
    problem.init()
    simulator = Simulator(problem)
    problem.initialize(0.0)
    for _ in range(n_steps):
        simulator.update()
    pri = problem.residuals[-1][0]
    print(f"compare_distributed_optimization: {name} primal residual "
          f"{pri:.2e}")

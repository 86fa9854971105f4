"""Eight planar quadrotors rendezvous into a question-mark formation: the
JAX package's examples/rendezvous_quadrotor_questionmark.py on
omg_tools_torch (omgtools' examples/questions.py scenario family)."""
import numpy as np
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
from omg_tools_torch import (Quadrotor, Fleet, Environment, Square, RendezVous,
                             Simulator)
from omg_tools_torch.environment.shapes import RegularPolyhedron
from _smoke import run

N = 8
vehicles = [Quadrotor(0.2) for _ in range(N)]
fleet = Fleet(vehicles)

# question mark: five dots along the hook, one for the stem, two for the dot
configuration = [[-1.5, 0.0], [-0.75, 1.29], [0.75, 1.29], [1.5, 0.0],
                 [0.75, -1.29], [0.0, -4.2], [0.0, -3.3], [0.0, -2.4]]
init_positions = RegularPolyhedron(4.0, N, np.pi / 4).vertices.T.tolist()
fleet.set_configuration(configuration)
fleet.set_initial_conditions(
    [list(pos) + [0.0, 0.0, 0.0] for pos in init_positions])
fleet.set_terminal_conditions(np.zeros((N, 2)).tolist())

environment = Environment(room={"shape": Square(10.0)})
problem = RendezVous(fleet, environment,
                     options={"horizon_time": 5, "rho": 3.0})
problem.set_options({"verbose": 0})
problem.init()
run(problem, Simulator(problem))
print("rendezvous_quadrotor_questionmark: done")

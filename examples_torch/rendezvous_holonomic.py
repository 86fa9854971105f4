"""ADMM rendezvous: vehicles agree on a meeting point.  The JAX package's
examples/rendezvous_holonomic.py on omg_tools_torch (omgtools'
examples/rendezvous_holonomic_export.py, minus the export).  The
consensus runs on the host, the x-updates on the card."""
import numpy as np
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
from omg_tools_torch import (Holonomic, Fleet, Environment, Square, RendezVous,
                             Simulator)
from omg_tools_torch.environment.shapes import RegularPolyhedron
from _smoke import run

N = 3
vehicles = [Holonomic() for _ in range(N)]
fleet = Fleet(vehicles)
configuration = RegularPolyhedron(0.2, N, np.pi / 4).vertices.T
fleet.set_configuration(configuration.tolist())
init = np.array([[-2.0, -2.0], [2.0, -1.5], [-1.0, 2.0]])
fleet.set_initial_conditions(init.tolist())
for veh in vehicles:
    veh.set_terminal_conditions([0.0, 0.0])  # free end; consensus decides
environment = Environment(room={"shape": Square(5.0)})
problem = RendezVous(fleet, environment, options={"horizon_time": 10,
                                                  "rho": 1.0})
problem.set_options({"verbose": 0})
problem.init()
run(problem, Simulator(problem))
print("rendezvous_holonomic: done")

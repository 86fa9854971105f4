"""Formation by dual decomposition: the JAX package's
examples/formation_holonomic_dualdec.py on omg_tools_torch (omgtools'
examples/compare_buildoptions_distributed.py family).  The dual updates
run on the host, the x-updates on the card."""
import numpy as np
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
from omg_tools_torch import (Holonomic, Fleet, Environment, Square,
                             FormationPoint2pointDualDecomposition, Simulator)
from omg_tools_torch.environment.shapes import RegularPolyhedron
from _smoke import run

N = 3
vehicles = [Holonomic() for _ in range(N)]
fleet = Fleet(vehicles)
configuration = RegularPolyhedron(0.2, N, np.pi / 4).vertices.T
fleet.set_configuration(configuration.tolist())
fleet.set_initial_conditions((np.array([-1.5, -1.5]) + configuration).tolist())
fleet.set_terminal_conditions((np.array([2.0, 2.0]) + configuration).tolist())
environment = Environment(room={"shape": Square(5.0)})
problem = FormationPoint2pointDualDecomposition(
    fleet, environment, options={"horizon_time": 10})
problem.set_options({"verbose": 0})
problem.init()
run(problem, Simulator(problem))
print("formation_holonomic_dualdec: done")

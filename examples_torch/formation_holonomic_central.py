"""Centralized formation: three Holonomic vehicles in one NLP whose
centre-equality constraints keep their triangle: the JAX package's
examples/formation_holonomic_central.py on omg_tools_torch (omgtools'
examples/formation_holonomic_central.py).  The NLP (203 variables) runs
the default generic ALM mode on the card."""
import numpy as np
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
from omg_tools_torch import (Holonomic, Fleet, Environment, Obstacle, Circle,
                             Square, FormationPoint2pointCentral, Simulator)
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
environment.add_obstacle(Obstacle({"position": [1.5, 0.5]},
                                  shape=Circle(0.4)))
problem = FormationPoint2pointCentral(fleet, environment,
                                      options={"horizon_time": 10})
problem.set_options({"verbose": 0})
problem.init()
run(problem, Simulator(problem))
print("formation_holonomic_central: done")

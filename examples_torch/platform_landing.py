"""Quadrotors land on a moving 1D platform: a rendezvous between planar
quadrotors and a Holonomic1D platform, two vehicle-type groups.  The JAX
package's examples/platform_landing.py on omg_tools_torch (omgtools'
examples/platform_landing.py)."""
import numpy as np
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
from omg_tools_torch import (Quadrotor, Holonomic1D, Fleet, Environment,
                             Obstacle, Rectangle, Square, RendezVous,
                             Simulator)
from _smoke import run

quadrotors = [Quadrotor(0.2) for _ in range(2)]
fleet = Fleet(quadrotors + [Holonomic1D()])
fleet.set_configuration([[0.25], [-0.25], [0.0]])
fleet.set_initial_conditions([[1.5, 3.0], [-2.0, 2.0], [1.0]])
fleet.set_terminal_conditions([[0.0, 0.1], [0.0, 0.1], [0.0]])
environment = Environment(room={"shape": Square(5.0), "position": [0., 2.]})
environment.add_obstacle(Obstacle({"position": [1.0, 1.5]},
                                  shape=Rectangle(width=1.0, height=0.2)))
problem = RendezVous(fleet, environment,
                     options={"horizon_time": 5.0, "rho": 3.0})
problem.set_options({"verbose": 0})
problem.init()
run(problem, Simulator(problem))
print("platform_landing: final",
      [np.round(v.signals["pose"][:2, -1], 2) for v in quadrotors])

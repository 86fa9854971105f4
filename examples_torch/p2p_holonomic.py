"""Point-to-point holonomic vehicle among static obstacles: the JAX
package's examples/p2p_holonomic.py on omg_tools_torch (omgtools'
examples/p2p_holonomic.py).  It takes the dense quadratic ALM mode
(``exploit_structure``): the default generic mode, with its AD every
Newton iteration, costs seconds an iteration on the card's host
(PERF.md)."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
from omg_tools_torch import (Holonomic, Environment, Obstacle, Rectangle,
                             Square, Point2point, Simulator)
from _smoke import run

vehicle = Holonomic(shapes=Square(0.1), bounds={"vmax": 0.8, "vmin": -0.8})
vehicle.set_initial_conditions([-1.5, -1.5])
vehicle.set_terminal_conditions([2.0, 2.0])
environment = Environment(room={"shape": Square(5.0)})
environment.add_obstacle(Obstacle({"position": [-0.6, -0.4]},
                                  shape=Rectangle(width=0.4, height=2.0)))
problem = Point2point(vehicle, environment, freeT=False)
problem.set_options({"verbose": 0, "exploit_structure": True})
problem.init()
run(problem, Simulator(problem))
print("p2p_holonomic: final", vehicle.signals["pose"][:2, -1])

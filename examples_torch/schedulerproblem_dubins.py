"""Scheduler with a Dubins vehicle through corridor frames: the JAX
package's examples/schedulerproblem_dubins.py on omg_tools_torch
(omgtools' examples/schedulerproblem_example_dubins.py).  The local
problems run the default generic ALM mode on the card."""
import os, sys
import numpy as np
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
from omg_tools_torch import (Dubins, Environment, Obstacle, Circle,
                             Rectangle, SchedulerProblem, Simulator)
from _smoke import run

vehicle = Dubins(shapes=Circle(0.3), bounds={"vmax": 0.7,
                                             "wmax": np.pi / 3.0,
                                             "wmin": -np.pi / 3.0})
vehicle.define_knots(knot_intervals=10)
vehicle.set_initial_conditions([2.0, 2.0, 0.0])
vehicle.set_terminal_conditions([8.0, 8.0, 0.0])

environment = Environment(room={"shape": Rectangle(width=10, height=10),
                                "position": [5, 5]})
environment.add_obstacle(Obstacle({"position": [6.0, 2.0]},
                                  shape=Rectangle(width=1.0, height=1.0)))
environment.add_obstacle(Obstacle({"position": [4.0, 2.0]},
                                  shape=Circle(0.4)))
environment.add_obstacle(Obstacle({"position": [5.0, 6.0]},
                                  shape=Circle(0.4)))

problem = SchedulerProblem(vehicle, environment, frame_type="corridor",
                           n_frames=2, n_cells=[10, 10])
problem.set_options({"verbose": 0})
problem.init()
run(problem, Simulator(problem))
print("scheduler dubins: final", vehicle.signals["pose"][:2, -1],
      "switches:", problem.cnt_frame_switches)

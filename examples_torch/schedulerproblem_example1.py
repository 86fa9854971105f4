"""Scheduler: an A* global path, moving frames and local free-time
problems: the JAX package's examples/schedulerproblem_example1.py on
omg_tools_torch (omgtools' examples/schedulerproblem_example1.py).  The
local problems run the default generic ALM mode on the card."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
from omg_tools_torch import (Holonomic, Environment, Obstacle, Circle,
                             Rectangle, Square, SchedulerProblem, Simulator)
from _smoke import run

vehicle = Holonomic(shapes=Circle(0.1))
vehicle.set_initial_conditions([-4.0, -4.0])
vehicle.set_terminal_conditions([4.0, 4.0])
environment = Environment(room={"shape": Square(10.0)})
environment.add_obstacle(Obstacle({"position": [-2.0, -2.0]},
                                  shape=Rectangle(width=0.4, height=3.0)))
environment.add_obstacle(Obstacle({"position": [2.0, 2.0]},
                                  shape=Circle(0.6)))
problem = SchedulerProblem(vehicle, environment, frame_size=4.0,
                           n_cells=[20, 20])
problem.set_options({"verbose": 0})
problem.init()
run(problem, Simulator(problem))
print("scheduler: final", vehicle.signals["pose"][:2, -1],
      "frame switches:", problem.cnt_frame_switches)

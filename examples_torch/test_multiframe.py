"""Multi-frame problem: two rooms, a free motion time per segment and
continuity at the joint: the JAX package's examples/test_multiframe.py on
omg_tools_torch (omgtools' examples/test_multiframe.py).  The default
generic ALM mode runs on the card."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
from omg_tools_torch import (Holonomic, Environment, Obstacle, Circle,
                             Rectangle, MultiFrameProblem, Simulator)
from _smoke import run

vehicle = Holonomic()
vehicle.set_initial_conditions([-3.0, 0.0])
vehicle.set_terminal_conditions([3.0, 0.0])
environment = Environment(room=[
    {"shape": Rectangle(width=5.0, height=2.0), "position": [-1.5, 0.0]},
    {"shape": Rectangle(width=5.0, height=2.0), "position": [1.5, 0.0]}])
environment.add_obstacle(Obstacle({"position": [0.0, 0.6]},
                                  shape=Circle(0.2)))
problem = MultiFrameProblem(vehicle, environment, n_frames=2)
problem.set_options({"verbose": 0})
problem.init()
run(problem, Simulator(problem))
print("multiframe: final", vehicle.signals["pose"][:2, -1])

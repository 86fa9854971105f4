"""Bicycle model point-to-point, free motion time: the JAX package's
examples/p2p_bicycle.py on omg_tools_torch (omgtools'
examples/p2p_bicycle.py).  The default generic ALM mode runs on the
card."""
import numpy as np
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
from omg_tools_torch import (Bicycle, Environment, Obstacle, Circle, Square,
                             Point2point, Simulator)
from _smoke import run

vehicle = Bicycle(length=0.4, bounds={"vmax": 0.8, "dmax": np.pi / 6,
                                      "dmin": -np.pi / 6})
vehicle.define_knots(knot_intervals=5)
vehicle.set_initial_conditions([0.0, 0.0, 0.0, 0.0])
vehicle.set_terminal_conditions([3.0, 3.0, 0.0])
environment = Environment(room={"shape": Square(5.0), "position": [1.5, 1.5]})
environment.add_obstacle(Obstacle({"position": [1.0, 1.0]},
                                  shape=Circle(0.4)))
problem = Point2point(vehicle, environment, freeT=True)
problem.set_options({"verbose": 0})
problem.init()
run(problem, Simulator(problem))
print("p2p_bicycle: final", vehicle.signals["pose"][:2, -1])

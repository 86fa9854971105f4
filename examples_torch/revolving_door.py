"""Rotating-obstacle avoidance, passing a revolving door: the JAX
package's examples/revolving_door.py on omg_tools_torch (omgtools'
examples/revolving_door.py; the yaw over the horizon as NURBS circle
arcs).  The default generic ALM mode runs on the card."""
import numpy as np
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
from omg_tools_torch import (Holonomic, Environment, Obstacle, Rectangle,
                             Square, Point2point, Simulator)
from _smoke import run

vehicle = Holonomic()
vehicle.set_initial_conditions([-1.8, -1.8])
vehicle.set_terminal_conditions([2.0, 2.0])
environment = Environment(room={"shape": Square(5.0)})
environment.add_obstacle(Obstacle(
    {"position": [0.0, 0.0], "angular_velocity": np.pi / 6.0},
    shape=Rectangle(width=1.6, height=0.25),
    options={"horizon_time": 10.0}))
problem = Point2point(vehicle, environment, freeT=False)
problem.set_options({"verbose": 0})
problem.init()
run(problem, Simulator(problem))
print("revolving_door: final", vehicle.signals["pose"][:2, -1])

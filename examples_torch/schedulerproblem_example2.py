"""Scheduler over a vast environment with combined corridor frames
(two-frame L-shape corridors, so that moving obstacles around the corner
are seen early): the JAX package's examples/schedulerproblem_example2.py
on omg_tools_torch (omgtools' examples/schedulerproblem_example2.py).  Its
local problems (186 variables) take K1's global variant on the card."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
from omg_tools_torch import (Holonomic, Environment, Obstacle, Circle,
                             Rectangle, SchedulerProblem, Simulator)
from _smoke import run

vehicle = Holonomic(shapes=Circle(0.5), bounds={"vmax": 2, "vmin": -2,
                                                "amax": 4, "amin": -4})
vehicle.set_initial_conditions([5.0, 0.0])
vehicle.set_terminal_conditions([40.0, 20.0])

environment = Environment(room={"shape": Rectangle(width=60, height=30),
                                "position": [30, 10]})
environment.add_obstacle(Obstacle({"position": [10.0, 0.0]},
                                  shape=Rectangle(width=2.0, height=2.0)))
# slow mover near the corner of the corridor: membership is re-checked
# every period and triggers a frame rebuild when it enters/leaves
trajectories = {"velocity": {"time": [0.0], "values": [[0.0, -0.1]]}}
environment.add_obstacle(Obstacle({"position": [22.5, 12.5]},
                                  shape=Rectangle(width=2.0, height=2.0),
                                  simulation={"trajectories": trajectories}))

problem = SchedulerProblem(vehicle, environment, frame_type="corridor",
                           n_frames=2, n_cells=[25, 25])
problem.set_options({"verbose": 0})
problem.init()
run(problem, Simulator(problem))
print("scheduler2: final", vehicle.signals["pose"][:2, -1],
      "switches:", problem.cnt_frame_switches,
      "builds:", problem.cnt_problem_builds)

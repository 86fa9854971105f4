"""Two holonomic vehicles with inter-vehicle collision avoidance: the JAX
package's examples/p2p_holonomic_interveh_avoidance.py on omg_tools_torch
(omgtools' examples/p2p_holonomic_interveh_avoidance.py; one separating
hyperplane between the two vehicles).  The default generic ALM mode runs
on the card."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
from omg_tools_torch import (Holonomic, Fleet, Environment, Square,
                             Point2point, Simulator)
from _smoke import run

veh1 = Holonomic()
veh1.set_initial_conditions([-1.5, -1.5])
veh1.set_terminal_conditions([1.5, 1.5])
veh2 = Holonomic()
veh2.set_initial_conditions([1.5, -1.5])
veh2.set_terminal_conditions([-1.5, 1.5])
fleet = Fleet([veh1, veh2])
environment = Environment(room={"shape": Square(5.0)})
problem = Point2point(fleet, environment, freeT=False,
                      options={"inter_vehicle_avoidance": True})
problem.set_options({"verbose": 0})
problem.init()
run(problem, Simulator(problem))
print("interveh: finals", veh1.signals["pose"][:2, -1],
      veh2.signals["pose"][:2, -1])

"""Export the MPC stepper as an embedded C++ runtime.  The JAX package's
examples/p2p_holonomic_export.py on omg_tools_torch: the export is
computed on the host in float64 and written to export_p2p_holonomic/
beside this script (build: make && ./test .)."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
from omg_tools_torch import (Holonomic, Environment, Obstacle, Rectangle,
                             Square, Point2point)

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    vehicle = Holonomic()
    vehicle.set_initial_conditions([-1.5, -1.5])
    vehicle.set_terminal_conditions([2.0, 2.0])
    environment = Environment(room={"shape": Square(5.0)})
    environment.add_obstacle(Obstacle({"position": [0.4, 0.2]},
                                      shape=Rectangle(width=0.4, height=1.0)))
    problem = Point2point(vehicle, environment, freeT=False)
    problem.set_options({"verbose": 0})
    problem.init()
    out = os.path.join(HERE, "export_p2p_holonomic")
    problem.export(options={"directory": out}).run()
    print(f"export written to {out}/")


if __name__ == "__main__":
    main()

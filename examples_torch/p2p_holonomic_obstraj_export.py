"""Export the MPC runtime for a problem with a spline-trajectory obstacle:
its motion over the horizon is a caller-supplied coefficient spline,
marshalled into the embedded runtime and advanced each control period.
The JAX package's examples/p2p_holonomic_obstraj_export.py on
omg_tools_torch, written to export_obstraj/ beside this script (build:
make obstraj && ./test_obstraj .)."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
import numpy as np
from omg_tools_torch import (Holonomic, Environment, Obstacle, Rectangle,
                             Circle, Square, Point2point)

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    vehicle = Holonomic(options={"safety_distance": 0.1})
    vehicle.set_initial_conditions([-1.5, -1.5])
    vehicle.set_terminal_conditions([2.0, 2.0])

    basis = vehicle.basis
    n_b = len(basis)
    # drift from (1.5, 0.5) toward (0.5, 0.9) over the horizon
    coeffs = np.stack([np.linspace(1.5, 0.5, n_b),
                       np.linspace(0.5, 0.9, n_b)], axis=1)

    environment = Environment(room={"shape": Square(5.0)})
    environment.add_obstacle(Obstacle({"position": [1.7, -0.5]},
                                      shape=Rectangle(width=3.0, height=0.2)))
    obstacle = Obstacle({"position": [1.5, 0.5]}, shape=Circle(0.4))
    obstacle.set_options({"spline_traj": True,
                          "spline_params": {"knots": basis.knots,
                                            "degree": basis.degree,
                                            "coeffs": coeffs}})
    environment.add_obstacle(obstacle)

    problem = Point2point(vehicle, environment, freeT=False)
    problem.set_options({"verbose": 0})
    problem.init()
    out = os.path.join(HERE, "export_obstraj")
    problem.export(options={"directory": out}).run()
    print(f"export written to {out}/  (make obstraj && ./test_obstraj .)")


if __name__ == "__main__":
    main()

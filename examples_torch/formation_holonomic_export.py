"""Export the distributed two-phase ADMM formation runtime as embedded
C++.  The JAX package's examples/formation_holonomic_export.py on
omg_tools_torch, written to export_f/ beside this script (build: make
formation)."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
import numpy as np
from omg_tools_torch import (Holonomic, Fleet, Environment, Square,
                             FormationPoint2point)
from omg_tools_torch.environment.shapes import RegularPolyhedron

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    N = 4
    vehicles = [Holonomic() for _ in range(N)]
    fleet = Fleet(vehicles)
    configuration = RegularPolyhedron(0.4 * np.sqrt(2), N, np.pi / 4).vertices.T
    fleet.set_configuration(configuration.tolist())
    fleet.set_initial_conditions(
        (np.array([-1.5, -1.5]) + configuration).tolist())
    fleet.set_terminal_conditions(
        (np.array([2.0, 2.0]) + configuration).tolist())
    environment = Environment(room={"shape": Square(5.0)})
    problem = FormationPoint2point(fleet, environment,
                                   options={"horizon_time": 10, "rho": 1.0})
    problem.set_options({"verbose": 0})
    problem.init()
    out = os.path.join(HERE, "export_f")
    problem.export({"directory": out}).run()
    print(f"export written to {out}/ (build: make formation)")


if __name__ == "__main__":
    main()

"""Export the distributed rendezvous (free-terminal consensus) runtime as
embedded C++.  The JAX package's examples/rendezvous_holonomic_export.py
on omg_tools_torch, written to export_r/ beside this script (build: make
rendezvous)."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
import numpy as np
from omg_tools_torch import (Holonomic, Fleet, Environment, Square,
                             RendezVous)

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    N = 4
    vehicles = [Holonomic() for _ in range(N)]
    fleet = Fleet(vehicles)
    rel = np.array([[0.3, 0.3], [0.3, -0.3], [-0.3, -0.3], [-0.3, 0.3]])
    fleet.set_configuration(rel.tolist())
    starts = np.array([[-1.6, -1.6], [1.6, -1.6], [1.6, 1.6], [-1.6, 1.6]])
    fleet.set_initial_conditions(starts.tolist())
    fleet.set_terminal_conditions((starts * 0).tolist())
    environment = Environment(room={"shape": Square(5.0)})
    problem = RendezVous(fleet, environment,
                         options={"horizon_time": 10, "rho": 1.0})
    problem.set_options({"verbose": 0})
    problem.init()
    out = os.path.join(HERE, "export_r")
    problem.export({"directory": out}).run()
    print(f"export written to {out}/ (build: make rendezvous)")


if __name__ == "__main__":
    main()

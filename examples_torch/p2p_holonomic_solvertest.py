"""Solver back-end comparison on the canonical point-to-point scene: the
ALM (default), the interior-point backend (``ops/solver.py``) and the
independent scipy reference on the same problem, their objectives and
feasibility compared.  The JAX package's
examples/p2p_holonomic_solvertest.py on omg_tools_torch (omgtools'
example of the same name switches Ipopt, WORHP and SNOPT).  The ALM and
the IPM run on the card, the scipy reference on the host; the IPM does
not converge on this scene (its KKT error stays ~10-100, in the JAX
package too), so only the ALM's objective is held to the reference."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
import torch
from omg_tools_torch import (Holonomic, Environment, Obstacle, Rectangle,
                             Circle, Square, Point2point)

results = {}
for solver in ("alm", "ipm", "scipy"):
    vehicle = Holonomic(options={"safety_distance": 0.1})
    vehicle.set_initial_conditions([-1.5, -1.5])
    vehicle.set_terminal_conditions([2.0, 2.0])
    environment = Environment(room={"shape": Square(5.0)})
    environment.add_obstacle(Obstacle({"position": [1.7, -0.5]},
                                      shape=Rectangle(width=3.0, height=0.2)))
    environment.add_obstacle(Obstacle({"position": [1.5, 0.5]},
                                      shape=Circle(0.4)))
    problem = Point2point(vehicle, environment,
                          {"verbose": 0, "solver": solver}, freeT=False)
    problem.init()
    problem.initialize(0.0)
    problem.solve(0.0, 0.1)
    tr = problem.transcription
    f = float(tr.objective(
        torch.as_tensor(problem._x_result),
        torch.as_tensor(problem.pack_parameters(0.0))))
    results[solver] = (f, problem.solver_stats.get(
        "feas", problem.solver_stats["kkt_err"]))
    print(f"{solver:6s} objective={f:.6f}  feas={results[solver][1]:.2e}  "
          f"t={problem.solver_stats['time']*1000:.1f} ms")

f_ref = results["scipy"][0]
for solver in ("alm", "ipm"):
    gap = abs(results[solver][0] - f_ref)
    print(f"{solver} vs scipy objective gap: {gap:.2e}")
assert abs(results["alm"][0] - f_ref) < 5e-2 * max(1.0, abs(f_ref))

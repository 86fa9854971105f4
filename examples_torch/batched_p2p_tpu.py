"""The batched runner: thousands of randomized point-to-point MPC
scenarios advance in lockstep in one batched rollout on one card.  The
JAX package's examples/batched_p2p_tpu.py on omg_tools_torch; it runs on
CUDA (OMG_SMOKE=1: 8 scenarios, 2 steps)."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
import numpy as np
import torch
from omg_tools_torch import (Holonomic, Environment, Obstacle, Circle, Square,
                             Point2point, BatchedP2PRunner)

SMOKE = bool(os.environ.get("OMG_SMOKE"))
BATCH = 8 if SMOKE else 256
N_STEPS = 2 if SMOKE else 20


def main():
    vehicle = Holonomic()
    vehicle.set_initial_conditions([-1.5, -1.5])
    vehicle.set_terminal_conditions([2.0, 2.0])
    environment = Environment(room={"shape": Square(5.0)})
    environment.add_obstacle(Obstacle({"position": [1.5, 0.5]},
                                      shape=Circle(0.4)))
    problem = Point2point(vehicle, environment, freeT=False)
    problem.set_options({"verbose": 0})
    problem.init()

    runner = BatchedP2PRunner(problem, dtype=torch.float32)
    rng = np.random.default_rng(0)
    starts = np.tile([-1.5, -1.5], (BATCH, 1)) + rng.uniform(-0.3, 0.3, (BATCH, 2))
    goals = np.tile([2.0, 2.0], (BATCH, 1)) + rng.uniform(-0.3, 0.3, (BATCH, 2))
    x0, p0, state = runner.make_batch(starts, goals)
    st = runner.init_solver_state(x0, p0)
    roll = runner.rollout_fn(N_STEPS, outer_iter=4)
    carry, states = roll(st, p0, state)
    d1 = np.linalg.norm(states[:, -1].double().cpu().numpy() - goals, axis=1)
    print(f"batched_p2p_tpu: {BATCH} scenarios x {N_STEPS} steps on "
          f"{runner.structure}, median final goal distance "
          f"{np.median(d1):.3f} m")


if __name__ == "__main__":
    main()

"""Shared example driver: a full closed-loop run by default, two MPC
steps in smoke mode (OMG_SMOKE=1).  The problems run on the CUDA card."""

import os

SMOKE = bool(os.environ.get("OMG_SMOKE"))


def run(problem, simulator, n_smoke_steps=2):
    if SMOKE:
        problem.initialize(0.0)
        for _ in range(n_smoke_steps):
            simulator.update()
        return
    simulator.run()

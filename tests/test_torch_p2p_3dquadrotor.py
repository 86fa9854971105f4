"""The port's batched runner on bench.py's
p2p_3dquadrotor: one SimpleQuadrotor3D (degree-4 position splines, thrust
and attitude bounds) in a 5 m cube with a 0.5 m sphere, 10 s horizon at
10 Hz; its rollout recovers by the scaled violation.

The tests are tests/torch_bench_configs.py's (its docstring gives the
tolerances), run on this configuration.
"""

CONFIG = "p2p_3dquadrotor"

from torch_bench_configs import *  # noqa: E402,F401,F403  the shared tests

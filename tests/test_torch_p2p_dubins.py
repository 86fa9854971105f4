"""The port's batched runner on bench.py's
p2p_dubins: one Dubins vehicle with the quadratic ``substitution`` lift
(w = tg_ha^2 and the lifted position splines) in a 5 m room with a 0.4 m
circle, 10 s horizon at 10 Hz; its rollout recovers by the raw
violation.

The tests are tests/torch_bench_configs.py's (its docstring gives the
tolerances), run on this configuration.
"""

CONFIG = "p2p_dubins"

from torch_bench_configs import *  # noqa: E402,F401,F403  the shared tests

"""The examples' free-time warehouse (a Holonomic vehicle with a 0.1 m
safety distance among six racks and two moving circles; n_x 395) held to
the JAX package in float64 on the CPU: the checks of
tests/test_torch_free_time.py.  It stays on the CPU: K1's
shared-memory variant takes at most ~168 float64 rows (ROADMAP Queue 2,
"K1 beyond shared memory")."""

import pytest

from test_torch_free_time import *  # noqa: F401,F403


@pytest.fixture(params=["warehouse"])
def case(request):
    return request.param


@pytest.fixture(params=["warehouse"])
def free_t_case(request):
    return request.param


@pytest.fixture(params=["warehouse"])
def stored_case(request):
    return request.param


@pytest.fixture(params=["warehouse"])
def dispatch_case(request):
    return request.param

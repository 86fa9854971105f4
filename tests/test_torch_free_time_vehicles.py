"""The Bicycle's siblings of the port, the AGV and the Trailer, on
tests/test_vehicles.py's scenes (free time) held to the JAX package in
float64 on the CPU: the checks of tests/test_torch_free_time.py."""

import pytest

from test_torch_free_time import *  # noqa: F401,F403


@pytest.fixture(params=["agv", "trailer"])
def case(request):
    return request.param


@pytest.fixture(params=["agv", "trailer"])
def free_t_case(request):
    return request.param


@pytest.fixture(params=["trailer"])
def stored_case(request):
    return request.param


@pytest.fixture(params=["agv", "trailer"])
def dispatch_case(request):
    return request.param

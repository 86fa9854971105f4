"""The generic ALM mode on the card against the same solve on the CPU.

On a CUDA device the Gauss-Newton generic mode replays CUDA graphs of its
Newton step and constraint evaluation, and the ``eigh`` mode, whose
eigensolver synchronizes with the host, runs eagerly.  Both are held here
to their CPU solves, in float64, on the small NLPs of
``tests/test_torch_alm_modes.py`` (which holds the CPU solves to the JAX
package), where the solves converge and rounding stays small: x within
1e-9 and the same iteration counts.  Every test needs the card; this file
imports no JAX:

    python -m pytest tests/test_torch_alm_cuda.py -m gpu --noconftest -q
"""

import gc

import numpy as np
import pytest
import torch

from omg_tools_torch.ops import psd_kernels as pk
from omg_tools_torch.ops.alm import ALMOptions, CapturedCall, make_alm_solver
from omg_tools_torch.ops.solver import BIG

TOL = 1e-9


# (n_x, f(x, p), g(x, p), lb, ub, x0, p0)
def _qp_equality():
    return (2, lambda x, p: x @ x + p[0] * x[0],
            lambda x, p: torch.stack([x[0] + x[1]]),
            [1.0], [1.0], [0.0, 0.0], [0.0])


def _box_upper():
    return (1, lambda x, p: (x[0] - 2.0) ** 2, lambda x, p: x[:1],
            [0.0], [1.0], [0.5], [0.0])


def _hs071():
    def g(x, p):
        return torch.cat([torch.stack([x[0] * x[1] * x[2] * x[3], x @ x]),
                          x])
    return (4, lambda x, p: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2], g,
            [25.0, 40.0, 1, 1, 1, 1], [BIG, 40.0, 5, 5, 5, 5],
            [1.0, 5.0, 5.0, 1.0], [0.0])


def _shifted_qp():
    return (2, lambda x, p: ((x - p) ** 2).sum(), lambda x, p: x,
            [0.0, 0.0], [BIG, BIG], [0.5, 0.5], [-1.0, 2.0])


PROBLEMS = {"qp_equality": _qp_equality, "box_active_upper": _box_upper,
            "hs071": _hs071, "shifted_qp": _shifted_qp}
# HS071 under Gauss-Newton does not converge in its budget and amplifies
# rounding (tests/test_torch_alm_modes.py), so it runs under eigh only
CASES = [(name, hessian) for name in sorted(PROBLEMS)
         for hessian in ("gn", "eigh") if (name, hessian) != ("hs071", "gn")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name,hessian", CASES)
def test_cuda_generic_solve_matches_cpu(cuda_device, name, hessian):
    """Three lanes (numpy-seeded moves of the case's start and parameters)
    solved on the CPU and twice on the card: the Gauss-Newton mode
    launches K1 once a Newton step, from its graph (the first solve
    captures it, and the capture's warm-up runs one step eagerly: one
    launch more); the eigh mode launches none.  The card's two solves are
    equal bit for bit."""
    n, f, g, lb, ub, x0, p0 = PROBLEMS[name]()
    solver = make_alm_solver(f, g, n, np.asarray(lb, float),
                             np.asarray(ub, float),
                             ALMOptions(hessian=hessian))
    rng = np.random.default_rng(len(name))
    x0 = np.tile(np.asarray(x0, float), (3, 1)) \
        + rng.uniform(-0.1, 0.1, (3, n))
    p0 = np.tile(np.asarray(p0, float), (3, 1)) \
        + rng.uniform(-0.3, 0.3, (3, len(p0)))
    out, launched = [], []
    for device in (torch.device("cpu"), cuda_device, cuda_device):
        before = pk.psd_solve.launches
        st = solver(torch.as_tensor(x0, device=device),
                    torch.as_tensor(p0, device=device), lb, ub)
        launched.append(pk.psd_solve.launches - before)
        out.append((st.x.cpu().numpy(), st.n_iter.cpu().numpy()))
    (x_cpu, n_cpu), (x_card, n_card), (x_again, n_again) = out
    np.testing.assert_array_equal(n_card, n_cpu)
    np.testing.assert_array_equal(n_again, n_cpu)
    steps = int(n_card.max())
    want = [0, steps + 1, steps] if hessian == "gn" else [0, 0, 0]
    assert launched == want
    np.testing.assert_array_equal(x_again, x_card)
    np.testing.assert_allclose(x_card, x_cpu, rtol=0, atol=TOL)


@pytest.mark.gpu
def test_cuda_capture_runs_without_the_cyclic_collector(cuda_device):
    """A dead reference cycle that holds a captured graph (an old G-code
    window's problem) must not be collected inside a later capture: the
    collector is off while ``CapturedCall`` captures and on again after,
    and the warm-up runs with it as the caller left it.  The new graph
    replays right with such cycles waiting for the collector."""
    x = torch.arange(8.0, device=cuda_device)
    for _ in range(3):
        cycle = [CapturedCall(lambda v: (v + 1.0,), (x,))]
        cycle.append(cycle)
    del cycle
    seen = []

    def fn(v):
        seen.append(gc.isenabled())
        return (v * 2.0 + 1.0,)
    assert gc.isenabled()
    call = CapturedCall(fn, (x,))
    assert seen == [True, False] and gc.isenabled()
    out = call(x)[0].clone()
    torch.cuda.synchronize()
    assert torch.equal(out, x * 2.0 + 1.0)
    gc.collect()
    assert torch.equal(call(x + 1.0)[0], x * 2.0 + 3.0)

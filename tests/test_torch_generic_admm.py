"""The port's generic ADMM (``problems/generic_admm.py``) held to the JAX
package in float64 on the CPU.

The scene is tests/test_distributed.py:238's (three Holonomic vehicles on
a 0.2 m triangle; the shared quantity is each vehicle's raw position
splines, and each edge holds the rigid offset z_i - z_j = r_ij), built by
both packages on the same cut x-update budget (one outer round of 6 inner
iterations).  Checked: the AD-extracted affine map s = G x + H p + s0 and
both packages' refusal of a shared quantity that is not affine; the
edge-projection z-update and the plain consensus z-update, both on the
same shared iterates and multipliers with the x-updates replaced by the
identity (no solver runs); ``initialize`` and two more dual updates
from the straight-line guesses plus the same seeded 1e-2 noise.  Every
x-update of that run is a cold solve (the groups' ALM states dropped
before each), so that the JAX package compiles one solver program for
this file (~25 s on a CPU); the warm x-update is the engine's
``_x_update``, held to the JAX package by tests/test_torch_rendezvous.py.
Both packages' problems are built once for the file.

Tolerances: G, H, s0 to 1e-12; the solver-free z-updates to 1e-13; the
consensus iterates (X, Z, L) and the residuals of the cut ``initialize``
to 1e-8 (``tests/test_torch_fleet.py``'s ADMM bound).

The JAX package is imported by fixtures, so that the ``gpu`` test runs
where JAX is not installed:

    python -m pytest tests/test_torch_generic_admm.py -m gpu --noconftest -q
"""

from collections import namedtuple
from importlib import import_module

import numpy as np
import pytest
import torch

import omg_tools_torch as T
from omg_tools_torch.ops import psd_kernels as pk

BUDGET = {"outer_iter": 1, "inner_iter": 6}
UPDATES = 3
NOISE = 1e-2
TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These eager solves are small: torch's intra-op threads only spin
    beside the other test processes.  One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def J():
    """The JAX package (float64)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    return pytest.importorskip("omg_tools_tpu")


def _positions(problem, vehicle, splines):
    # the raw position splines: the shared quantity the couplings act on
    return [splines[0], splines[1]]


def _generic(m, shared_fn=_positions, edges=True, **options):
    """tests/test_distributed.py:238's problem in the package ``m``."""
    shapes = import_module(m.__name__ + ".environment.shapes")
    generic = import_module(m.__name__ + ".problems.generic_admm")
    N = 3
    vehicles = [m.Holonomic() for _ in range(N)]
    fleet = m.Fleet(vehicles)
    configuration = shapes.RegularPolyhedron(0.2, N, np.pi / 4).vertices.T
    fleet.set_configuration(configuration.tolist())
    fleet.set_initial_conditions(
        (np.array([-1.5, -1.5]) + configuration).tolist())
    fleet.set_terminal_conditions(
        (np.array([2.0, 2.0]) + configuration).tolist())
    env = m.Environment(room={"shape": m.Square(5.0)})
    rel = {v: np.asarray(sorted(fleet.configuration[v].items()))[:, 1]
           for v in vehicles}

    def edge_constraint(problem, veh_i, veh_j):
        n = problem.n_sh // 2
        eye = np.eye(2 * n)
        A = np.concatenate([eye, -eye], axis=1)   # z_i - z_j = r_ij
        r = rel[veh_i] - rel[veh_j]
        b = np.concatenate([np.full(n, r[0]), np.full(n, r[1])])
        return A, b

    problem = generic.GenericADMMProblem(
        fleet, env, shared_fn=shared_fn,
        edge_constraint=edge_constraint if edges else None,
        options={"horizon_time": 10, "rho": 1.0, "init_iter": 1,
                 "verbose": 0, "solver_options": BUDGET, **options})
    problem.init()
    problem.rel = rel
    return problem


def _close(a, b, tol, what):
    err = float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
    assert err <= tol, f"{what}: {err} > {tol}"


@pytest.fixture(scope="module")
def pair(J):
    """(JAX problem, port problem), built once for the file."""
    return _generic(J), _generic(T, device="cpu")


@pytest.fixture(scope="module")
def initialized(pair):
    """The pair after ``initialize(0.0)`` and UPDATES - 1 more dual
    updates, every x-update cold, from the same noisy start."""
    rng = np.random.default_rng(0)
    noise = NOISE * rng.standard_normal(pair[0].groups[0].X.shape)
    for problem in pair:
        problem.groups[0].X = problem.groups[0].X + noise
        problem._reset_dual_state()
        problem.initialize(0.0)
        for _ in range(UPDATES - 1):
            problem.groups[0].alm_state = None
            problem.dual_update(0.0)
    return pair


def test_affine_map_matches_jax(pair):
    pj, pt = pair
    gj, gt = pj.groups[0], pt.groups[0]
    tj, tt = gj.template.transcription, gt.template.transcription
    assert (tt.n_x, tt.n_g, tt.n_p) == (tj.n_x, tj.n_g, tj.n_p)
    assert pt.n_sh == pj.n_sh and gt.S_idx is None
    assert gt.G.shape == (pt.n_sh, tt.n_x)
    assert np.count_nonzero(gt.G) == pt.n_sh   # one coefficient a row
    _close(gt.G, gj.G, 1e-12, "G")
    _close(gt.H, gj.H, 1e-12, "H")
    _close(gt.s0, gj.s0, 1e-12, "s0")
    for i in range(pt.N):
        _close(pt._s_of_vehicle(i), pj._s_of_vehicle(i), 1e-12, f"s {i}")
    _close(pt._shared_shift(), pj._shared_shift(), 1e-12, "shift")
    _close(pt._shared_transform(0.04), pj._shared_transform(0.04), 1e-12,
           "transform")
    assert pt._shared_transform(0.0) is pj._shared_transform(0.0) is None
    _close(pt._pack_params(gt, 0.3), pj._pack_params(gj, 0.3), 1e-12, "P")


def test_non_affine_shared_quantity_is_refused(J):
    """Both packages raise ValueError at init on a shared quantity that is
    not affine in (x, p) (the squared x position spline)."""
    def squared(problem, vehicle, splines):
        return [splines[0] * splines[0]]
    for m, options in ((J, {}), (T, {"device": "cpu"})):
        with pytest.raises(ValueError, match="not affine"):
            _generic(m, shared_fn=squared, **options)


def test_initialize_matches_jax(initialized):
    pj, pt = initialized
    assert len(pt.residuals) == len(pj.residuals) == UPDATES
    _close(np.asarray(pt.residuals), np.asarray(pj.residuals), TOL,
           "residuals")
    _close(pt.groups[0].X, pj.groups[0].X, TOL, "X")
    _close(pt.Z, pj.Z, TOL, "Z")
    _close(pt.L, pj.L, TOL, "L")
    assert pt.groups[0].alm_state.x.dtype == torch.float64
    assert pt.residuals[-1][0] < pt.residuals[0][0]


@pytest.mark.parametrize("edges", [True, False])
def test_z_update_matches_jax(initialized, monkeypatch, edges):
    """Solver-free dual updates (the x-updates replaced by the identity in
    both packages) on the same shared iterates and multipliers: the
    edge-projection z-update (Z reshaped to (n_edges, 2, n_sh) at the
    first one) or, without edge constraints, the consensus z-update."""
    pj, pt = initialized
    rng = np.random.default_rng(3)
    Stub = namedtuple("Stub", "x rho")
    gj, gt = pj.groups[0], pt.groups[0]
    X = gj.X + 0.1 * rng.standard_normal(gj.X.shape)
    gj.X, gt.X = X.copy(), X.copy()
    monkeypatch.setattr(gj, "vsolve", lambda X, P: Stub(X, X[:, 0]))
    monkeypatch.setattr(gj, "vresolve", lambda X, P, st: Stub(X, X[:, 0]))
    monkeypatch.setattr(pt, "_x_update", lambda group, current_time: None)
    for problem in (pj, pt):
        if not edges:
            monkeypatch.setattr(problem, "edge_constraint", None)
        problem._reset_dual_state()
    L = rng.standard_normal(pj.L.shape)
    pj.L, pt.L = L.copy(), L.copy()
    for k in range(3):
        rj, rt = pj.dual_update(0.0), pt.dual_update(0.0)
        _close(rt, rj, 1e-13, f"residuals {k}")
        _close(pt.Z, pj.Z, 1e-13, f"Z {k}")
        _close(pt.L, pj.L, 1e-13, f"L {k}")
        _close(pt._pack_params(gt, 0.0), pj._pack_params(gj, 0.0), 1e-13,
               f"P {k}")
    n_sh = pt.n_sh
    assert pt.Z.shape == ((pt.n_edges, 2, n_sh) if edges
                          else (pt.n_edges, n_sh))
    if edges:
        # the z copies hold the rigid offsets exactly
        n = n_sh // 2
        for e in range(pt.n_edges):
            i, j = e, (e + 1) % pt.N
            r = pt.rel[pt.vehicles[i]] - pt.rel[pt.vehicles[j]]
            d = pt.Z[e, 0] - pt.Z[e, 1]
            _close(d, np.r_[np.full(n, r[0]), np.full(n, r[1])], 1e-12,
                   "offsets")


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_dual_updates_match_cpu(cuda_device):
    """Two edge-projection dual updates with the x-updates on the card (K1
    in every Newton step) against the same updates on the CPU, float64."""
    out = {}
    for device in ("cpu", cuda_device):
        problem = _generic(T, device=device)
        rng = np.random.default_rng(0)
        problem.groups[0].X = problem.groups[0].X + NOISE * \
            rng.standard_normal(problem.groups[0].X.shape)
        problem._reset_dual_state()
        before = pk.psd_solve.launches
        for _ in range(2):
            problem.dual_update(0.0)
        out[str(device)] = (problem, pk.psd_solve.launches - before)
    (pc, kc), (pg, kg) = out["cpu"], out["cuda"]
    assert kc == 0 and kg > 0
    assert pg.groups[0].alm_state.x.is_cuda
    _close(pg.groups[0].X, pc.groups[0].X, TOL, "X")
    _close(pg.Z, pc.Z, TOL, "Z")
    _close(pg.L, pc.L, TOL, "L")

"""The port's dual decomposition (``problems/dualdecomposition.py``) held
to the JAX package in float64 on the CPU.

The scene is tests/test_distributed.py:95's (three Holonomic vehicles on
a 0.2 m triangle with asymmetric starts, a 6 m room, alpha 0.3), built by
both packages on the same cut x-update budget (one outer round of 6 inner
iterations) and run through ``initialize`` and two more dual updates
from the straight-line guesses plus the same seeded 1e-2 noise (from the
guesses themselves the x-update is degenerate: rows sit on their bounds).
Every x-update of that run is a cold solve (the group's ALM state dropped
before each), so that the JAX package compiles one solver program for
this file (~25 s on a CPU); the warm x-update is the engine's
``_x_update``, held to the JAX package by tests/test_torch_rendezvous.py.
The multiplier layout is checked apart, for
N = 2 (``_mu`` is L[i, 0] alone) and N = 3, on dual updates whose
x-updates are replaced by the identity in both packages, so that no
solver runs.

Tolerances: evaluations to 1e-12 (relative), the consensus iterates (X,
L, S_prev) and the residuals to 1e-8 (``tests/test_torch_fleet.py``'s
ADMM bound); the solver-free dual updates to 1e-14.

The JAX package is imported by fixtures, so that the ``gpu`` test runs
where JAX is not installed:

    python -m pytest tests/test_torch_dualdec.py -m gpu --noconftest -q
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


def _dd(m, N=3, **options):
    """tests/test_distributed.py:95's fleet (make_fleet(asym=True)) with
    N vehicles."""
    shapes = import_module(m.__name__ + ".environment.shapes")
    vehicles = [m.Holonomic() for _ in range(N)]
    fleet = m.Fleet(vehicles)
    configuration = shapes.RegularPolyhedron(0.2, N, np.pi / 4).vertices.T
    init_positions = np.array([-1.5, -1.5]) + configuration \
        + np.arange(N)[:, None] * 0.3
    fleet.set_configuration(configuration.tolist())
    fleet.set_initial_conditions(init_positions.tolist())
    fleet.set_terminal_conditions(
        (np.array([2.0, 2.0]) + configuration).tolist())
    env = m.Environment(room={"shape": m.Square(6.0)})
    problem = m.FormationPoint2pointDualDecomposition(fleet, env, options={
        "horizon_time": 10, "alpha": 0.3, "init_iter": 1,
        "verbose": 0, "solver_options": BUDGET, **options})
    problem.init()
    return problem


def _noisy_start(problem, seed=0):
    rng = np.random.default_rng(seed)
    for group in problem.groups:
        group.X = group.X + NOISE * rng.standard_normal(group.X.shape)
    problem._reset_dual_state()


def _close(a, b, tol, what):
    err = float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
    assert err <= tol, f"{what}: {err} > {tol}"


@pytest.fixture(scope="module")
def pair(J):
    """(JAX problem, port problem), built once for the file."""
    return _dd(J), _dd(T, device="cpu")


@pytest.fixture(scope="module")
def initialized(pair):
    """The pair after ``initialize(0.0)`` and UPDATES - 1 more dual
    updates, every x-update cold, from the same noisy start."""
    for problem in pair:
        _noisy_start(problem)
        problem.initialize(0.0)
        for _ in range(UPDATES - 1):
            problem.groups[0].alm_state = None
            problem.dual_update(0.0)
    return pair


def test_template_matches_jax(J, pair):
    import jax.numpy as jnp
    pj, pt = pair
    gj, gt = pj.groups[0], pt.groups[0]
    tj, tt = gj.template.transcription, gt.template.transcription
    assert (tt.n_x, tt.n_g, tt.n_p) == (tj.n_x, tj.n_g, tj.n_p)
    assert pt.n_sh == pj.n_sh and pt.prox_w == pj.prox_w == 8 * 0.3
    np.testing.assert_array_equal(gt.S_idx, gj.S_idx)
    np.testing.assert_array_equal(pt.S_prev, pj.S_prev)
    np.testing.assert_array_equal(pt._pack_params(gt, 0.3),
                                  pj._pack_params(gj, 0.3))
    rng = np.random.default_rng(0)
    x = gj.X[0] + 0.1 * rng.standard_normal(tj.n_x)
    p = pj._pack_params(gj, 0.0)[0] + 0.01 * rng.standard_normal(tj.n_p)
    fj = float(tj.objective(jnp.asarray(x), jnp.asarray(p)))
    gvj = np.asarray(tj.constraints(jnp.asarray(x), jnp.asarray(p)))
    ft, gvt = tt.objective_and_constraints(torch.as_tensor(x),
                                           torch.as_tensor(p))
    assert abs(float(ft) - fj) <= 1e-12 * abs(fj)
    _close(gvt.numpy(), gvj, 1e-12 * np.max(np.abs(gvj)), "g")


def test_initialize_matches_jax(initialized):
    pj, pt = initialized
    assert len(pt.residuals) == len(pj.residuals) == UPDATES
    # the DD residual is the max-norm mismatch, the dual one NaN
    _close(np.asarray(pt.residuals)[:, 0], np.asarray(pj.residuals)[:, 0],
           TOL, "residuals")
    assert np.isnan(np.asarray(pt.residuals)[:, 1]).all()
    _close(pt.groups[0].X, pj.groups[0].X, TOL, "X")
    _close(pt.L, pj.L, TOL, "L")
    _close(pt.S_prev, pj.S_prev, TOL, "S_prev")
    assert pt._dd_iter == pj._dd_iter == UPDATES
    assert pt.groups[0].alm_state.x.dtype == torch.float64


def test_residual_does_not_increase(initialized):
    """tests/test_distributed.py:122's criterion over the initial dual
    updates: the consensus mismatch does not increase."""
    pris = [p for p, _ in initialized[1].residuals]
    assert pris[-1] < pris[0] + 1e-9


def test_init_step_reanchors_like_jax(initialized):
    """init_step at a knot passage: it shifts X and L and re-anchors
    S_prev."""
    pj, pt = initialized
    for problem in (pj, pt):
        problem.current_time_prev = 0.0
        problem.init_step(problem.template.knot_time, 0.1)
    _close(pt.groups[0].X, pj.groups[0].X, TOL, "X")
    _close(pt.L, pj.L, TOL, "L")
    _close(pt.S_prev, pj.S_prev, TOL, "S_prev")


@pytest.mark.parametrize("N", [2, 3])
def test_multiplier_layout_matches_jax(J, N):
    """Solver-free dual updates (the x-updates replaced by the identity in
    both packages) from the same random shared iterates: L, mu_i and the
    packed parameters; for N = 2 mu_i is L[i, 0] alone."""
    pj, pt = _dd(J, N=N), _dd(T, N=N, device="cpu")
    rng = np.random.default_rng(N)
    Stub = namedtuple("Stub", "x")
    for gj, gt in zip(pj.groups, pt.groups):
        gj.X = gj.X + 0.1 * rng.standard_normal(gj.X.shape)
        gt.X = gj.X.copy()
        gj.vsolve = lambda X, P: Stub(x=X)
        gj.vresolve = lambda X, P, st: Stub(x=X)
    pt._x_update = lambda group, current_time: None
    for problem in (pj, pt):
        problem._reset_dual_state()
    for k in range(3):
        rj, rt = pj.dual_update(0.0), pt.dual_update(0.0)
        _close(rt[0], rj[0], 1e-14, f"residual {k}")
        _close(pt.L, pj.L, 1e-14, f"L {k}")
        for i in range(N):
            _close(pt._mu(i), pj._mu(i), 1e-14, f"mu {i}")
        _close(pt._pack_params(pt.groups[0], 0.0),
               pj._pack_params(pj.groups[0], 0.0), 1e-14, "P")
    if N == 2:
        # one edge, one slot: each vehicle holds +/- the edge's multiplier
        assert pt.L.shape == (2, 1, pt.n_sh)
        np.testing.assert_array_equal(pt.L[1], -pt.L[0])
        for i in range(N):
            np.testing.assert_array_equal(pt._mu(i), pt.L[i, 0])
    assert not pt.device_loop_capable and pt._runner is None
    assert isinstance(pt, T.DDProblem)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_dual_updates_match_cpu(cuda_device):
    """Two dual updates with the x-updates on the card (K1 in every Newton
    step) against the same updates on the CPU, float64."""
    out = {}
    for device in ("cpu", cuda_device):
        problem = _dd(T, device=device)
        _noisy_start(problem)
        before = pk.psd_solve.launches
        for _ in range(2):
            problem.dual_update(0.0)
        out[str(device)] = (problem, pk.psd_solve.launches - before)
    (pc, kc), (pg, kg) = out["cpu"], out["cuda"]
    assert kc == 0 and kg > 0
    assert pg.groups[0].alm_state.x.is_cuda
    _close(pg.groups[0].X, pc.groups[0].X, TOL, "X")
    _close(pg.L, pc.L, TOL, "L")

"""The port's MultiFrameProblem held to the JAX package in float64 on the
CPU, on the two-room scene of examples/test_multiframe.py
(``chip_smoke.build_vast_scene(m, "multiframe")``: two spline segments,
each with its own motion time, continuity at the joint, n_x 120).

Tolerances: layouts, guesses, parameters and bounds equal; f, g and J at
the initial guess and at a seeded perturbation to 1e-12 relative; the
subgoal guess of ``reinitialize``, trajectory storage over both segments,
the plant's simulation and ``init_step``'s shift of the first segment to
1e-12.  A solve on a cut budget (1 outer x 8 inner iterations, both
packages' problems built with it) from the guess plus a seeded 1e-2 (a
guess whose rows sit on their bounds amplifies rounding without bound)
is held to 4x the largest move of the JAX package's own solve over 5
draws of a 1e-15 relative perturbation of that start
(tests/test_torch_free_time.py's rule), or 1e-10 where rounding alone
separates them.
"""

import contextlib

import numpy as np
import pytest
import torch

import omg_tools_torch as T
from torch_bench_configs import _layout_rows, one_torch_thread  # noqa: F401
import chip_smoke

RTOL = 1e-12
CUT = {"outer_iter": 1, "inner_iter": 8}
START_NOISE = 1e-2
DRAWS = 5
PERTURB = 1e-15
SPREAD_FACTOR = 4.0
ROUNDING_FLOOR = 1e-10


@contextlib.contextmanager
def cut_budget(*packages, budget=CUT):
    """Problems made inside take ``budget`` as their solver options (the
    scheduler's local problems are made with its defaults)."""
    saved = []
    for m in packages:
        cls = m.problems.problem.Problem
        orig = cls.set_default_options

        def patched(self, orig=orig):
            orig(self)
            self.options["solver_options"].update(budget)
        saved.append((cls, orig))
        cls.set_default_options = patched
    try:
        yield
    finally:
        for cls, orig in saved:
            cls.set_default_options = orig


@pytest.fixture(scope="module")
def J():
    """The JAX package (float64)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    return pytest.importorskip("omg_tools_tpu")


@pytest.fixture(scope="module")
def pair(J):
    """(JAX problem, port problem) of the two-room scene, initialized."""
    out = []
    with cut_budget(J, T):
        for m, options in ((J, {}), (T, {"device": "cpu"})):
            problem = chip_smoke.build_scene(m, "multiframe", options)
            problem.init()
            out.append(problem)
    return tuple(out)


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def _start(problem):
    """The first solve's inputs, as the closed loop makes them."""
    problem.initialize(0.0)
    problem.vehicles[0].predict(0.0, 0.1, 0.01, enforce_states=True)
    problem.reinitialize()
    lb, ub = problem.transcription.bounds(0.0)
    return (np.array(problem._x_result, np.float64),
            problem.pack_parameters(0.0), np.asarray(lb), np.asarray(ub))


def test_transcription_matches_jax(pair):
    import jax
    import jax.numpy as jnp
    jp, tp = pair
    a, b = jp.transcription, tp.transcription
    assert (a.n_x, a.n_g, a.n_p) == (b.n_x, b.n_g, b.n_p) == (120, 494, 16)
    for table in ("variables", "parameters"):
        assert _layout_rows(a.layout, table) == \
            _layout_rows(b.layout, table), table
    assert [(c.offset, c.rows) for c in a.layout.constraints] == \
        [(c.offset, c.rows) for c in b.layout.constraints]
    np.testing.assert_array_equal(b.initial_guess(), a.initial_guess())
    P = jp.pack_parameters(0.0)
    np.testing.assert_array_equal(tp.pack_parameters(0.0), P)
    for u, v in zip(a.bounds(0.0), b.bounds(0.0)):
        np.testing.assert_array_equal(v, u)
    x_init = a.initial_guess()
    rng = np.random.default_rng(0)
    jac = jax.jit(jax.jacfwd(a.constraints))
    for x in (x_init, x_init + 0.1 * rng.standard_normal(a.n_x)):
        xj, pj = jnp.asarray(x), jnp.asarray(P)
        xt, pt = torch.as_tensor(x), torch.as_tensor(P)
        _close(b.constraints(xt, pt), a.constraints(xj, pj))
        _close(b.objective(xt, pt), a.objective(xj, pj))
        _close(torch.func.jacfwd(b.constraints)(xt, pt), jac(xj, pj))
    np.testing.assert_allclose(tp._row_scale, jp._row_scale, rtol=1e-10)
    assert tp._structure == "generic"


def test_subgoal_guess_matches_jax(pair):
    """reinitialize: each segment's straight-line guess through the room
    overlap's subgoal, and the solve's parameters and bounds."""
    jp, tp = pair
    for u, v in zip(_start(tp), _start(jp)):
        _close(u, v)


def test_cut_budget_solve_matches_jax(pair):
    import jax.numpy as jnp
    jp, tp = pair
    x0, P, lb, ub = _start(tp)
    x0 = x0 + START_NOISE * np.random.default_rng(2).standard_normal(x0.shape)

    def solve_j(x):
        st = jp._jit_solve(jnp.asarray(x), jnp.asarray(P), jnp.asarray(lb),
                           jnp.asarray(ub))
        return np.asarray(st.x), float(st.feas)
    want, feas = solve_j(x0)
    rng = np.random.default_rng(3)
    spread = max(float(np.abs(solve_j(
        x0 * (1 + PERTURB * rng.standard_normal(x0.shape)))[0]
        - want).max()) for _ in range(DRAWS))
    st = tp._solver(torch.as_tensor(x0)[None], torch.as_tensor(P)[None],
                    lb, ub)
    err = float(np.abs(st.x[0].numpy() - want).max())
    tol = max(SPREAD_FACTOR * spread, ROUNDING_FLOOR)
    assert np.isfinite(st.x.numpy()).all()
    assert err <= tol, (err, spread)
    assert float(st.feas[0]) == pytest.approx(feas, rel=1e-6, abs=tol)


def test_store_and_init_step_across_the_joint(pair):
    """From one seeded iterate with motion times T0 = 2.3 s and T1 = 3.1
    s: the stored trajectories over both segments, one simulated period
    of the plant, and init_step, which re-bases the first segment only on
    its remaining piece and shortens T0; the second segment and T1 stay
    as they were."""
    jp, tp = pair
    x0, *_ = _start(tp)
    _start(jp)
    x = x0 + 0.01 * np.random.default_rng(4).standard_normal(x0.shape)
    for problem in (jp, tp):
        problem._x_result = x.copy()
        problem.set_variables(np.array([2.3]), problem, "T0")
        problem.set_variables(np.array([3.1]), problem, "T1")
        assert problem.segment_times() == [2.3, 3.1]
        problem.store(0.0, 0.1, 0.01)
        problem.simulate(0.0, 0.1, 0.01)
        problem.start_time = 0.0
        problem.init_step(0.1, 0.1)
    vj, vt = jp.vehicles[0], tp.vehicles[0]
    for key in ("state", "input", "pose"):
        _close(vt.trajectories[key], vj.trajectories[key])
        _close(vt.signals[key], vj.signals[key])
    assert tp.compute_objective() == pytest.approx(jp.compute_objective())
    _close(tp._x_result, jp._x_result)
    assert tp.segment_times() == pytest.approx([2.2, 3.1], abs=1e-15)
    sl, _ = tp.transcription.var_slice(tp.vehicles[0], "splines_seg1")
    np.testing.assert_array_equal(tp._x_result[sl], x[sl])
    sl, _ = tp.transcription.var_slice(tp.vehicles[0], "splines_seg0")
    assert np.abs(tp._x_result[sl] - x[sl]).max() > 1e-6
    assert tp.stop_criterium(0.1, 0.1) == jp.stop_criterium(0.1, 0.1)

"""Inter-vehicle avoidance of the port held to the JAX package in float64
on the CPU: examples/p2p_holonomic_interveh_avoidance.py's scene (two
Holonomic vehicles crossing a 5 m room, ``chip_smoke.build_scene(m,
"p2p_holonomic_interveh")``), with ``inter_vehicle_avoidance`` set one
separating hyperplane between the two vehicles (n_x 111), without it none
(n_x 78); the same pair as a FreeTPoint2point, and two vehicles in the
two-room MultiFrameProblem of examples/test_multiframe.py.

Tolerances: layouts (names, offsets, shapes), parameters, guesses and
bounds equal; f, g and J at a seeded perturbation of the guess to 1e-12
relative.  A cut-budget solve (1 outer x 8 inner iterations) from the
guess plus a seeded 1e-2 (straight-line guesses put rows on their
bounds, where a cold solve amplifies rounding without bound) is held to
4x the largest move of the JAX package's own solve over 10 draws of a
1e-15 relative perturbation of that start, or 1e-10
(tests/test_torch_free_time.py's rule).  Each JAX problem is built once
a module, its f and g compiled by ``jax.jit`` (``jax_compiled``); the
JAX package's solver compile (~20 s) is most of the time.
"""

import numpy as np
import pytest
import torch

import omg_tools_torch as T
from omg_tools_torch.ops.alm import make_alm_solver
from torch_bench_configs import (_layout_rows, jax_compiled,  # noqa: F401
                                 one_torch_thread)
import chip_smoke

RTOL = 1e-12
CUT = dict(outer_iter=1, inner_iter=8)
START_NOISE = 1e-2
DRAWS = 10
PERTURB = 1e-15
SPREAD_FACTOR = 4.0
ROUNDING_FLOOR = 1e-10
# n_x with and without the option: two vehicles of 13 x 3 spline
# coefficients and their init parameters, plus one plane (a: 2 x 11, b:
# 1 x 11 coefficients on the union of the vehicles' knots)
N_X = {True: 111, False: 78}

_BUILT = {}


@pytest.fixture(scope="module")
def J():
    """The JAX package (float64)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    return pytest.importorskip("omg_tools_tpu")


def _interveh(m, kind, options):
    """The scene in the package ``m``: ``fixed`` (the example's,
    Point2point with freeT=False), ``free_t`` (the same pair with free
    motion time) or ``multiframe`` (two vehicles through the two rooms of
    examples/test_multiframe.py); not initialized."""
    if kind == "fixed":
        return chip_smoke.build_scene(m, chip_smoke.INTERVEH_SCENE, options)
    vehicles = []
    if kind == "free_t":
        routes = chip_smoke.INTERVEH_ROUTES
        env = m.Environment(room={"shape": m.Square(5.0)})
    else:
        routes = (([-3.0, 0.4], [3.0, -0.4]), ([-3.0, -0.4], [3.0, 0.4]))
        env = m.Environment(room=[
            {"shape": m.Rectangle(width=5.0, height=2.0),
             "position": [-1.5, 0.0]},
            {"shape": m.Rectangle(width=5.0, height=2.0),
             "position": [1.5, 0.0]}])
    for start, goal in routes:
        vehicle = m.Holonomic()
        vehicle.set_initial_conditions(start)
        vehicle.set_terminal_conditions(goal)
        vehicles.append(vehicle)
    fleet = m.Fleet(vehicles)
    if kind == "free_t":
        problem = m.Point2point(fleet, env, freeT=True, options={
            "inter_vehicle_avoidance": True})
    else:
        problem = m.MultiFrameProblem(fleet, env, n_frames=2, options={
            "inter_vehicle_avoidance": True})
    problem.set_options({"verbose": 0, **options})
    return problem


def _transcribe(m, problem):
    """The first step of ``Problem.init``: the transcription alone, without
    the row scales' AD (the JAX package's takes ~20 s op by op for the
    two-vehicle multiframe problem)."""
    problem.children = (list(problem.vehicles) + problem.environment.obstacles
                        + [problem.environment, problem])
    problem.father = m.modeling.opti.OptiFather(problem.children)
    problem.transcription = problem.father.transcribe(problem.construct)
    return problem


def _pair(J, kind="fixed", avoid=True):
    """(JAX problem, port problem), built once a module: initialized, or
    transcribed only for ``multiframe``."""
    key = (kind, avoid)
    if key not in _BUILT:
        out = []
        for m, options in ((J, {}), (T, {"device": "cpu"})):
            problem = _interveh(m, kind, {
                **options, "inter_vehicle_avoidance": avoid})
            if kind == "multiframe":
                out.append(_transcribe(m, problem))
                continue
            problem.init()
            out.append(jax_compiled(problem) if m is J else problem)
        _BUILT[key] = tuple(out)
    return _BUILT[key]


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def _same_layout(jp, tp):
    a, b = jp.transcription, tp.transcription
    assert (a.n_x, a.n_p, a.n_g) == (b.n_x, b.n_p, b.n_g)
    for table in ("variables", "parameters"):
        assert _layout_rows(a.layout, table) == \
            _layout_rows(b.layout, table), table
    assert [(c.offset, c.rows) for c in a.layout.constraints] == \
        [(c.offset, c.rows) for c in b.layout.constraints]
    np.testing.assert_array_equal(b.initial_guess(), a.initial_guess())
    np.testing.assert_array_equal(tp.pack_parameters(0.0),
                                  jp.pack_parameters(0.0))
    for u, v in zip(a.bounds(0.0), b.bounds(0.0)):
        np.testing.assert_array_equal(v, u)


def _plane_names(problem):
    return sorted(name for (_, name) in problem.transcription.layout.variables
                  if name.startswith(("a_", "b_")))


@pytest.mark.parametrize("avoid", [True, False])
def test_layout_matches_jax(J, avoid):
    """n_x 111 with the option (the plane's a and b on the union knots,
    its ||a||^2 <= 1 row and both vehicles' half-space rows), 78 without;
    names, offsets, guess, parameters and bounds as the JAX package's."""
    jp, tp = _pair(J, avoid=avoid)
    assert tp.transcription.n_x == N_X[avoid]
    _same_layout(jp, tp)
    names = _plane_names(tp)
    if avoid:
        v1, v2 = (v.label for v in tp.vehicles)
        assert names == [f"a_{v1}_seg0_0_{v2}_0", f"b_{v1}_seg0_0_{v2}_0"]
    else:
        assert names == []


def test_f_g_and_jacobian_match_jax(J):
    import jax
    import jax.numpy as jnp
    jp, tp = _pair(J)
    a, b = jp.transcription, tp.transcription
    P = jp.pack_parameters(0.0)
    x = a.initial_guess() + 0.1 * np.random.default_rng(0).standard_normal(
        a.n_x)
    xj, pj = jnp.asarray(x), jnp.asarray(P)
    xt, pt = torch.as_tensor(x), torch.as_tensor(P)
    _close(b.objective(xt, pt), a.objective(xj, pj))
    _close(b.constraints(xt, pt), a.constraints(xj, pj))
    _close(torch.func.jacfwd(b.constraints)(xt, pt),
           jax.jacfwd(a.constraints)(xj, pj))
    np.testing.assert_allclose(tp._row_scale, jp._row_scale, rtol=1e-10)


def _start(problem):
    """The first solve's inputs, as the closed loop makes them."""
    problem.initialize(0.0)
    for vehicle in problem.vehicles:
        vehicle.predict(0.0, 0.1, 0.01, enforce_states=True)
    problem.reinitialize()
    lb, ub = problem.transcription.bounds(0.0)
    return (np.array(problem._x_result, np.float64),
            problem.pack_parameters(0.0), np.asarray(lb), np.asarray(ub))


def test_cut_budget_solve_matches_jax(J):
    """Both packages' ALM solvers on the cut budget, from the guess plus a
    seeded 1e-2."""
    import jax
    import jax.numpy as jnp
    from omg_tools_tpu.ops.alm import ALMOptions as JALMOptions
    from omg_tools_tpu.ops.alm import make_alm_solver as j_make_alm_solver
    jp, tp = _pair(J)
    x0, P, lb, ub = _start(tp)
    for u, v in zip((x0, P, lb, ub), _start(jp)):
        np.testing.assert_array_equal(u, v)
    x0 = x0 + START_NOISE * np.random.default_rng(2).standard_normal(x0.shape)
    a, b = jp.transcription, tp.transcription
    js = jax.jit(j_make_alm_solver(
        a.objective, a.constraints, a.n_x, a.lb, a.ub, JALMOptions(**CUT),
        row_scale=jp._row_scale, obj_scale=jp._obj_scale))
    ts = make_alm_solver(b.objective, b.constraints, b.n_x, b.lb, b.ub,
                         T.ALMOptions(**CUT), row_scale=tp._row_scale,
                         obj_scale=tp._obj_scale,
                         fg=b.objective_and_constraints)

    def solve_j(x):
        st = js(jnp.asarray(x), jnp.asarray(P), jnp.asarray(lb),
                jnp.asarray(ub))
        return np.asarray(st.x), float(st.feas)
    want, feas = solve_j(x0)
    rng = np.random.default_rng(3)
    spread = max(float(np.abs(solve_j(
        x0 * (1 + PERTURB * rng.standard_normal(x0.shape)))[0]
        - want).max()) for _ in range(DRAWS))
    st = ts(torch.as_tensor(x0)[None], torch.as_tensor(P)[None], lb, ub)
    err = float(np.abs(st.x[0].numpy() - want).max())
    tol = max(SPREAD_FACTOR * spread, ROUNDING_FLOOR)
    assert np.isfinite(st.x.numpy()).all()
    assert err <= tol, (err, spread)
    assert float(st.feas[0]) == pytest.approx(feas, rel=1e-6, abs=tol)


def test_free_time_point2point_matches_jax(J):
    """FreeTPoint2point with the option: the plane's variables and rows
    follow each vehicle's collision rows, before the objective and T's
    bound, as in the JAX package."""
    jp, tp = _pair(J, "free_t")
    assert type(tp).__name__ == type(jp).__name__ == "FreeTPoint2point"
    _same_layout(jp, tp)
    v1, v2 = (v.label for v in tp.vehicles)
    assert _plane_names(tp) == [f"a_{v1}_seg0_0_{v2}_0",
                                f"b_{v1}_seg0_0_{v2}_0"]


def test_two_vehicle_multiframe_problem_matches_jax(J):
    """Two vehicles in the two-room MultiFrameProblem with the option: a
    plane a segment between them, as in the JAX package (transcribed)."""
    jp, tp = _pair(J, "multiframe")
    _same_layout(jp, tp)
    v1, v2 = (v.label for v in tp.vehicles)
    assert _plane_names(tp) == sorted(
        f"{ab}_{v1}_seg{s}_0_{v2}_0" for ab in "ab" for s in (0, 1))

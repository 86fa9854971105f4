"""The port's vehicle models (omg_tools_torch/models) held to the JAX
package's, in float64 on the CPU.

Each vehicle builds a point-to-point problem in both packages: the scenes
of tests/test_vehicles.py where it has one (Holonomic1D, Quadrotor,
Holonomic3D, HolonomicOrient), a 5 m cube with a sphere for Quadrotor3D
(its default substitution) and bench.py's p2p_dubins scene without the
substitution lift for the exact-integral Dubins transcription.
SimpleQuadrotor3D and the lifted Dubins are bench.py's own scenes, held to
the JAX package in tests/test_torch_p2p_3dquadrotor.py and
tests/test_torch_p2p_dubins.py.

Tolerances: the layouts equal; f and g at a seeded x and p to rtol 1e-12;
the rollout recipes (batch_params, init_guess, reset_guess, update) to
1e-12; the cold solves of tests/test_vehicles.py meet that file's own
criteria, and over their first 10 Newton iterations (one outer round)
agree with the JAX package's to 1e-8 in x.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import omg_tools_torch as T
from omg_tools_torch.ops.alm import make_alm_solver
from omg_tools_torch.problems.rollout_models import make_rollout_model
from torch_bench_configs import _layout_rows

FIRST_ITERS = dict(outer_iter=1, inner_iter=10)
TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These eager solves are small: torch's intra-op threads only spin
    beside the other test processes.  One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _holonomic1d(m):
    veh = m.Holonomic1D()
    veh.set_initial_conditions([-1.5])
    veh.set_terminal_conditions([2.0])
    return veh, m.Environment(room={"shape": m.Rectangle(5.0, 0.5)})


def _quadrotor(m):
    veh = m.Quadrotor(0.2)
    veh.define_knots(knot_intervals=6)
    veh.set_initial_conditions([-2.0, -2.0])
    veh.set_terminal_conditions([2.0, 2.0])
    env = m.Environment(room={"shape": m.Square(5.0)})
    env.add_obstacle(m.Obstacle({"position": [0.0, -0.4]},
                                shape=m.Circle(0.4)))
    return veh, env


def _holonomic3d(m):
    veh = m.Holonomic3D()
    veh.define_knots(knot_intervals=6)
    veh.set_initial_conditions([-1.5, -1.5, -1.5])
    veh.set_terminal_conditions([1.5, 1.5, 1.5])
    env = m.Environment(room={"shape": m.Cube(5.0)})
    env.add_obstacle(m.Obstacle({"position": [0.0, 0.0, 0.0]},
                                shape=m.Sphere(0.5)))
    return veh, env


def _holonomic_orient(m):
    veh = m.HolonomicOrient()
    veh.set_initial_conditions([-1.5, -1.5, 0.0])
    veh.set_terminal_conditions([2.0, 2.0, np.pi / 4])
    env = m.Environment(room={"shape": m.Square(5.0)})
    env.add_obstacle(m.Obstacle({"position": [0.5, 0.0]},
                                shape=m.Circle(0.3)))
    return veh, env


def _quadrotor3d(m):
    veh = m.Quadrotor3D()
    veh.set_initial_conditions([-1.5, -1.5, -1.5])
    veh.set_terminal_conditions([1.5, 1.5, 1.5])
    env = m.Environment(room={"shape": m.Cube(5.0)})
    env.add_obstacle(m.Obstacle({"position": [0.0, 0.0, 0.0]},
                                shape=m.Sphere(0.5)))
    return veh, env


def _dubins_exact(m):
    veh = m.Dubins(shapes=m.Circle(0.1),
                   bounds={"vmax": 0.7, "wmax": np.pi / 3.0,
                           "wmin": -np.pi / 3.0})
    veh.set_initial_conditions([-1.5, -1.5, 0.0])
    veh.set_terminal_conditions([2.0, 2.0, 0.0])
    env = m.Environment(room={"shape": m.Square(5.0)})
    env.add_obstacle(m.Obstacle({"position": [0.5, 0.2]},
                                shape=m.Circle(0.4)))
    return veh, env


CASES = {"holonomic1d": _holonomic1d, "quadrotor": _quadrotor,
         "holonomic3d": _holonomic3d, "holonomic_orient": _holonomic_orient,
         "quadrotor3d": _quadrotor3d, "dubins_exact": _dubins_exact}
# the recipe make_rollout_model picks (None: it raises, in both packages)
RECIPES = {"holonomic1d": "HolonomicRollout", "quadrotor": "QuadrotorRollout",
           "holonomic3d": "HolonomicRollout",
           "holonomic_orient": "HolonomicOrientRollout",
           "quadrotor3d": None, "dubins_exact": "DubinsRollout"}
_BUILT = {}


def _problems(case):
    """(JAX problem, port problem) of a case, built once per module."""
    if case not in _BUILT:
        import omg_tools_tpu as J
        out = []
        for m, options in ((J, {}), (T, {"device": "cpu"})):
            veh, env = CASES[case](m)
            problem = m.Point2point(veh, env, freeT=False)
            problem.set_options({"verbose": 0, **options})
            problem.init()
            out.append(problem)
        _BUILT[case] = tuple(out)
    return _BUILT[case]


@pytest.mark.parametrize("case", list(CASES))
def test_transcription_matches_jax(case):
    """The layout, and f, g and the bounds at a seeded x and p."""
    import jax.numpy as jnp
    jp, tp = _problems(case)
    a, b = jp.transcription, tp.transcription
    assert (a.n_x, a.n_p, a.n_g) == (b.n_x, b.n_p, b.n_g)
    for table in ("variables", "parameters"):
        assert _layout_rows(a.layout, table) == \
            _layout_rows(b.layout, table), table
    assert [(c.offset, c.rows) for c in a.layout.constraints] == \
        [(c.offset, c.rows) for c in b.layout.constraints]
    np.testing.assert_array_equal(b.initial_guess(), a.initial_guess())
    rng = np.random.default_rng(0)
    x = rng.standard_normal(a.n_x) * 0.3
    p = jp.pack_parameters(0.0) + rng.standard_normal(a.n_p) * 0.05
    np.testing.assert_array_equal(tp.pack_parameters(0.0),
                                  jp.pack_parameters(0.0))
    want = np.asarray(a.constraints(jnp.asarray(x), jnp.asarray(p)))
    got = b.constraints(torch.as_tensor(x), torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(
        float(b.objective(torch.as_tensor(x), torch.as_tensor(p))),
        float(a.objective(jnp.asarray(x), jnp.asarray(p))), rtol=1e-12)
    for u, v in zip(a.bounds(0.0), b.bounds(0.0)):
        np.testing.assert_array_equal(v, u)
    np.testing.assert_allclose(tp._row_scale, jp._row_scale, rtol=1e-10)


def _start(problem):
    """The cold solve's inputs as tests/test_vehicles.py makes them."""
    vehicle = problem.vehicles[0]
    problem.initialize(0.0)
    vehicle.predict(0.0, 0.1, 0.01, enforce_states=True)
    problem.reinitialize()
    lb, ub = problem.transcription.bounds(0.0)
    return (np.array(problem._x_result, np.float64),
            problem.pack_parameters(0.0), np.asarray(lb), np.asarray(ub))


# tests/test_vehicles.py's criteria on the solved trajectory
def _check_holonomic1d(vehicle, S):
    np.testing.assert_allclose(S[0, -1], 2.0, atol=5e-2)


def _check_quadrotor(vehicle, S):
    np.testing.assert_allclose(S[:2, -1], [2.0, 2.0], atol=5e-2)
    u1 = vehicle.trajectories["input"][0]
    assert u1.min() > 1.9 and u1.max() < 15.2


def _check_holonomic3d(vehicle, S):
    assert np.linalg.norm(S, axis=0).min() > 0.58
    np.testing.assert_allclose(S[2, -1], 1.5, atol=0.1)


@pytest.mark.parametrize("case,criteria", [
    ("holonomic1d", _check_holonomic1d), ("quadrotor", _check_quadrotor),
    ("holonomic3d", _check_holonomic3d)])
def test_cold_solve(case, criteria):
    """tests/test_vehicles.py's cold solve of the case by the port, under
    ``exploit_structure`` (the dense quadratic ALM where the transcription
    is quadratic, as Holonomic1D's and Holonomic3D's are; the generic
    mode's full budget takes ~90 s on a CPU; the planar Quadrotor's
    is not, and takes the generic mode): feasible to 1e-5 and that file's
    own criteria on the stored trajectory; and the default generic mode's
    first 10 Newton iterations against the JAX package's from the same
    start: x within 1e-8."""
    import jax
    import jax.numpy as jnp
    from omg_tools_tpu.ops.alm import ALMOptions as JALMOptions
    from omg_tools_tpu.ops.alm import make_alm_solver as j_make_alm_solver
    jp, tp = _problems(case)
    x0, P, lb, ub = _start(tp)
    jx0, jP, _, _ = _start(jp)
    np.testing.assert_array_equal(x0, jx0)
    np.testing.assert_array_equal(P, jP)
    veh, env = CASES[case](T)
    tq = T.Point2point(veh, env, freeT=False)
    tq.set_options({"verbose": 0, "device": "cpu",
                    "exploit_structure": True})
    tq.init()
    assert tq._structure == ("generic" if case == "quadrotor"
                             else "quadratic")
    xq, Pq, lbq, ubq = _start(tq)
    np.testing.assert_array_equal(xq, x0)
    st = tq._solver(torch.as_tensor(xq)[None], torch.as_tensor(Pq)[None],
                    lbq, ubq)
    assert float(st.feas[0]) < 1e-5
    tq._x_result = st.x[0].numpy()
    tq.store(0.0, 0.1, 0.01)
    criteria(veh, veh.trajectories["state"])
    ta, ja = tp.transcription, jp.transcription
    ts = make_alm_solver(ta.objective, ta.constraints, ta.n_x, ta.lb, ta.ub,
                         T.ALMOptions(**FIRST_ITERS),
                         row_scale=tp._row_scale, obj_scale=tp._obj_scale)
    # the JAX functions compiled: traced once, not replayed op by op in
    # every trace of the solver's loops
    js = j_make_alm_solver(jax.jit(ja.objective), jax.jit(ja.constraints),
                           ja.n_x, ja.lb, ja.ub, JALMOptions(**FIRST_ITERS),
                           row_scale=jp._row_scale, obj_scale=jp._obj_scale)
    got = ts(torch.as_tensor(x0)[None], torch.as_tensor(P)[None], lb, ub)
    want = js(jnp.asarray(x0), jnp.asarray(P), jnp.asarray(lb),
              jnp.asarray(ub))
    np.testing.assert_allclose(got.x[0].numpy(), np.asarray(want.x), rtol=0,
                               atol=TOL)
    assert float(got.feas[0]) == pytest.approx(float(want.feas), rel=1e-9)


def _recipe_runner(problem, dtype):
    """The few runner attributes a rollout recipe reads."""
    return SimpleNamespace(
        vehicle=problem.vehicles[0], tr=problem.transcription,
        steps_per_knot=int(round(problem.knot_time / 0.1)), update_time=0.1,
        horizon=problem.options["horizon_time"], dtype=dtype, device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_rollout_recipe_dispatch(case):
    """make_rollout_model picks the JAX package's recipe, or raises as it
    does (Quadrotor3D has no batched recipe in either package)."""
    import jax.numpy as jnp
    from omg_tools_tpu.problems.rollout_models import \
        make_rollout_model as j_make
    jp, tp = _problems(case)
    want = RECIPES[case]
    if want is None:
        with pytest.raises(NotImplementedError):
            j_make(_recipe_runner(jp, jnp.float64))
        with pytest.raises(NotImplementedError, match="rollout recipe"):
            make_rollout_model(_recipe_runner(tp, torch.float64))
        return
    assert type(j_make(_recipe_runner(jp, jnp.float64))).__name__ == want
    assert type(make_rollout_model(
        _recipe_runner(tp, torch.float64))).__name__ == want


@pytest.mark.parametrize("case", ["quadrotor", "holonomic_orient",
                                  "holonomic3d"])
def test_rollout_recipe_matches_jax(case):
    """A recipe on seeded inputs (4 lanes): batch_params and init_guess
    from starts and goals, reset_guess, and the plant update at three
    sample instants, to 1e-12."""
    import jax
    import jax.numpy as jnp
    from omg_tools_tpu.problems.rollout_models import \
        make_rollout_model as j_make
    jp, tp = _problems(case)
    mj = j_make(_recipe_runner(jp, jnp.float64))
    mt = make_rollout_model(_recipe_runner(tp, torch.float64))
    rng = np.random.default_rng(2)
    n_spl = tp.vehicles[0].n_spl
    n_coef = len(tp.vehicles[0].basis)
    dim = n_spl if case != "holonomic_orient" else 3
    starts, goals = rng.standard_normal((2, 4, dim))
    p0 = np.tile(tp.pack_parameters(0.0), (4, 1))
    np.testing.assert_allclose(mt.batch_params(p0.copy(), starts, goals),
                               mj.batch_params(p0.copy(), starts, goals),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(mt.init_guess(starts, goals, n_coef),
                               mj.init_guess(starts, goals, n_coef),
                               rtol=1e-12, atol=1e-12)
    gdim = len(mt.i_goal)
    state, goal = rng.standard_normal((2, 4, gdim))
    if gdim == n_spl:
        got = mt.reset_guess(torch.as_tensor(state), torch.as_tensor(goal),
                             n_coef, torch.float64).numpy()
        want = jax.vmap(lambda s, g: mj.reset_guess(s, g, n_coef,
                                                    jnp.float64))(
            jnp.asarray(state), jnp.asarray(goal))
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12,
                                   atol=1e-12)
    p = p0 + 0.1 * rng.standard_normal(p0.shape)
    cfs = rng.standard_normal((4, n_coef, n_spl))
    horizon = tp.options["horizon_time"]
    for row in (1, 4, mt.taus.size - 1):
        gp, gs = mt.update(torch.as_tensor(p), torch.as_tensor(cfs), row,
                           horizon)
        wp, ws = jax.vmap(lambda a, c: mj.update(a, c, row, horizon))(
            jnp.asarray(p), jnp.asarray(cfs))
        np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-12,
                                   atol=1e-12)


def test_free_time_problems_are_not_ported():
    """The free-time problem is ported now (tests/test_torch_free_time.py
    holds it to the JAX package): the factory gives the JAX package's
    class, with the motion time a variable, where it used to raise."""
    import omg_tools_tpu as J
    problems = []
    for m in (J, T):
        veh, env = _dubins_exact(m)
        problems.append(m.Point2point(veh, env, freeT=True))
    assert [type(p).__name__ for p in problems] == ["FreeTPoint2point"] * 2
    assert isinstance(problems[1], T.FreeTPoint2point)

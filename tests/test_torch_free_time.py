"""The free-time and free-end point-to-point problems and the Bicycle, AGV
and Trailer vehicles of the port held to the JAX package, in float64 on
the CPU.  This module runs the checks on the p2p_dubins and p2p_bicycle
scenes and a free end; tests/test_torch_free_time_vehicles.py (AGV,
Trailer) and tests/test_torch_free_time_warehouse.py take the same
checks with ``from test_torch_free_time import *`` and pick their scenes
with the fixtures ``case`` (every check), ``free_t_case`` (the free-time
re-basing), ``stored_case`` (storage and simulation) and
``dispatch_case`` (the rollout recipe): the scenes are split over three
modules so that their JAX compiles (~1-3 min a scene) run in parallel.
The ``gpu`` tests hold K1 in float64 at the new closed loops' shapes to
its plain version, and a free-time problem's captured Newton step to its
eager one.

Scenes: the examples' p2p_dubins and p2p_bicycle (``chip_smoke.build_scene``),
tests/test_vehicles.py's AGV and Trailer, the examples'
p2p_holonomic_warehouse (free time, n_x 395: held on the CPU only; on
the card its Newton system takes K1's global variant) and a FreeEndPoint2point
with the terminal y free.

Tolerances: the layouts, parameters, guesses and bounds equal; f, g and J
at the initial guess and at a seeded perturbation of it to 1e-12
relative; the free-time re-basing (``init_step``) to 1e-12; trajectory
storage and plant simulation from the same solution to 1e-12.  A
cut-budget solve (2 outer x 8 inner iterations) from the guess plus a
seeded 1e-2 (straight-line guesses put rows on their bounds, where a cold
solve amplifies rounding without bound) is held to the JAX package's own
sensitivity: 4x the largest move of its solve over 10 draws of a 1e-15
relative perturbation of that start.  A second implementation rounds
differently in every operation, not only at the start: on the Dubins
scene the port lands 5.7e-8 from the JAX solve, where 30 draws move it
by 6.9e-10 to 4.4e-8 (the factor is tests/test_torch_fleet.py's for the
same reason).

The JAX package is imported inside fixtures and tests, so that the
``gpu`` tests run where JAX is not installed.
"""

import numpy as np
import pytest
import torch

import omg_tools_torch as T
from omg_tools_torch.ops import psd_kernels as pk
from omg_tools_torch.ops.alm import make_alm_solver
from omg_tools_torch.problems.rollout_models import make_rollout_model
from torch_bench_configs import (_layout_rows, jax_compiled,  # noqa: F401
                                 one_torch_thread)
import chip_smoke

__all__ = ["J", "one_torch_thread", "test_transcription_matches_jax",
           "test_init_step_rebasing_matches_jax",
           "test_cut_budget_solve_matches_jax",
           "test_store_and_simulate_match_jax",
           "test_rollout_recipe_dispatch_matches_jax"]

RTOL = 1e-12
CUT = dict(outer_iter=2, inner_iter=8)
START_NOISE = 1e-2
DRAWS = 10
PERTURB = 1e-15
SPREAD_FACTOR = 4.0
# two implementations that sum in another order differ by rounding even
# where a 1e-15 move of the start moves the JAX solve by less
ROUNDING_FLOOR = 1e-10


def _agv(m):
    veh = m.AGV(length=0.4)
    veh.define_knots(knot_intervals=5)
    veh.set_initial_conditions([0.0, 0.0, 0.0, 0.0])
    veh.set_terminal_conditions([3.0, 3.0, 0.0])
    env = m.Environment(room={"shape": m.Square(5.0), "position": [1.5, 1.5]})
    return m.Point2point(veh, env, freeT=True)


def _trailer(m):
    lead = m.Dubins(m.Circle(0.2), bounds={"vmax": 0.7, "wmax": np.pi / 3,
                                           "wmin": -np.pi / 3})
    lead.set_initial_conditions([0.0, 0.0, 0.0])
    lead.set_terminal_conditions([2.5, 2.5, 0.0])
    veh = m.Trailer(lead_veh=lead, shapes=m.Circle(0.2), l_hitch=0.4)
    veh.define_knots(knot_intervals=5)
    veh.set_initial_conditions([0.0])
    veh.set_terminal_conditions([0.0])
    env = m.Environment(room={"shape": m.Square(5.0), "position": [1.5, 1.5]})
    return m.Point2point(veh, env, freeT=True)


def _warehouse(m):
    veh = m.Holonomic(options={"syslimit": "norm_2", "safety_distance": 0.1})
    veh.define_knots(knot_intervals=10)
    veh.set_initial_conditions([0.0, 0.0])
    veh.set_terminal_conditions([6.0, 3.5])
    env = m.Environment(room={"shape": m.Rectangle(width=7.0, height=4.5),
                              "position": [3.0, 1.75]})
    rack = m.Rectangle(width=1.0, height=1.0)
    for pos in ([1., 1.], [3., 1.], [5., 1.], [1., 2.5], [3., 2.5],
                [5., 2.5]):
        env.add_obstacle(m.Obstacle({"position": pos}, shape=rack))
    for pos, vy in (([4.0, 2.5], -0.1), ([2.0, 1.0], 0.15)):
        env.add_obstacle(m.Obstacle(
            {"position": pos}, shape=m.Circle(0.5),
            simulation={"trajectories": {"velocity": {
                "time": [0, 2], "values": [[0., 0.], [0., vy]]}}}))
    return m.Point2point(veh, env, freeT=True)


def _free_end(m):
    veh = m.Holonomic()
    veh.set_initial_conditions([-1.5, -1.5])
    veh.set_terminal_conditions([2.0, 2.0])
    env = m.Environment(room={"shape": m.Square(5.0)})
    env.add_obstacle(m.Obstacle({"position": [0.5, 0.2]},
                                shape=m.Circle(0.4)))
    # the terminal y is a variable: only x is pinned (softly) to 2.0
    return m.FreeEndPoint2point(veh, env, {}, free_ind={veh: [1]})


CASES = {"dubins": lambda m: chip_smoke.build_scene(m, "p2p_dubins"),
         "bicycle": lambda m: chip_smoke.build_scene(m, "p2p_bicycle"),
         "agv": _agv, "trailer": _trailer, "warehouse": _warehouse,
         "free_end": _free_end}
FREE_T = ["dubins", "bicycle", "agv", "trailer", "warehouse"]
_BUILT = {}


@pytest.fixture(scope="module")
def J():
    """The JAX package (float64)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    return pytest.importorskip("omg_tools_tpu")


def _problems(J, case):
    """(JAX problem, port problem) of a case, built once per module."""
    if case not in _BUILT:
        out = []
        for m, options in ((J, {}), (T, {"device": "cpu"})):
            problem = CASES[case](m)
            problem.set_options({"verbose": 0, **options})
            problem.init()
            out.append(jax_compiled(problem) if m is J else problem)
        _BUILT[case] = tuple(out)
    return _BUILT[case]


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def _start(problem):
    """The solve's inputs as the closed loop makes them at time 0."""
    vehicle = problem.vehicles[0]
    problem.initialize(0.0)
    vehicle.predict(0.0, 0.1, 0.01, enforce_states=True)
    problem.reinitialize()
    lb, ub = problem.transcription.bounds(0.0)
    return (np.array(problem._x_result, np.float64),
            problem.pack_parameters(0.0), np.asarray(lb), np.asarray(ub))


def test_transcription_matches_jax(J, case):
    """The layout, parameters, guess and bounds; f, g and J at the
    initial guess and at a seeded perturbation; the row scales."""
    import jax
    import jax.numpy as jnp
    jp, tp = _problems(J, case)
    a, b = jp.transcription, tp.transcription
    assert (a.n_x, a.n_p, a.n_g) == (b.n_x, b.n_p, b.n_g)
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
    jac_j = jax.jit(jax.jacfwd(a.constraints))
    for x in (x_init, x_init + 0.1 * rng.standard_normal(a.n_x)):
        xj, pj = jnp.asarray(x), jnp.asarray(P)
        xt, pt = torch.as_tensor(x), torch.as_tensor(P)
        _close(b.constraints(xt, pt), a.constraints(xj, pj))
        _close(b.objective(xt, pt), a.objective(xj, pj))
        _close(torch.func.jacfwd(b.constraints)(xt, pt), jac_j(xj, pj))
    np.testing.assert_allclose(tp._row_scale, jp._row_scale, rtol=1e-10)
    if case in FREE_T:
        assert type(tp).__name__ == type(jp).__name__ == "FreeTPoint2point"


@pytest.mark.parametrize("T_value", [7.3, 0.15])
def test_init_step_rebasing_matches_jax(J, free_t_case, T_value):
    """FreeTPoint2point.init_step on the same seeded iterate: the splines
    re-based on the remaining piece of the motion (``shift_spline_T``) and
    T set to what is left; a motion time below twice the update time takes
    the other branch."""
    jp, tp = _problems(J, free_t_case)
    rng = np.random.default_rng(1)
    x = tp.transcription.initial_guess() + rng.standard_normal(
        tp.transcription.n_x)
    for problem in (jp, tp):
        problem._x_result = x.copy()
        problem.set_variables(np.array([T_value]), problem, "T")
        problem.start_time = 0.0
        problem.init_step(0.1, 0.1)
    _close(tp._x_result, jp._x_result)
    assert tp._shifted and jp._shifted
    left = T_value - 0.1 if T_value >= 0.2 else T_value
    assert float(tp.get_variables(tp, "T")[0]) == pytest.approx(left)
    # no re-basing at the start of the motion
    tp._x_result = x.copy()
    tp.init_step(0.0, 0.1)
    np.testing.assert_array_equal(tp._x_result, x)


def _solve_pair(J, case):
    import jax
    import jax.numpy as jnp
    from omg_tools_tpu.ops.alm import ALMOptions as JALMOptions
    from omg_tools_tpu.ops.alm import make_alm_solver as j_make_alm_solver
    jp, tp = _problems(J, case)
    x0, P, lb, ub = _start(tp)
    jx0, jP, jlb, jub = _start(jp)
    np.testing.assert_array_equal(x0, jx0)
    np.testing.assert_array_equal(P, jP)
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
    return st, want, feas, spread


def test_cut_budget_solve_matches_jax(J, case):
    st, want, feas, spread = _solve_pair(J, case)
    err = float(np.abs(st.x[0].numpy() - want).max())
    assert np.isfinite(st.x.numpy()).all()
    tol = max(SPREAD_FACTOR * spread, ROUNDING_FLOOR)
    assert err <= tol, (err, spread)
    assert float(st.feas[0]) == pytest.approx(feas, rel=1e-6, abs=tol)


def test_store_and_simulate_match_jax(J, stored_case):
    """From one solution: the stored trajectories (over the free motion
    time) and one simulated period of the plant, to 1e-12."""
    jp, tp = _problems(J, stored_case)
    x0, *_ = _start(tp)
    _start(jp)
    rng = np.random.default_rng(4)
    x = x0 + 0.01 * rng.standard_normal(x0.shape)
    for problem in (jp, tp):
        problem._x_result = x.copy()
        problem.set_variables(np.array([6.0]), problem, "T")
        problem.store(0.0, 0.1, 0.01)
        problem.simulate(0.0, 0.1, 0.01)
    vj, vt = jp.vehicles[0], tp.vehicles[0]
    for key in ("state", "input", "pose"):
        _close(vt.trajectories[key], vj.trajectories[key])
        _close(vt.signals[key], vj.signals[key])
    assert tp.compute_objective() == pytest.approx(jp.compute_objective())
    assert tp.stop_criterium(0.1, 0.1) == jp.stop_criterium(0.1, 0.1)


# the recipe make_rollout_model picks by the vehicle's parameters (None:
# it raises, in both packages)
RECIPES = {"dubins": "DubinsRollout", "bicycle": "DubinsRollout",
           "agv": "DubinsRollout", "trailer": None,
           "warehouse": "HolonomicRollout", "free_end": "HolonomicRollout"}


def test_rollout_recipe_dispatch_matches_jax(J, dispatch_case):
    """make_rollout_model picks the JAX package's recipe by the vehicle's
    parameters: the Bicycle and the AGV carry the Dubins half-angle
    parameters and get its recipe in both packages; the Trailer has none
    and raises in both."""
    import jax.numpy as jnp
    from types import SimpleNamespace
    from omg_tools_tpu.problems.rollout_models import \
        make_rollout_model as j_make
    jp, tp = _problems(J, dispatch_case)

    def runner(problem, dtype):
        return SimpleNamespace(
            vehicle=problem.vehicles[0], tr=problem.transcription,
            steps_per_knot=20, update_time=0.1, horizon=10.0, dtype=dtype,
            device="cpu")
    want = RECIPES[dispatch_case]
    if want is None:
        with pytest.raises(NotImplementedError):
            j_make(runner(jp, jnp.float64))
        with pytest.raises(NotImplementedError, match="rollout recipe"):
            make_rollout_model(runner(tp, torch.float64))
        return
    assert type(make_rollout_model(runner(tp, torch.float64))).__name__ \
        == type(j_make(runner(jp, jnp.float64))).__name__ == want


# the replay against the eager step: on these scenes (unlike the
# formation template, tests/test_torch_fleet.py) the two differ in their
# last bits, a few units of rounding of the largest entry, on the card;
# the eager step is the same on every stream and with either BLAS
# library, and replays equal each other bit for bit
REPLAY_RTOL = 1e-12


def _replay_matches(eager, replayed):
    for u, v in zip(eager, replayed):
        scale = max(1.0, float(u.abs().max()))
        assert float((u - v).abs().max()) <= REPLAY_RTOL * scale


@pytest.fixture(params=["dubins", "bicycle", "free_end"])
def case(request):
    return request.param


@pytest.fixture(params=["dubins", "bicycle"])
def free_t_case(request):
    return request.param


@pytest.fixture(params=["dubins"])
def stored_case(request):
    return request.param


@pytest.fixture(params=["dubins", "bicycle", "free_end"])
def dispatch_case(request):
    return request.param


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,variant", [(33, "reg64"), (35, "reg64"),
                                       (85, "block")])
def test_cuda_k1_f64_at_the_closed_loop_shapes(cuda_device, n, variant):
    """K1 in float64 at the Newton systems of the new closed loops (one
    system a launch: Bicycle 33, Dubins 35, revolving door 85 rows)
    against its plain version."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((1, n, n))
    H = torch.as_tensor(A @ A.transpose(0, 2, 1) / n + np.eye(n),
                        dtype=torch.float64, device=cuda_device)
    g = torch.as_tensor(rng.standard_normal((1, n)), dtype=torch.float64,
                        device=cuda_device)
    assert pk.variant(n, 1, torch.float64) == variant
    before = pk.psd_solve.launches
    got = pk.psd_solve(H, g)
    want = pk.psd_solve_plain(H, g)
    torch.cuda.synchronize()
    assert pk.psd_solve.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-10 * float(
        want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["p2p_dubins", "p2p_bicycle"])
def test_cuda_captured_free_time_step_equals_eager(cuda_device, scene):
    """A free-time problem's generic Newton step (T a variable, the splines
    as init_step re-bases them) replayed from its CUDA graph: replays equal
    each other bit for bit and the eager step to rounding, at two iterates
    and two parameter vectors (the replay reads its inputs, nothing
    captured as a number), one K1 launch a replay."""
    from omg_tools_torch.ops.alm import CapturedCall
    problem = chip_smoke.build_scene(T, scene, {"device": "cuda"})
    problem.init()
    tr = problem.transcription
    solver = problem._solver
    dev = dict(dtype=torch.float64, device=cuda_device)
    rng = np.random.default_rng(5)
    x = tr.initial_guess() + 1e-2 * rng.standard_normal(tr.n_x)
    problem._x_result = x.copy()
    problem.set_variables(np.array([7.0]), problem, "T")
    problem.start_time = 0.0
    problem.init_step(0.1, 0.1)
    args = (torch.as_tensor(problem._x_result, **dev)[None],
            torch.zeros((1, tr.n_g), **dev),
            torch.full((1,), 10.0, **dev),
            *solver.scale_bounds(tr.lb, tr.ub, torch.float64, cuda_device),
            torch.as_tensor(problem.pack_parameters(0.0), **dev)[None])
    graphed = CapturedCall(solver.generic_step, args)
    for k in range(2):
        eager = solver.generic_step(*args)
        before = pk.psd_solve.launches
        replayed = [a.clone() for a in graphed(*args)]
        again = graphed(*args)
        torch.cuda.synchronize()
        assert pk.psd_solve.launches == before + 2 * graphed.k1_launches \
            == before + 2
        for u, v in zip(replayed, again):
            assert torch.equal(u, v)
        _replay_matches(eager, replayed)
        p = args[-1].clone()
        p[0, 0] += 0.01 * (k + 1)
        args = (eager[0].clone(),) + args[1:-1] + (p,)

"""The port's interior-point backend (``ops/solver.py`` ``make_ip_solver``
and ``Problem(solver="ipm")``) held to the JAX package in float64 on the
CPU.

- tests/test_solver.py's seven NLPs on the same inputs and options: x,
  kkt_err and n_iter (the batched case as one batch of three lanes, where
  the JAX package lifts the solver with ``vmap``); the exposed internals
  (``masks``, ``init_state``, ``step``, ``diagnose``) on HS071.
- ``Problem(solver="ipm")`` on examples/p2p_holonomic_solvertest.py's
  scene, both packages on the same cut budget (8 iterations a solve, and
  tol 1.0, so that the first solve's result is kept as the warm state):
  the cold solve, then the warm solve after a knot passage (a basis shift:
  the slacks and bound duals re-centred, ``reslack``), then a cold solve
  judged at tol 1e-4, which fails and retries from a fresh guess.  On this
  scene the interior-point method does not converge in either package
  (the JAX package's kkt_err after its 60 iterations and the retry:
  105.9; the barrier parameter never leaves 1e-2), and its iterates
  amplify rounding as they go (the two packages' first iterates differ by
  ~1e-10 and by O(1) after ~40 iterations, on a CPU), so the budget is
  cut to 8 iterations, where the two stay within 1e-8.

Tolerances: x to 1e-10 and kkt_err to 1e-10 on the small NLPs (measured
differences <= 3e-14), equal iteration counts; the scene's iterates to
1e-8, its KKT errors to 1e-8 relative.

The JAX package is imported by fixtures, so that the ``gpu`` tests run
where JAX is not installed:

    python -m pytest tests/test_torch_ipm.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

import omg_tools_torch as T
from omg_tools_torch.ops.solver import BIG, IPOptions, make_ip_solver

TOL_X = 1e-10
TOL_SCENE = 1e-8
SCENE_BUDGET = {"max_iter": 8, "tol": 1.0}


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


def _hs071_f(x, p):
    return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]


# tests/test_solver.py's cases: f (None: the shifted sum of squares,
# _sumsq), g in torch and in jax.numpy (``jnp``), n, lb, ub, x0 (B, n),
# p (B, n_p), options
def _cases(jnp):
    return {
        "qp_inequality": (
            lambda x, p: x @ x,
            (lambda x, p: torch.stack([x[0] + x[1]]),
             lambda x, p: jnp.array([x[0] + x[1]])),
            2, [1.0], [BIG], [[0.0, 0.0]], [[0.0]], {}),
        "qp_equality": (
            lambda x, p: x @ x + p[0] * x[0],
            (lambda x, p: torch.stack([x[0] + x[1]]),
             lambda x, p: jnp.array([x[0] + x[1]])),
            2, [1.0], [1.0], [[0.0, 0.0]], [[0.0]], {}),
        "box_active_upper": (
            lambda x, p: (x[0] - 2.0) ** 2,
            (lambda x, p: x[:1], lambda x, p: jnp.array([x[0]])),
            1, [0.0], [1.0], [[0.5]], [[0.0]], {}),
        "hs071": (
            _hs071_f,
            (lambda x, p: torch.cat([torch.stack([torch.prod(x), x @ x]),
                                     x]),
             lambda x, p: jnp.concatenate([jnp.array([jnp.prod(x), x @ x]),
                                           x])),
            4, [25.0, 40.0, 1, 1, 1, 1], [BIG, 40.0, 5, 5, 5, 5],
            [[1.0, 5.0, 5.0, 1.0]], [[0.0]], {"max_iter": 80, "tol": 1e-6}),
        "vmap_batch": (
            None,
            (lambda x, p: x, lambda x, p: x),
            2, [0.0, 0.0], [BIG, BIG], [[0.5, 0.5]] * 3,
            [[-1.0, 2.0], [3.0, -0.5], [0.2, 0.1]], {}),
        "shutdown_widened_bounds": (
            lambda x, p: (x[0] - 2.0) ** 2,
            (lambda x, p: x[:1], lambda x, p: jnp.array([x[0]])),
            1, [-BIG], [1.0], [[0.0]], [[0.0]], {}),
    }


def _sumsq(m):
    return lambda x, p: m.sum((x - p) ** 2)


def _solvers(J, name):
    import jax.numpy as jnp
    from omg_tools_tpu.ops.solver import IPOptions as JOptions
    from omg_tools_tpu.ops.solver import make_ip_solver as j_make
    f, (g_t, g_j), n, lb, ub, x0, p, opts = _cases(jnp)[name]
    f_t, f_j = (_sumsq(torch), _sumsq(jnp)) if f is None else (f, f)
    lb, ub = np.array(lb), np.array(ub)
    return (make_ip_solver(f_t, g_t, n, lb, ub, IPOptions(**opts)),
            j_make(f_j, g_j, n, lb, ub, JOptions(**opts)),
            lb, ub, np.array(x0), np.array(p))


def _close(a, b, tol, what):
    err = float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
    assert err <= tol, f"{what}: {err} > {tol}"


def _lanes(sj, batched):
    """A JAX IPState as numpy arrays with a leading lane axis."""
    return {k: np.asarray(v) if batched else np.asarray(v)[None]
            for k, v in sj._asdict().items()}


def _jax_solve(js, x0, p, lb, ub):
    """The JAX solver on each lane (``vmap`` over a batch of several)."""
    import jax
    import jax.numpy as jnp
    if x0.shape[0] == 1:
        return _lanes(js(jnp.asarray(x0[0]), jnp.asarray(p[0]),
                         jnp.asarray(lb), jnp.asarray(ub)), False)
    st = jax.vmap(lambda x, c: js(x, c, jnp.asarray(lb), jnp.asarray(ub)))(
        jnp.asarray(x0), jnp.asarray(p))
    return _lanes(st, True)


def _same_result(st, sj, what):
    _close(st.x.numpy(), sj["x"], TOL_X, f"{what} x")
    _close(st.kkt_err.numpy(), sj["kkt_err"], TOL_X, f"{what} kkt_err")
    np.testing.assert_array_equal(st.n_iter.numpy(), sj["n_iter"])


@pytest.mark.parametrize("name", ["qp_inequality", "qp_equality",
                                  "box_active_upper", "hs071", "vmap_batch",
                                  "shutdown_widened_bounds"])
def test_solve_matches_jax(J, name):
    ts, js, lb, ub, x0, p = _solvers(J, name)
    if name == "shutdown_widened_bounds":
        # the same row classification, the bound widened at run time
        lb, ub = np.array([-BIG]), np.array([BIG])
    st = ts(torch.as_tensor(x0), torch.as_tensor(p), lb, ub)
    _same_result(st, _jax_solve(js, x0, p, lb, ub), name)


def test_warm_start_reuse_matches_jax(J):
    """tests/test_solver.py::test_warm_start_reuse: a solve, then a warm
    solve of a moved target from its state on 8 iterations."""
    import jax.numpy as jnp
    from omg_tools_tpu.ops.solver import make_ip_solver as j_make
    lb, ub = np.zeros(2), np.full(2, BIG)
    ts = make_ip_solver(_sumsq(torch), lambda x, p: x, 2, lb, ub)
    js = j_make(_sumsq(jnp), lambda x, p: x, 2, lb, ub)
    x0, p1 = np.full((1, 2), 0.5), np.array([[1.0, 2.0]])
    p2 = p1 + 0.01
    st1 = ts(torch.as_tensor(x0), torch.as_tensor(p1), lb, ub)
    sj1 = js(jnp.asarray(x0[0]), jnp.asarray(p1[0]), jnp.asarray(lb),
             jnp.asarray(ub))
    st2 = ts(st1.x, torch.as_tensor(p2), lb, ub, state0=st1, max_iter=8)
    sj2 = js(sj1.x, jnp.asarray(p2[0]), jnp.asarray(lb), jnp.asarray(ub),
             state0=sj1, max_iter=8)
    _same_result(st2, _lanes(sj2, False), "warm")
    _close(st2.x.numpy(), p2, 1e-3, "target")


def test_internals_match_jax(J):
    """``masks``, ``init_state``, one ``step`` and ``diagnose`` on HS071."""
    import jax.numpy as jnp
    ts, js, lb, ub, x0, p = _solvers(J, "hs071")
    for key in ("eq_rows", "in_rows", "has_lb", "has_ub"):
        np.testing.assert_array_equal(ts.masks[key], js.masks[key])
    xt, pt_ = torch.as_tensor(x0), torch.as_tensor(p)
    xj, pj = jnp.asarray(x0[0]), jnp.asarray(p[0])
    st = ts.init_state(xt, pt_, lb, ub)
    sj = js.init_state(xj, pj, lb, ub)
    for k in range(3):
        for field in st._fields:
            a, b = getattr(st, field)[0].numpy(), np.asarray(
                getattr(sj, field))
            if field != "kkt_err" or k:
                _close(a, b, TOL_X * max(1.0, np.max(np.abs(b))),
                       f"{field} after {k} steps")
        st = ts.step(st, pt_, lb, ub)
        sj = js.step(sj, pj, lb, ub)
    dt = ts.diagnose(st, pt_, lb, ub)
    dj = js.diagnose(sj, pj, lb, ub)
    for key in dj:
        _close(dt[key][0], dj[key], TOL_X * max(1.0, np.max(np.abs(dj[key]))),
               key)


# -- Problem(solver="ipm") ------------------------------------------------------

def _solvertest(m, **options):
    """examples/p2p_holonomic_solvertest.py's scene with the IPM."""
    vehicle = m.Holonomic(options={"safety_distance": 0.1})
    vehicle.set_initial_conditions([-1.5, -1.5])
    vehicle.set_terminal_conditions([2.0, 2.0])
    env = m.Environment(room={"shape": m.Square(5.0)})
    env.add_obstacle(m.Obstacle({"position": [1.7, -0.5]},
                                shape=m.Rectangle(width=3.0, height=0.2)))
    env.add_obstacle(m.Obstacle({"position": [1.5, 0.5]},
                                shape=m.Circle(0.4)))
    problem = m.Point2point(vehicle, env, {
        "verbose": 0, "solver": "ipm",
        "solver_options": dict(SCENE_BUDGET), **options}, freeT=False)
    problem.init()
    problem.initialize(0.0)
    return problem


def _scene_solves(problem):
    """The cold solve, the warm solve after a knot passage (reslack) and a
    cold solve judged at tol 1e-4 (fails, retries): the result and the
    solver stats after each."""
    out = []
    knot = problem.knot_time
    for t, judge_tol, fresh in ((0.0, None, False), (knot, None, False),
                                (knot, 1e-4, True)):
        if judge_tol is not None:
            problem.options["solver_options"]["tol"] = judge_tol
        if fresh:
            problem.reinitialize()
        problem.solve(t, 0.1)
        out.append((np.array(problem._x_result), dict(problem.solver_stats),
                    problem._ip_state is not None))
    return out


@pytest.fixture(scope="module")
def scene_solves(J):
    return (_scene_solves(_solvertest(J)),
            _scene_solves(_solvertest(T, device="cpu")))


def test_problem_ipm_solves_match_jax(scene_solves):
    for k, ((xj, sj, wj), (xt, st, wt)) in enumerate(
            zip(*scene_solves)):
        _close(xt, xj, TOL_SCENE, f"solve {k} x")
        assert abs(st["kkt_err"] - sj["kkt_err"]) <= \
            TOL_SCENE * abs(sj["kkt_err"])
        assert st["iterations"] == sj["iterations"]
        assert wt == wj
        assert "feas" not in st
    # the first two kept their states (tol 1.0); the third failed at 1e-4
    # and its retry from the same fresh guess was not better
    assert [w for *_, w in scene_solves[1]] == [True, True, False]
    assert scene_solves[1][2][1]["kkt_err"] > 100 * 1e-4


def test_problem_ipm_reslack_after_a_shift(monkeypatch):
    """After a basis shift the port's warm solve re-centres the slacks
    (``reslack``), without one it warm-starts the whole state."""
    problem = _solvertest(T, device="cpu")
    calls = []
    solver = problem._solver

    def spy(x0, p, lb, ub, state0=None, reslack=False):
        calls.append((state0 is not None, reslack))
        return solver(x0, p, lb, ub, state0=state0, reslack=reslack,
                      max_iter=1)
    monkeypatch.setattr(problem, "_solver", spy)
    problem.solve(0.0, 0.1)
    problem.solve(0.05, 0.1)
    problem.solve(problem.knot_time, 0.1)
    assert calls == [(False, False), (True, False), (True, True)]
    assert problem._structure == "ipm"


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the solver runs on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qp_equality", "hs071", "vmap_batch"])
def test_cuda_solve_matches_cpu(cuda_device, name):
    """The small NLPs on the card (``eigh`` and ``solve`` by cuSOLVER)
    against the CPU, float64."""
    no_jax = type("NoJax", (), {})    # the jax.numpy cases stay unused
    f, (g_t, _), n, lb, ub, x0, p, opts = _cases(no_jax)[name]
    f = _sumsq(torch) if f is None else f
    solve = make_ip_solver(f, g_t, n, np.array(lb), np.array(ub),
                           IPOptions(**opts))
    f64 = dict(dtype=torch.float64)
    out = [solve(torch.as_tensor(x0, device=d, **f64),
                 torch.as_tensor(p, device=d, **f64), np.array(lb),
                 np.array(ub))
           for d in ("cpu", cuda_device)]
    assert out[1].x.dtype == torch.float64
    assert out[1].x.is_cuda
    _close(out[1].x.cpu().numpy(), out[0].x.numpy(), 1e-9, "x")
    np.testing.assert_array_equal(out[1].n_iter.cpu().numpy(),
                                  out[0].n_iter.numpy())


@pytest.mark.gpu
def test_cuda_problem_solve_matches_cpu(cuda_device):
    """The scene's cold solve on the cut budget on the card against the
    CPU, float64."""
    out = [_scene_solves(_solvertest(T, device=d))[0]
           for d in ("cpu", cuda_device)]
    _close(out[1][0], out[0][0], TOL_SCENE, "x")

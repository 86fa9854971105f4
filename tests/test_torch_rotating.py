"""Rotating obstacles of the port (omg_tools_torch.environment.obstacle)
held to the JAX package on the revolving_door example's scene (a 1.6 x
0.25 m rectangle turning at pi/6 rad/s about the room's center, horizon
10 s: the arcs sweep ~5.24 rad), in float64 on the CPU.

Tolerances: the layouts, parameters and bounds equal; f, g and J at the
initial guess and at a seeded perturbation, and the obstacle's cos, sin
and weight splines, to 1e-12 relative; the simulated orientation and the
theta parameter after it equal; a cut-budget solve (2 outer x 8 inner)
from the guess plus a seeded 1e-2 held to 4x the largest move of the JAX
package's own solve over 10 draws of a 1e-15 start perturbation (as in
tests/test_torch_free_time.py).  The generic mode's derivatives keep the
iterate's dtype (float32 and float64) through the parameter's cosine.

The JAX package is imported inside fixtures, so that the ``gpu`` test runs
where JAX is not installed.
"""

import numpy as np
import pytest
import torch

import omg_tools_torch as T
from omg_tools_torch.ops import psd_kernels as pk
from omg_tools_torch.ops.alm import make_alm_solver
from torch_bench_configs import _layout_rows, one_torch_thread  # noqa: F401
from test_torch_free_time import (CUT, DRAWS, PERTURB, ROUNDING_FLOOR,
                                  SPREAD_FACTOR, START_NOISE, _close,
                                  _replay_matches, _start)
import chip_smoke


@pytest.fixture(scope="module")
def J():
    """The JAX package (float64)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    return pytest.importorskip("omg_tools_tpu")


@pytest.fixture(scope="module")
def pair(J):
    """(JAX problem, port problem) on the revolving door scene."""
    out = []
    for m, options in ((J, {}), (T, {"device": "cpu"})):
        problem = chip_smoke.build_scene(m, "revolving_door", options)
        problem.init()
        out.append(problem)
    return tuple(out)


def test_transcription_matches_jax(J, pair):
    import jax
    import jax.numpy as jnp
    jp, tp = pair
    a, b = jp.transcription, tp.transcription
    assert (a.n_x, a.n_p, a.n_g) == (b.n_x, b.n_p, b.n_g) == (85, 27, 492)
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
    rng = np.random.default_rng(0)
    jac_j = jax.jit(jax.jacfwd(a.constraints))
    x_init = a.initial_guess()
    p_moved = P.copy()
    sl, _ = b.par_slice(tp.environment.obstacles[0], "theta")
    p_moved[sl] = 0.7
    for x, p in ((x_init, P),
                 (x_init + 0.1 * rng.standard_normal(a.n_x), p_moved)):
        xj, pj = jnp.asarray(x), jnp.asarray(p)
        xt, pt = torch.as_tensor(x), torch.as_tensor(p)
        _close(b.constraints(xt, pt), a.constraints(xj, pj))
        # the arcs this replay built
        oj, ot = jp.environment.obstacles[0], tp.environment.obstacles[0]
        for name in ("cos", "sin", "gon_weight"):
            u, v = getattr(oj, name), getattr(ot, name)
            np.testing.assert_array_equal(v.basis.knots, u.basis.knots)
            _close(v.coeffs, u.coeffs)
        _close(b.objective(xt, pt), a.objective(xj, pj))
        _close(torch.func.jacfwd(b.constraints)(xt, pt), jac_j(xj, pj))
    np.testing.assert_allclose(tp._row_scale, jp._row_scale, rtol=1e-10)


def test_orientation_and_theta_follow_the_simulation(J, pair):
    """The plant turns the obstacle at its angular velocity; the next
    parameter vector carries the new theta."""
    jp, tp = pair
    for problem in (jp, tp):
        problem.environment.obstacles[0].simulate(1.3, 0.1)
    oj, ot = jp.environment.obstacles[0], tp.environment.obstacles[0]
    _close(ot.signals["orientation"], oj.signals["orientation"])
    assert ot.signals["orientation"][0, -1] == pytest.approx(
        1.3 * np.pi / 6.0)
    np.testing.assert_array_equal(tp.pack_parameters(0.0),
                                  jp.pack_parameters(0.0))
    assert tp.pack_parameters(0.0)[tp.transcription.par_slice(
        ot, "theta")[0]][0] == pytest.approx(1.3 * np.pi / 6.0)


@pytest.mark.parametrize("freeT", [False, True])
def test_rotating_obstacle_needs_a_horizon_time(J, freeT):
    """Without the ``horizon_time`` option the arcs have no sweep: both
    packages raise the same ValueError at the transcription."""
    for m in (J, T):
        vehicle = m.Holonomic()
        vehicle.set_initial_conditions([-1.8, -1.8])
        vehicle.set_terminal_conditions([2.0, 2.0])
        env = m.Environment(room={"shape": m.Square(5.0)})
        env.add_obstacle(m.Obstacle(
            {"position": [0.0, 0.0], "angular_velocity": 0.3},
            shape=m.Rectangle(width=1.6, height=0.25)))
        problem = m.Point2point(vehicle, env, freeT=freeT)
        problem.set_options({"verbose": 0})
        with pytest.raises(ValueError, match="horizon_time"):
            problem.init()


def test_cut_budget_solve_matches_jax(J, pair):
    import jax
    import jax.numpy as jnp
    from omg_tools_tpu.ops.alm import ALMOptions as JALMOptions
    from omg_tools_tpu.ops.alm import make_alm_solver as j_make_alm_solver
    jp, tp = pair
    x0, P, lb, ub = _start(tp)
    jx0, jP, _, _ = _start(jp)
    np.testing.assert_array_equal(x0, jx0)
    np.testing.assert_array_equal(P, jP)
    x0 = x0 + START_NOISE * np.random.default_rng(2).standard_normal(x0.shape)
    a, b = jp.transcription, tp.transcription
    js = jax.jit(j_make_alm_solver(
        a.objective, a.constraints, a.n_x, a.lb, a.ub, JALMOptions(**CUT),
        row_scale=jp._row_scale, obj_scale=jp._obj_scale))

    def solve_j(x):
        st = js(jnp.asarray(x), jnp.asarray(P), jnp.asarray(lb),
                jnp.asarray(ub))
        return np.asarray(st.x), float(st.feas)
    want, feas = solve_j(x0)
    rng = np.random.default_rng(3)
    spread = max(float(np.abs(solve_j(
        x0 * (1 + PERTURB * rng.standard_normal(x0.shape)))[0]
        - want).max()) for _ in range(DRAWS))
    ts = make_alm_solver(b.objective, b.constraints, b.n_x, b.lb, b.ub,
                         T.ALMOptions(**CUT), row_scale=tp._row_scale,
                         obj_scale=tp._obj_scale,
                         fg=b.objective_and_constraints)
    st = ts(torch.as_tensor(x0)[None], torch.as_tensor(P)[None], lb, ub)
    tol = max(SPREAD_FACTOR * spread, ROUNDING_FLOOR)
    err = float(np.abs(st.x[0].numpy() - want).max())
    assert err <= tol, (err, spread)
    assert float(st.feas[0]) == pytest.approx(feas, rel=1e-6, abs=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_generic_step_keeps_the_iterate_dtype(pair, dtype):
    """theta enters as cos/sin of a 0-dim parameter minus t omega; torch's
    forward mode gives such a float32 value combined with a Python number
    a float64 tangent.  The generic mode's Newton step must stay in the
    iterate's dtype."""
    _, tp = pair
    tr = tp.transcription
    solver = tp._solver
    x = torch.as_tensor(tr.initial_guess(), dtype=dtype)[None]
    p = torch.as_tensor(tp.pack_parameters(0.0), dtype=dtype)[None]
    lb, ub = solver.scale_bounds(tr.lb, tr.ub, dtype, torch.device("cpu"))
    out = solver.generic_step(x, torch.zeros((1, tr.n_g), dtype=dtype),
                              torch.full((1,), 10.0, dtype=dtype), lb, ub, p)
    for a in out:
        if a.is_floating_point():
            assert a.dtype == dtype
    assert bool(torch.isfinite(out[0]).all())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_captured_rotating_step_equals_eager(cuda_device):
    """The revolving door's generic Newton step replayed from its CUDA
    graph while theta moves between the replays (it is read from the
    parameters, nothing captured as a number): replays equal each other
    bit for bit and the eager step to rounding (tests/test_torch_free_time.py
    says why not bit for bit)."""
    from omg_tools_torch.ops.alm import CapturedCall
    problem = chip_smoke.build_scene(T, "revolving_door", {"device": "cuda"})
    problem.init()
    tr = problem.transcription
    solver = problem._solver
    dev = dict(dtype=torch.float64, device=cuda_device)
    x = tr.initial_guess() + 1e-2 * np.random.default_rng(6).standard_normal(
        tr.n_x)
    sl, _ = tr.par_slice(problem.environment.obstacles[0], "theta")
    args = (torch.as_tensor(x, **dev)[None],
            torch.zeros((1, tr.n_g), **dev), torch.full((1,), 10.0, **dev),
            *solver.scale_bounds(tr.lb, tr.ub, torch.float64, cuda_device),
            torch.as_tensor(problem.pack_parameters(0.0), **dev)[None])
    graphed = CapturedCall(solver.generic_step, args)
    for theta in (0.0, 0.9, 2.5):
        p = args[-1].clone()
        p[0, sl.start] = theta
        args = args[:-1] + (p,)
        eager = solver.generic_step(*args)
        before = pk.psd_solve.launches
        replayed = [a.clone() for a in graphed(*args)]
        again = graphed(*args)
        torch.cuda.synchronize()
        assert pk.psd_solve.launches == before + 2
        for u, v in zip(replayed, again):
            assert torch.equal(u, v)
        _replay_matches(eager, replayed)

"""The port's centralized formation (``problems/formation_central.py``)
held to the JAX package in float64 on the CPU, on the scene of
examples/formation_holonomic_central.py and
tests/test_distributed.py::test_formation_central
(``chip_smoke.build_scene(m, "formation_central")``: three Holonomic
vehicles in a 0.2 m triangle, one NLP of n_x 203 whose centre-equality
constraints tie the vehicles' perceived fleet centres).

Tolerances: layouts, parameters, guesses and bounds equal; f, g and J at
the guess and at a seeded perturbation to 1e-12 relative; the soft
formation (slack splines, a bounded deviation) likewise, f and g only.
A solve on a cut budget (1 outer x 8 inner iterations) from the closed
loop's start plus a seeded 1e-2 (the start itself is degenerate: a 1e-15
move of it moves the JAX package's solve by ~1) is held to 4x the
largest move of the JAX package's own solve over 5 draws of a 1e-15
relative perturbation of that start (tests/test_torch_free_time.py's
rule), or 1e-10 where rounding alone separates them, and so is the
spread of its fleet centres (zero on the guess).  On the card (``gpu``):
the captured Newton step of this NLP (K1's block variant) equals the
eager one, and a full-budget solve keeps the centres within 1e-3 m
(tests/test_distributed.py:47-53).
"""

import numpy as np
import pytest
import torch

import omg_tools_torch as T
from omg_tools_torch.ops.alm import make_alm_solver
from torch_bench_configs import _layout_rows, one_torch_thread  # noqa: F401
from test_torch_multiframe import cut_budget
import chip_smoke

RTOL = 1e-12
CUT = {"outer_iter": 1, "inner_iter": 8}
START_NOISE = 1e-2
DRAWS = 5
PERTURB = 1e-15
SPREAD_FACTOR = 4.0
ROUNDING_FLOOR = 1e-10
SPREAD_M = 1e-3
SOFT = {"soft_formation": True, "soft_formation_weight": 10.0,
        "max_formation_deviation": 0.05}
_BUILT = {}


@pytest.fixture(scope="module")
def J():
    """The JAX package (float64)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    return pytest.importorskip("omg_tools_tpu")


def _pair(J, variant):
    """(JAX problem, port problem), initialized, built once per module."""
    if variant not in _BUILT:
        out = []
        with cut_budget(J, T, budget=CUT):
            for m, options in ((J, {}), (T, {"device": "cpu"})):
                problem = chip_smoke.build_scene(
                    m, "formation_central",
                    {**options, **(SOFT if variant == "soft" else {})})
                problem.init()
                out.append(problem)
        _BUILT[variant] = tuple(out)
    return _BUILT[variant]


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("variant", ["hard", "soft"])
def test_transcription_matches_jax(J, variant):
    """The layout (n_x 203 with hard centre equalities; the soft
    formation adds a slack spline a couple), parameters, guess and
    bounds; f and g (and, hard, J) at the guess and at a seeded
    perturbation; the row scales."""
    import jax
    import jax.numpy as jnp
    jp, tp = _pair(J, variant)
    a, b = jp.transcription, tp.transcription
    assert (a.n_x, a.n_p, a.n_g) == (b.n_x, b.n_p, b.n_g)
    if variant == "hard":
        assert b.n_x == 203
    else:
        assert b.n_x > 203
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
    x_init = a.initial_guess()
    jac_j = jax.jit(jax.jacfwd(a.constraints)) if variant == "hard" \
        else None
    for x in (x_init, x_init + 0.1 * rng.standard_normal(a.n_x)):
        xj, pj = jnp.asarray(x), jnp.asarray(P)
        xt, pt = torch.as_tensor(x), torch.as_tensor(P)
        _close(b.constraints(xt, pt), a.constraints(xj, pj))
        _close(b.objective(xt, pt), a.objective(xj, pj))
        if jac_j is not None:
            _close(torch.func.jacfwd(b.constraints)(xt, pt), jac_j(xj, pj))
    np.testing.assert_allclose(tp._row_scale, jp._row_scale, rtol=1e-10)
    assert tp._structure == "generic"


def _start(problem):
    """The solve's inputs as tests/test_distributed.py makes them."""
    problem.initialize(0.0)
    for v in problem.vehicles:
        v.predict(0.0, 0.1, 0.01, enforce_states=True)
    problem.reinitialize()
    lb, ub = problem.transcription.bounds(0.0)
    return (np.array(problem._x_result, np.float64),
            problem.pack_parameters(0.0), np.asarray(lb), np.asarray(ub))


def test_cut_budget_solve_and_centres_match_jax(J):
    """The cut-budget solve against the JAX package's own spread, and the
    fleet centres: they agree exactly on the guess, and the solved
    splines' centres spread as far as the JAX package's (the start's
    noise moves them ~1e-3 m apart, which 8 iterations do not fully
    restore in either package; the converged solves on the card hold them
    to 1e-3 m)."""
    import jax
    import jax.numpy as jnp
    from omg_tools_tpu.ops.alm import ALMOptions as JALMOptions
    from omg_tools_tpu.ops.alm import make_alm_solver as j_make_alm_solver
    jp, tp = _pair(J, "hard")
    x0, P, lb, ub = _start(tp)
    jx0, jP, *_ = _start(jp)
    np.testing.assert_array_equal(x0, jx0)
    np.testing.assert_array_equal(P, jP)
    assert chip_smoke.formation_spread(tp) < RTOL
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
    x = st.x[0].numpy()
    err = float(np.abs(x - want).max())
    tol = max(SPREAD_FACTOR * spread, ROUNDING_FLOOR)
    centres = []
    for problem, xs in ((tp, x), (jp, want)):
        problem._x_result = np.array(xs)
        centres.append(chip_smoke.formation_spread(problem))
    print("formation_central cut solve: port vs JAX", err, "spread",
          spread, "feas", feas, "centre spread", centres)
    assert np.isfinite(x).all()
    assert err <= tol, (err, spread)
    assert float(st.feas[0]) == pytest.approx(feas, rel=1e-6, abs=tol)
    assert centres[0] == pytest.approx(centres[1], abs=tol)


def test_parameters_carry_the_configuration(J):
    """Each vehicle's ``rel_pos_c`` parameter is its offset from the
    fleet centre (the triangle's vertices), in both packages."""
    jp, tp = _pair(J, "hard")
    for problem in (jp, tp):
        params = problem.set_parameters(0.0)
        for v in problem.vehicles:
            np.testing.assert_array_equal(params[v]["rel_pos_c"],
                                          np.asarray(v.rel_pos_c))
    _close(np.stack([v.rel_pos_c for v in tp.vehicles]),
           np.stack([v.rel_pos_c for v in jp.vehicles]))


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


# the replay against the eager step (tests/test_torch_scheduler.py's
# bound): equal to rounding, replays bit for bit
REPLAY_RTOL = 1e-12


@pytest.mark.gpu
def test_cuda_captured_central_step_equals_eager(cuda_device):
    """The central formation's generic Newton step (n_x 203: K1's block
    variant) replayed from a CUDA graph equals the eager step, one K1
    launch a replay."""
    from omg_tools_torch.ops import psd_kernels as pk
    from omg_tools_torch.ops.alm import CapturedCall
    p = chip_smoke.build_scene(T, "formation_central", {"device": "cuda"})
    p.init()
    tr, solver = p.transcription, p._solver
    assert tr.n_x == 203
    assert pk.variant(tr.n_x, 1, torch.float64) == "block"
    dev = dict(dtype=torch.float64, device=cuda_device)
    x = tr.initial_guess() + 1e-2 * np.random.default_rng(5).standard_normal(
        tr.n_x)
    args = (torch.as_tensor(x, **dev)[None],
            torch.zeros((1, tr.n_g), **dev),
            torch.full((1,), 10.0, **dev),
            *solver.scale_bounds(tr.lb, tr.ub, torch.float64, cuda_device),
            torch.as_tensor(p.pack_parameters(0.0), **dev)[None])
    graphed = CapturedCall(solver.generic_step, args)
    eager = solver.generic_step(*args)
    before = pk.psd_solve.launches
    replayed = [t.clone() for t in graphed(*args)]
    again = graphed(*args)
    torch.cuda.synchronize()
    assert graphed.k1_launches == 1
    assert pk.psd_solve.launches == before + 2
    for u, v, w in zip(eager, replayed, again):
        assert torch.equal(v, w)
        scale = max(1.0, float(u.abs().max()))
        assert float((u - v).abs().max()) <= REPLAY_RTOL * scale


@pytest.mark.gpu
def test_cuda_full_solve_keeps_the_centres_together(cuda_device):
    """tests/test_distributed.py::test_formation_central on the card: the
    full-budget solve from the closed loop's start is feasible to 1e-4
    and its fleet centres spread less than 1e-3 m, K1 (global) at every
    Newton step."""
    from omg_tools_torch.ops import psd_kernels as pk
    p = chip_smoke.build_scene(T, "formation_central", {"device": "cuda"})
    p.init()
    x0, P, lb, ub = _start(p)
    before = pk.psd_solve.launches
    st = p._solver(torch.as_tensor(x0, dtype=torch.float64,
                                   device=cuda_device)[None],
                   torch.as_tensor(P, dtype=torch.float64,
                                   device=cuda_device)[None], lb, ub)
    torch.cuda.synchronize()
    assert pk.psd_solve.launches - before >= int(st.n_iter[0])
    assert float(st.feas[0]) < 1e-4
    p._x_result = st.x[0].double().cpu().numpy()
    assert chip_smoke.formation_spread(p) < SPREAD_M

"""The port's closed loop (Problem.solve, Simulator, Deployer) held to the
JAX package's on the bench scene, in float64 on the CPU.

The scene is bench.py's p2p_holonomic (one Holonomic vehicle in a 5 m
room, two 3.0x0.2 m rectangles and a 0.4 m circle, 10 s horizon), built by
both packages.  The JAX problem's dense quadratic solver is made from the
port's detected Q tensor (the two detections agree to 1e-10,
tests/test_torch_main_path.py::test_host_ad_tensors; the JAX package's
eager detection alone takes ~45 s on a CPU), exactly as its ``init`` makes
it under ``exploit_structure``.

Tolerances.  Up to its twelfth Newton iteration the port's cold solve
follows the JAX package's to 1e-12; there an ill-conditioned step (a
separating-hyperplane direction the objective leaves free) amplifies
rounding, so that over the full 320-iteration budget no second
implementation can agree to 1e-8: the JAX package's own solution moves
(in the vehicle's splines, ~1e-6 m) when its start moves by 1e-15
(relative).  So the full-budget solve and the closed loop are held to
1e-8 or, where rounding was amplified, to that sensitivity, measured here;
the solve is held to 1e-8 over its first 11 iterations.

The sensitivity is heavy-tailed: over 8 draws of the 1e-15 perturbation
the JAX solution moved 2.6e-7 to 2.1e-4 with the default threads and
1.3e-9 to 2.1e-4 with OMP_NUM_THREADS=1, and its unperturbed solution
itself moves by ~1e-6 between those two settings, while the port's does
not (its own moves, 8e-8 to 2.1e-6, are the same under both).  The port
landed 5.5e-7 (default) and 1.24e-6 (OMP_NUM_THREADS=1) from the JAX
solution: inside that spread.  One draw is no stable measure of it, so
the bound is 4x the median move over SENS_DRAWS draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omg_tools_tpu as J
from omg_tools_tpu.ops.alm import ALMOptions as JALMOptions
from omg_tools_tpu.ops.alm import make_alm_solver as j_make_alm_solver

import omg_tools_torch as T
from omg_tools_torch.ops.alm import make_alm_solver

N_UPDATES = 3
TOL = 1e-8
SENS_DRAWS = 5
SENS_FACTOR = 4.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These eager solves are small: torch's intra-op threads only spin
    beside the other test processes.  One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(m, options):
    vehicle = m.Holonomic()
    vehicle.set_initial_conditions([-1.5, -1.5])
    vehicle.set_terminal_conditions([2.0, 2.0])
    environment = m.Environment(room={"shape": m.Square(5.0)})
    environment.add_obstacle(m.Obstacle(
        {"position": [-2.1, -0.5]}, shape=m.Rectangle(width=3.0, height=0.2)))
    environment.add_obstacle(m.Obstacle(
        {"position": [1.7, -0.5]}, shape=m.Rectangle(width=3.0, height=0.2)))
    environment.add_obstacle(m.Obstacle(
        {"position": [1.5, 0.5]}, shape=m.Circle(0.4)))
    problem = m.Point2point(vehicle, environment, freeT=False)
    problem.set_options({"verbose": 0, **options})
    problem.init()
    return problem


def _jax_quadratic(pj, Q):
    """The JAX problem's solver as its init makes it under
    ``exploit_structure``, given the detected Q."""
    tr = pj.transcription
    pj._solver = j_make_alm_solver(
        tr.objective, tr.constraints, tr.n_x, tr.lb, tr.ub, JALMOptions(),
        row_scale=pj._row_scale, obj_scale=pj._obj_scale, quadratic_Q=Q)
    pj._jit_solve = jax.jit(lambda x0, p, lb, ub: pj._solver(x0, p, lb, ub))
    pj._jit_resolve = jax.jit(
        lambda x0, p, lb, ub, st: pj._solver(x0, p, lb, ub, state0=st))
    pj._jit_reslack = pj._jit_resolve
    pj._structure = "quadratic"


def _splines(problem, x):
    return problem.get_variables(problem.vehicles[0], "splines_seg0", x)


@pytest.fixture(scope="module")
def quadratic():
    """Both packages' closed loops (exploit_structure, default budgets):
    x and solver stats after each of N_UPDATES Simulator updates, the
    signals after the last, and the JAX cold solve's splines from a start
    perturbed by 1e-15 (relative), SENS_DRAWS draws."""
    tp = _scene(T, {"exploit_structure": True, "device": "cpu"})
    assert tp._structure == "quadratic"
    jp = _scene(J, {})
    _jax_quadratic(jp, tp._Q_raw)
    out = {"problems": (jp, tp)}
    # the JAX cold solve's own sensitivity: the inputs of its first update
    jp.initialize(0.0)
    jp.predict(0.0, 0.1, 0.01)
    x0, P = jp._x_result.copy(), jp.pack_parameters(0.0)
    lb, ub = jp.transcription.bounds(0.0)
    out["inputs"] = (x0, P, np.asarray(lb), np.asarray(ub))
    out["perturbed"] = []
    for seed in range(SENS_DRAWS):
        rng = np.random.default_rng(seed)
        st = jp._jit_solve(jnp.asarray(x0 * (1 + 1e-15 * rng.standard_normal(
            x0.shape))), jnp.asarray(P), lb, ub)
        out["perturbed"].append(_splines(jp, np.asarray(st.x)))
    for name, m, problem in (("jax", J, jp), ("torch", T, tp)):
        sim = m.Simulator(problem)
        xs, stats = [], []
        for _ in range(N_UPDATES):
            sim.update()
            xs.append(problem._x_result.copy())
            stats.append(dict(problem.solver_stats))
        out[name] = {"x": xs, "stats": stats, "signals": {
            k: np.asarray(v, np.float64)
            for k, v in problem.vehicles[0].signals.items()}}
    moves = [float(np.abs(s - _splines(jp, out["jax"]["x"][0])).max())
             for s in out["perturbed"]]
    out["own"] = SENS_FACTOR * float(np.median(moves))
    return out


def test_cold_solve_matches_jax(quadratic):
    """The first update's cold solve (320 iterations): the vehicle's
    splines within 1e-8 or the JAX package's own sensitivity; the same
    iteration count, feasibility and objective to the same bound."""
    jp, tp = quadratic["problems"]
    got, want = quadratic["torch"], quadratic["jax"]
    err = np.abs(_splines(tp, got["x"][0]) - _splines(jp, want["x"][0]))
    assert err.max() <= max(TOL, quadratic["own"]), (err.max(),
                                                    quadratic["own"])
    assert got["stats"][0]["iterations"] == want["stats"][0]["iterations"]
    assert got["stats"][0]["feas"] < 1e-3 and want["stats"][0]["feas"] < 1e-3
    f = [float(p.transcription.objective(xp.asarray(s["x"][0]),
                                         xp.asarray(p.pack_parameters(0.0))))
         for p, s, xp in ((jp, want, jnp), (tp, got, torch))]
    assert abs(f[0] - f[1]) <= max(TOL, quadratic["own"]) * max(1.0,
                                                               abs(f[0]))


def test_cold_solve_matches_jax_before_amplification(quadratic):
    """The same cold solve over its first 11 Newton iterations, through each
    problem's own quadratic solver pieces: x within 1e-8."""
    jp, tp = quadratic["problems"]
    tr_j, tr_t = jp.transcription, tp.transcription
    opt = dict(outer_iter=1, inner_iter=11)
    Q = tp._Q_raw
    js = j_make_alm_solver(tr_j.objective, tr_j.constraints, tr_j.n_x,
                           tr_j.lb, tr_j.ub, JALMOptions(**opt),
                           row_scale=jp._row_scale, obj_scale=jp._obj_scale,
                           quadratic_Q=Q)
    ts = make_alm_solver(tr_t.objective, tr_t.constraints, tr_t.n_x,
                         tr_t.lb, tr_t.ub, T.ALMOptions(**opt),
                         row_scale=tp._row_scale, obj_scale=tp._obj_scale,
                         quadratic_Q=Q)
    x0, P, lb, ub = quadratic["inputs"]
    want = js(jnp.asarray(x0), jnp.asarray(P), jnp.asarray(lb),
              jnp.asarray(ub))
    got = ts(torch.as_tensor(x0)[None], torch.as_tensor(P)[None], lb, ub)
    np.testing.assert_allclose(got.x[0].numpy(), np.asarray(want.x), rtol=0,
                               atol=TOL)
    assert float(got.feas[0]) == pytest.approx(float(want.feas), rel=1e-9)


def test_simulator_updates_match_jax(quadratic):
    """Three Simulator.update() calls: every signal of the vehicle (time,
    state, input, pose) within 1e-8 or the JAX package's own sensitivity.
    (The warm solves' iteration counts may differ: each ends at the first
    outer round below the tolerances, which rounding can move by one.)"""
    got, want = quadratic["torch"], quadratic["jax"]
    bound = max(TOL, quadratic["own"])
    assert set(got["signals"]) == set(want["signals"])
    for key in ("time", "state", "input", "pose"):
        assert got["signals"][key].shape == want["signals"][key].shape
        err = np.abs(got["signals"][key] - want["signals"][key]).max()
        assert err <= bound, (key, err, bound)
    assert all(s["feas"] < 1e-3 for s in got["stats"])


@pytest.fixture(scope="module")
def generic():
    """Both packages' default (generic) mode with a budget of one outer
    round of two Newton steps: one Problem.solve each, recording every call
    of the solver (the first solve, then the retry from a fresh guess,
    since the budget leaves it infeasible)."""
    opts = {"solver_options": {"outer_iter": 1, "inner_iter": 2}}
    jp = _scene(J, opts)
    tp = _scene(T, {**opts, "device": "cpu"})
    assert jp._structure == tp._structure == "generic"
    calls = {"jax": [], "torch": []}

    def record(fn, log):
        def call(*args, **kwargs):
            st = fn(*args, **kwargs)
            log.append((np.array(args[0], np.float64), st))
            return st
        return call
    jp._jit_solve = record(jp._jit_solve, calls["jax"])
    tp._solver = record(tp._solver, calls["torch"])
    for problem in (jp, tp):
        problem.initialize(0.0)
        problem.predict(0.0, 0.1, 0.01)
        problem.solve(0.0, 0.1)
    return jp, tp, calls


def test_generic_mode_solve_matches_jax(generic):
    jp, tp, calls = generic
    assert len(calls["jax"]) == len(calls["torch"]) == 2
    for (xj, sj), (xt, st) in zip(calls["jax"], calls["torch"]):
        np.testing.assert_array_equal(xt[0], xj)
        np.testing.assert_allclose(st.x[0].numpy(), np.asarray(sj.x),
                                   rtol=0, atol=TOL)
    np.testing.assert_allclose(tp._x_result, jp._x_result, rtol=0, atol=TOL)
    for key in ("feas", "kkt_err", "iterations"):
        assert tp.solver_stats[key] == pytest.approx(jp.solver_stats[key],
                                                     rel=1e-9)


def test_failed_solve_retries_from_a_fresh_guess(generic):
    """The failure branch of solve(): an infeasible result (feas > 1e-3)
    re-runs the layout pass and solves once more from the fresh guess; the
    more feasible iterate is kept (here neither is more feasible, so the
    warm start is the fresh guess and no warm state is kept, as in the JAX
    package)."""
    _, tp, calls = generic
    (x_first, st_first), (x_retry, st_retry) = calls["torch"]
    assert float(st_first.feas[0]) > 1e-3
    np.testing.assert_array_equal(x_retry[0],
                                  tp.transcription.initial_guess())
    assert float(st_retry.feas[0]) >= float(st_first.feas[0])
    np.testing.assert_array_equal(tp._x_result,
                                  tp.transcription.initial_guess())
    assert tp._ip_state is None
    assert tp.solver_stats["feas"] == pytest.approx(float(st_first.feas[0]))


def test_failed_solve_keeps_the_more_feasible_retry():
    """A warm start worse than a fresh guess: the retry's iterate is kept,
    its state the next warm start, its stats the solve's."""
    problem = T.Point2point(_vehicle(), _empty_room(), freeT=False)
    problem.set_options({"verbose": 0, "exploit_structure": True,
                         "device": "cpu",
                         "solver_options": {"outer_iter": 2,
                                            "inner_iter": 8}})
    problem.init()
    problem.initialize(0.0)
    problem.predict(0.0, 0.1, 0.01)
    states = []
    solver = problem._solver

    def record(*args, **kwargs):
        states.append(solver(*args, **kwargs))
        return states[-1]
    problem._solver = record
    problem._x_result = problem._x_result + 50.0  # far from feasible
    problem.solve(0.0, 0.1)
    first, retry = states
    assert float(first.feas[0]) > 1e-3
    assert float(retry.feas[0]) < float(first.feas[0])
    assert problem._ip_state is retry
    np.testing.assert_array_equal(problem._x_result, retry.x[0].numpy())
    assert problem.solver_stats["feas"] == float(retry.feas[0])


def _vehicle():
    vehicle = T.Holonomic()
    vehicle.set_options({"ideal_prediction": True})
    vehicle.set_initial_conditions([-1.5, -1.5])
    vehicle.set_terminal_conditions([2.0, 2.0])
    return vehicle


def _empty_room():
    return T.Environment(room={"shape": T.Square(5.0)})


@pytest.fixture
def deployer():
    """tests/test_execution.py's scene (no obstacles, ideal prediction) in
    the port, with a Deployer."""
    vehicle = _vehicle()
    problem = T.Point2point(vehicle, _empty_room(), freeT=False)
    problem.set_options({"verbose": 0, "exploit_structure": True,
                         "device": "cpu"})
    problem.init()
    return vehicle, T.Deployer(problem, sample_time=0.01, update_time=0.1)


def test_deployer_delay_compensation(deployer):
    """A slow solve (the caller's clock 0.05 s past the control period)
    shifts the predict window by the measured delay; an on-time one does
    not (tests/test_execution.py:25-46)."""
    vehicle, dep = deployer
    dep.update(0.0)
    traj = {k: np.asarray(v).copy() for k, v in vehicle.trajectories.items()}
    dep.update(0.15)
    n_samp = 10
    np.testing.assert_allclose(vehicle.prediction["state"],
                               traj["state"][:, n_samp + 5])
    traj = {k: np.asarray(v).copy() for k, v in vehicle.trajectories.items()}
    dep.update(0.25)
    np.testing.assert_allclose(vehicle.prediction["state"],
                               traj["state"][:, n_samp])


def test_deployer_delay_clamped_to_stored_trajectory(deployer):
    """A delay that would overrun the stored trajectory is dropped
    (tests/test_execution.py:49-58)."""
    vehicle, dep = deployer
    dep.update(0.0)
    traj = {k: np.asarray(v).copy() for k, v in vehicle.trajectories.items()}
    horizon_end = float(traj["time"].ravel()[-1])
    dep.update(horizon_end + 0.2)
    np.testing.assert_allclose(vehicle.prediction["state"],
                               traj["state"][:, 10])


def test_problem_default_device_needs_cuda(monkeypatch):
    """The problem's device is CUDA unless its options say otherwise:
    without a card its first solve raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    problem = T.Point2point(_vehicle(), _empty_room(), freeT=False)
    problem.set_options({"verbose": 0})
    problem.init()
    problem.initialize(0.0)
    problem.predict(0.0, 0.1, 0.01)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        problem.solve(0.0, 0.1)


def test_simulator_step_sleep_and_run_once():
    """The Simulator's other entry points on the port (no obstacles): a
    step advances the plant one period, sleep holds the position, run_once
    executes one solve over the whole horizon."""
    vehicle = _vehicle()
    problem = T.Point2point(vehicle, _empty_room(), freeT=False)
    problem.set_options({"verbose": 0, "exploit_structure": True,
                         "device": "cpu"})
    problem.init()
    sim = T.Simulator(problem)
    assert T.PlotLayer.simulator is sim
    problem.initialize(0.0)
    state = sim.step()[vehicle]
    assert sim.current_time == pytest.approx(0.1)
    assert vehicle.signals["state"].shape == (2, 11)
    np.testing.assert_array_equal(state, vehicle.signals["state"][:, -1])
    sim.sleep(0.2)
    assert sim.current_time == pytest.approx(0.3)
    np.testing.assert_allclose(vehicle.signals["state"][:, -21:],
                               np.tile(state[:, None], (1, 21)), atol=1e-12)
    assert sim.time2index(0.3) == 30
    _, signals = sim.run_once()
    S = signals[str(vehicle)]["state"]
    assert np.linalg.norm(S[:, -1] - vehicle.poseT) < 1e-2

"""The torch port's main path held to the JAX package on the bench scene.

The scene is bench.py's p2p_holonomic (one Holonomic vehicle in a 5 m
room, two 3.0x0.2 m rectangles and a 0.4 m circle, 10 s horizon at
10 Hz), built by both packages in float64 on the CPU.  A float64 JAX runner
takes the compact-arrow structure by itself, which is the structure the
port runs.  The JAX runner computes its host tensors into a private cache
directory, so that a cache written by a float32 run elsewhere cannot round
them.

Tolerances: the transcription is the same arithmetic, so f and g agree to
rtol 1e-12; the host AD results (row scales, Q, the affine tensors, the
compact tensors) agree to 1e-10 of each tensor's largest entry; solves and
rollouts agree to the tolerances of tests/test_fused_alm.py (x 1e-8,
feasibility 1e-9) and to 1e-8 m per rollout state.
"""

import copy
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omg_tools_tpu as J
from omg_tools_tpu.ops.alm import ALMOptions as JALMOptions
from omg_tools_tpu.ops.alm import make_alm_solver as j_make_alm_solver
from omg_tools_tpu.ops.compact import resolve_phase as j_resolve_phase
from omg_tools_tpu.problems.batch import BatchedP2PRunner as JRunner

import omg_tools_torch as T
from omg_tools_torch.interop import (batch_from_numpy, compact_from_numpy,
                                     state_from_numpy)
from omg_tools_torch.ops.alm import make_alm_solver
from omg_tools_torch.ops.compact import resolve_phase

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke  # noqa: E402  phase 16's moving circle
from torch_bench_configs import jax_compiled  # noqa: E402

B = 4
N_STEPS = 11        # covers the knot-passage (hard budget) step at k = 10
ROLLOUT = dict(outer_iter=2, rescue_lanes=2, rescue_outer=6,
               recover_tol=0.01, budgets=((3, 8), (1, 7)))
HOST_RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These eager solves are small: torch's intra-op threads only spin
    beside the other test processes.  One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build_problem(m):
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
    problem.set_options({"verbose": 0})
    return problem


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX problem, JAX runner, port problem, port runner), float64."""
    old = os.environ.get("OMG_CACHE_DIR")
    os.environ["OMG_CACHE_DIR"] = str(tmp_path_factory.mktemp("omg_cache"))
    try:
        jp = _build_problem(J)
        jp.init()
        jr = JRunner(jax_compiled(jp), dtype=jnp.float64,
                     alm_options=JALMOptions(inner_iter=5))
    finally:
        if old is None:
            os.environ.pop("OMG_CACHE_DIR")
        else:
            os.environ["OMG_CACHE_DIR"] = old
    tp = _build_problem(T)
    tp.init()
    tr = T.BatchedP2PRunner(tp, dtype=torch.float64,
                            alm_options=T.ALMOptions(inner_iter=5),
                            device="cpu")
    assert jr.structure == tr.structure == "compact-arrow"
    return jp, jr, tp, tr


@pytest.fixture(scope="module")
def scenarios():
    rng = np.random.default_rng(0)
    starts = np.tile([-1.5, -1.5], (B, 1)) + rng.uniform(-0.3, 0.3, (B, 2))
    goals = np.tile([2.0, 2.0], (B, 1)) + rng.uniform(-0.3, 0.3, (B, 2))
    return starts, goals


@pytest.fixture(scope="module")
def jax_fns(pair):
    """The JAX runner's cold solve and rollout, compiled once for B
    scenarios."""
    _, jr, _, _ = pair
    return (jax.jit(jr.init_solver_state),
            jax.jit(jr.rollout_fn(N_STEPS, **ROLLOUT)))


def _jax_run(pair, jax_fns, scenarios, obstacle_states=None):
    """The JAX package's cold solve and rollout of the B scenarios."""
    _, jr, _, _ = pair
    x0, p0, state = jr.make_batch(*scenarios, obstacle_states)
    consts = jr.consts()
    st0 = jax_fns[0](x0, p0, consts)
    carry, states = jax_fns[1](st0, p0, state, consts)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    return dict(x0=np.asarray(x0), p0=np.asarray(p0),
                state=np.asarray(state), st0=as_np(st0._asdict()),
                final=as_np(carry[0]._asdict()), states=np.asarray(states),
                p_end=np.asarray(carry[1]))


@pytest.fixture(scope="module")
def jax_run(pair, jax_fns, scenarios):
    return _jax_run(pair, jax_fns, scenarios)


def _close(got, want, rtol=HOST_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _strip(label):
    return re.sub(r"\d+$", "", label)


def _layout_rows(layout, table):
    """(label, name, offset, shape) of a layout table, with every object
    label stripped of its instance number, in names too: the numbers count
    the objects a process has built, and other test files build some."""
    labels = sorted({lbl for t in ("variables", "parameters")
                     for (lbl, _) in getattr(layout, t)}, key=len,
                    reverse=True)

    def norm(name):
        for lbl in labels:
            name = name.replace(lbl, _strip(lbl))
        return name
    return [(_strip(lbl), norm(name), blk.offset, tuple(blk.shape))
            for (lbl, name), blk in getattr(layout, table).items()]


def test_transcription_layout(pair):
    jp, _, tp, _ = pair
    a, b = jp.transcription, tp.transcription
    assert (a.n_x, a.n_p, a.n_g) == (b.n_x, b.n_p, b.n_g)
    for table in ("variables", "parameters"):
        assert _layout_rows(a.layout, table) == \
            _layout_rows(b.layout, table), table
    assert [(c.offset, c.rows) for c in a.layout.constraints] == \
        [(c.offset, c.rows) for c in b.layout.constraints]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_objective_constraints_bounds(pair, seed):
    jp, _, tp, _ = pair
    a, b = jp.transcription, tp.transcription
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(a.n_x) * 0.3
    p = jp.pack_parameters(0.0) + rng.standard_normal(a.n_p) * 0.05
    np.testing.assert_allclose(
        b.constraints(torch.as_tensor(x), torch.as_tensor(p)).numpy(),
        np.asarray(a.constraints(jnp.asarray(x), jnp.asarray(p))),
        rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        float(b.objective(torch.as_tensor(x), torch.as_tensor(p))),
        float(a.objective(jnp.asarray(x), jnp.asarray(p))), rtol=1e-12)
    t = 0.1 * seed
    for u, v in zip(a.bounds(t), b.bounds(t)):
        np.testing.assert_array_equal(v, u)


def test_host_ad_tensors(pair):
    jp, jr, tp, tr = pair
    _close(tp._row_scale, jp._row_scale)
    assert tp._obj_scale == pytest.approx(jp._obj_scale, rel=1e-12)
    _close(tr._Q_raw, jr._Q_raw)
    for key in ("c0", "C1", "A0", "TA", "f0", "gf"):
        _close(tr._affine_np[key], jr._affine_np[key])
    np.testing.assert_array_equal(tr._affine_np["vsel"],
                                  jr._affine_np["vsel"])


def test_compact_structure(pair):
    _, jr, _, tr = pair
    a, b = jr.compact, tr.compact
    assert [tuple(f) for f in a.families] == [tuple(f) for f in b.families]
    np.testing.assert_array_equal(a.row_perm, b.row_perm)
    assert tuple(a.arrow) == tuple(b.arrow)
    assert a.arrow.head[1] == 26 and a.arrow.b_max == 33
    for key in ("c0", "C1", "f0", "gf"):
        _close(b.tensors[key], a.tensors[key])
    np.testing.assert_array_equal(b.tensors["pcols"], a.tensors["pcols"])
    for key in ("A0c", "TAc", "Qc"):
        for u, v in zip(a.tensors[key], b.tensors[key]):
            assert (u is None) == (v is None)
            if u is not None:
                _close(v, u)


def test_make_batch(pair, scenarios, jax_run):
    _, _, _, tr = pair
    x0, p0, state = tr.make_batch(*scenarios)
    np.testing.assert_array_equal(x0.numpy(), jax_run["x0"])
    np.testing.assert_array_equal(p0.numpy(), jax_run["p0"])
    np.testing.assert_array_equal(state.numpy(), jax_run["state"])


def test_init_solver_state(pair, scenarios, jax_run):
    _, _, _, tr = pair
    x0, p0, _ = tr.make_batch(*scenarios)
    st = tr.init_solver_state(x0, p0)
    want = jax_run["st0"]
    np.testing.assert_allclose(st.x.numpy(), want["x"], atol=1e-8)
    np.testing.assert_allclose(st.feas.numpy(), want["feas"], atol=1e-9)
    np.testing.assert_array_equal(st.n_iter.numpy(), want["n_iter"])


def test_runner_to_shares_the_host_work(pair, scenarios, jax_run):
    """``runner.to(device)`` re-targets a built runner without redoing the
    host AD: the copy shares its compaction and solver, and its cold solve
    is the JAX package's."""
    _, _, _, tr = pair
    other = tr.to("cpu")
    assert other is not tr and other.compact is tr.compact
    assert other.solver is tr.solver and other.structure == tr.structure
    x0, p0, _ = other.make_batch(*scenarios)
    st = other.init_solver_state(x0, p0)
    np.testing.assert_allclose(st.x.numpy(), jax_run["st0"]["x"], atol=1e-8)


def test_rollout(pair, scenarios, jax_run):
    _, _, _, tr = pair
    x0, p0, state = tr.make_batch(*scenarios)
    st = tr.init_solver_state(x0, p0)
    carry, states = tr.rollout_fn(N_STEPS, **ROLLOUT)(st, p0, state)
    assert states.shape == (B, N_STEPS, 2)
    np.testing.assert_allclose(states.numpy(), jax_run["states"], atol=1e-8)
    np.testing.assert_allclose(carry[0].x.numpy(), jax_run["final"]["x"],
                               atol=1e-7)


def test_rollout_with_a_moving_circle(pair, jax_fns, scenarios):
    """make_batch(obstacle_states=) with the circle moving at a seeded
    per-scenario velocity (chip_smoke.moving_obstacle_states, phase 16's
    run on the card), x0 and p0 equal to the JAX package's; the cold solve
    and the rollout to the tolerances above, the circle advanced at its
    lane's velocity every period."""
    _, jr, _, tr = pair
    states_in = chip_smoke.moving_obstacle_states(B)
    want = _jax_run(pair, jax_fns, scenarios, states_in)
    x0, p0, state = tr.make_batch(*scenarios, states_in)
    np.testing.assert_array_equal(x0.numpy(), want["x0"])
    np.testing.assert_array_equal(p0.numpy(), want["p0"])
    ix, iv, _ = tr.obstacle_idx[2]
    np.testing.assert_array_equal(p0[:, iv].numpy(), states_in[2][1])
    st = tr.init_solver_state(x0, p0)
    np.testing.assert_allclose(st.x.numpy(), want["st0"]["x"], atol=1e-8)
    carry, states = tr.rollout_fn(N_STEPS, **ROLLOUT)(st, p0, state)
    np.testing.assert_allclose(states.numpy(), want["states"], atol=1e-8)
    p_end = carry[1].numpy()
    np.testing.assert_allclose(p_end, want["p_end"], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        p_end[:, ix], p0[:, ix].numpy() + N_STEPS * tr.update_time
        * p0[:, iv].numpy(), atol=1e-12)


def test_solver_on_jax_compact_structure(pair, jax_run):
    """The port's solver fed the JAX package's compact structure and
    inputs: isolates the solver from the port's own host AD."""
    jp, jr, tp, _ = pair
    c = jr.compact
    struct = compact_from_numpy(c.families, c.row_perm, c.tensors, c.n_x,
                                c.n_p, c.arrow)
    tr_ = tp.transcription
    solve = make_alm_solver(tr_.objective, tr_.constraints, tr_.n_x,
                            tr_.lb, tr_.ub, T.ALMOptions(inner_iter=5),
                            row_scale=jp._row_scale,
                            obj_scale=jp._obj_scale, compact=struct)
    x0, p0, _ = batch_from_numpy(jax_run["x0"], jax_run["p0"],
                                 jax_run["state"], device="cpu")
    ct = resolve_phase(struct, struct.device_tensors(torch.float64, "cpu"),
                       0, p0)
    st = solve(x0, p0, np.array(jr.lb), np.array(jr.ub), ct=ct)
    np.testing.assert_allclose(st.x.numpy(), jax_run["st0"]["x"], atol=1e-8)
    np.testing.assert_allclose(st.feas.numpy(), jax_run["st0"]["feas"],
                               atol=1e-9)


def test_rollout_from_jax_state(pair, jax_run):
    """The port's rollout warm-started from the JAX package's cold-solve
    state (interop.state_from_numpy)."""
    _, _, _, tr = pair
    st = state_from_numpy(jax_run["st0"], device="cpu")
    _, p0, state = batch_from_numpy(jax_run["x0"], jax_run["p0"],
                                    jax_run["state"], device="cpu")
    _, states = tr.rollout_fn(N_STEPS, **ROLLOUT)(st, p0, state)
    np.testing.assert_allclose(states.numpy(), jax_run["states"], atol=1e-8)


def test_compact_without_arrow_cold_solve(pair, jax_run):
    """The compact mode without an arrow partition (the dense compact
    Gauss-Newton system through psd_solve): the cold solve of the B
    scenarios against the JAX package's on the same compact structure."""
    jp, jr, tp, tr = pair
    jc, tc = copy.copy(jr.compact), copy.copy(tr.compact)
    jc.arrow = tc.arrow = None
    opt = dict(inner_iter=5)
    args = dict(row_scale=jp._row_scale, obj_scale=jp._obj_scale)
    ja, ta = jp.transcription, tp.transcription
    js = j_make_alm_solver(ja.objective, ja.constraints, ja.n_x, ja.lb,
                           ja.ub, JALMOptions(**opt), compact=jc, **args)
    ts = make_alm_solver(ta.objective, ta.constraints, ta.n_x, ta.lb, ta.ub,
                         T.ALMOptions(**opt), compact=tc, **args)
    lb, ub = ja.bounds(0.0)
    dt = jc.device_tensors(jnp.float64)
    want = jax.jit(jax.vmap(lambda x, p: js(
        x, p, lb, ub, ct=j_resolve_phase(jc, dt, 0, p))))(
            jnp.asarray(jax_run["x0"]), jnp.asarray(jax_run["p0"]))
    x0, p0, _ = batch_from_numpy(jax_run["x0"], jax_run["p0"],
                                 jax_run["state"], device="cpu")
    ct = resolve_phase(tc, tc.device_tensors(torch.float64, "cpu"), 0, p0)
    st = ts(x0, p0, np.asarray(lb), np.asarray(ub), ct=ct)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(want.x), atol=1e-8)
    np.testing.assert_allclose(st.feas.numpy(), np.asarray(want.feas),
                               atol=1e-9)
    np.testing.assert_array_equal(st.n_iter.numpy(), np.asarray(want.n_iter))

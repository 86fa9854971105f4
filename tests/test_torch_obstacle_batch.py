"""Per-scenario obstacle states and spline-trajectory obstacles in the
port's batched runner held to the JAX runner, in float64 on the CPU.

The scene is the p2p_holonomic_obstraj_export example's
(``chip_smoke.build_scene(m, "obstraj")``): a Holonomic vehicle with a
0.1 m safety distance, a 3.0 x 0.2 m rectangle (a moving obstacle: x, v,
a parameters) and a 0.4 m circle on a caller-given spline trajectory.
Each of B = 8 scenarios gives the rectangle its own velocity (numpy seed
0: speed uniform in 0-0.2 m/s, direction uniform) through
``make_batch(obstacle_states=)``; the circle's entry only places its
hyperplane warm start, as in the JAX package.  Both runners take the
``compact-arrow`` structure in float64.  (The bench scene with a moving
circle is held the same way in tests/test_torch_main_path.py, on that
file's JAX runner.)

Tolerances: x0, p0, the shift matrices and the parameter indices equal;
the cold solve to 1e-8 in x, 1e-9 in feasibility; a 3-step rollout's
states to 1e-8 m (tests/test_torch_main_path.py's).  The solves start
from make_batch's x0 plus a seeded 1e-2: make_batch's own start puts
rows exactly on their bounds (the safety distance's slack splines), where
the JAX package's cold solve moves by O(1) when x0 moves by 1e-15 (and
from the moved start by ~2e-11, the port landing ~3e-11 from it).
"""

import os

import numpy as np
import pytest
import torch

import omg_tools_torch as T
from torch_bench_configs import jax_compiled, one_torch_thread  # noqa: F401
import chip_smoke

B = 8
N_STEPS = 3
ROLLOUT = dict(outer_iter=2, rescue_lanes=2, rescue_outer=6,
               recover_tol=0.01, budgets=((3, 8), (1, 7)))
START_NOISE = 1e-2


def moved(x0):
    """make_batch's start plus a seeded 1e-2 (numpy)."""
    x0 = np.asarray(x0)
    return x0 + START_NOISE * np.random.default_rng(5).standard_normal(
        x0.shape)


def obstacle_states(B, seed=0):
    """(pos, vel, acc) per obstacle, each (B, 2): the rectangle at its
    position with a seeded velocity, the circle (spline trajectory) at
    its initial position."""
    rng = np.random.default_rng(seed)
    speed = rng.uniform(0.0, 0.2, B)
    heading = rng.uniform(0.0, 2 * np.pi, B)
    vel = np.stack([speed * np.cos(heading), speed * np.sin(heading)], 1)
    zero = np.zeros((B, 2))
    return [(np.tile([1.7, -0.5], (B, 1)), vel, zero),
            (np.tile([1.5, 0.5], (B, 1)), zero, zero)]


@pytest.fixture(scope="module")
def scenarios():
    rng = np.random.default_rng(0)
    starts = np.tile([-1.5, -1.5], (B, 1)) + rng.uniform(-0.3, 0.3, (B, 2))
    goals = np.tile([2.0, 2.0], (B, 1)) + rng.uniform(-0.3, 0.3, (B, 2))
    return starts, goals


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """(JAX runner, port runner), float64; the JAX runner's host tensors
    in a private cache directory."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    J = pytest.importorskip("omg_tools_tpu")
    import jax.numpy as jnp
    from omg_tools_tpu.ops.alm import ALMOptions as JALMOptions
    from omg_tools_tpu.problems.batch import BatchedP2PRunner as JRunner
    old = os.environ.get("OMG_CACHE_DIR")
    os.environ["OMG_CACHE_DIR"] = str(tmp_path_factory.mktemp("omg_cache"))
    try:
        jp = chip_smoke.build_scene(J, "obstraj")
        jp.init()
        jr = JRunner(jax_compiled(jp), dtype=jnp.float64,
                     alm_options=JALMOptions(inner_iter=5))
    finally:
        if old is None:
            os.environ.pop("OMG_CACHE_DIR")
        else:
            os.environ["OMG_CACHE_DIR"] = old
    tp = chip_smoke.build_scene(T, "obstraj", {"device": "cpu"})
    tp.init()
    tr = T.BatchedP2PRunner(tp, dtype=torch.float64, device="cpu",
                            alm_options=T.ALMOptions(inner_iter=5))
    assert jr.structure == tr.structure == "compact-arrow"
    return jr, tr


@pytest.fixture(scope="module")
def jax_run(runners, scenarios):
    import jax
    jr, _ = runners
    x0, p0, state = jr.make_batch(*scenarios, obstacle_states(B))
    consts = jr.consts()
    st0 = jax.jit(jr.init_solver_state)(moved(x0), p0, consts)
    carry, states = jax.jit(jr.rollout_fn(N_STEPS, **ROLLOUT))(
        st0, p0, state, consts)
    return dict(x0=np.asarray(x0), p0=np.asarray(p0),
                x_cold=np.asarray(st0.x), feas_cold=np.asarray(st0.feas),
                states=np.asarray(states), p_end=np.asarray(carry[1]))


def test_obstacle_indices_and_shift_matrices(runners):
    """One moving obstacle (x, v, a), one spline-trajectory obstacle with
    its shift matrix over one period (update_time / horizon)."""
    jr, tr = runners
    assert len(tr.obstacle_idx) == len(jr.obstacle_idx) == 1
    for u, v in zip(jr.obstacle_idx[0], tr.obstacle_idx[0]):
        np.testing.assert_array_equal(v, u)
    assert len(tr.traj_obstacle_idx) == len(jr.traj_obstacle_idx) == 1
    (ic_j, shape_j, M_j), (ic_t, shape_t, M_t) = \
        jr.traj_obstacle_idx[0], tr.traj_obstacle_idx[0]
    np.testing.assert_array_equal(ic_t, ic_j)
    assert tuple(shape_t) == tuple(shape_j)
    np.testing.assert_array_equal(M_t.numpy(), np.asarray(M_j))
    # the coefficients are among the varying parameters
    assert set(ic_t) <= set(tr._varying_param_indices())


def test_make_batch_with_obstacle_states(runners, scenarios, jax_run):
    jr, tr = runners
    x0, p0, state = tr.make_batch(*scenarios, obstacle_states(B))
    np.testing.assert_array_equal(x0.numpy(), jax_run["x0"])
    np.testing.assert_array_equal(p0.numpy(), jax_run["p0"])
    ix, iv, _ = tr.obstacle_idx[0]
    np.testing.assert_array_equal(p0[:, iv].numpy(), obstacle_states(B)[0][1])
    # without states: the obstacles' own, as the JAX package gives them
    x1, p1, _ = tr.make_batch(*scenarios)
    jx1, jp1, _ = jr.make_batch(*scenarios)
    np.testing.assert_array_equal(x1.numpy(), np.asarray(jx1))
    np.testing.assert_array_equal(p1.numpy(), np.asarray(jp1))


def test_rollout_matches_jax(runners, scenarios, jax_run):
    """The cold solve and a 3-step compact-arrow rollout: the rectangle
    moves with each lane's velocity and the circle's coefficients advance
    by the shift matrix every period."""
    _, tr = runners
    x0, p0, state = tr.make_batch(*scenarios, obstacle_states(B))
    st = tr.init_solver_state(torch.as_tensor(moved(x0)), p0)
    np.testing.assert_allclose(st.x.numpy(), jax_run["x_cold"], atol=1e-8)
    np.testing.assert_allclose(st.feas.numpy(), jax_run["feas_cold"],
                               atol=1e-9)
    carry, states = tr.rollout_fn(N_STEPS, **ROLLOUT)(st, p0, state)
    assert states.shape == (B, N_STEPS, 2)
    np.testing.assert_allclose(states.numpy(), jax_run["states"], atol=1e-8)
    p_end = carry[1].numpy()
    np.testing.assert_allclose(p_end, jax_run["p_end"], rtol=1e-12,
                               atol=1e-12)
    ic, cshape, M = tr.traj_obstacle_idx[0]
    c0 = p0[:, ic].numpy().reshape(B, *cshape)
    M3 = np.linalg.matrix_power(M.numpy(), N_STEPS)
    np.testing.assert_allclose(p_end[:, ic].reshape(B, *cshape),
                               np.einsum("ij,bjk->bik", M3, c0), atol=1e-12)
    ix, iv, _ = tr.obstacle_idx[0]
    np.testing.assert_allclose(
        p_end[:, ix], p0[:, ix].numpy() + N_STEPS * tr.update_time
        * p0[:, iv].numpy(), atol=1e-12)

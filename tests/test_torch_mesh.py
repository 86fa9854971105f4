"""The port's fleet mesh path (``FleetRunner(mesh=)``,
``parallel.fleet_mesh``) on the CPU over gloo, held to the JAX package and
to itself, in float64.

The ranks are processes of ``tests/torch_mesh_rank.py`` (gloo on
127.0.0.1 at a free port, one torch thread each, a 120 s process-group
timeout and a timeout of their own here), each printing one JSON line; the
pytest worker joins no process group.  Each world size is started once,
when the module's first test asks for it, and serves every check below.
The scene is bench.py's formation_holonomic on tests/test_torch_fleet.py's
cut x-update budget (2 outer x 4 inner).

Tolerances.  The port's 2-rank ring against the JAX package's 2-device
mesh: 1e-8 (tests/test_torch_fleet.py's iterates); the port against
itself across 1-4 ranks: 1e-9 (tests/test_fleet_runner.py:124 asks it of
the JAX package); the rollouts at 1 and 2 ranks: 1e-8
(tests/test_fleet_runner.py:156-157).  The mesh x-update solves cold
(``omg_tools_tpu/parallel/fleet_runner.py:476-478``), so the mesh path is
held to the JAX mesh path, never to ``iterate_fn``.

One JAX mesh program costs ~60 s on this CPU (it is not jitted, every
call traces and compiles), so tier-1 builds one live JAX reference; the
other comparisons with the JAX package are ``slow``, as the JAX package
marks its own mesh tests (run them with ``-m slow``).
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

import omg_tools_torch as T
from omg_tools_torch.environment.shapes import RegularPolyhedron
from omg_tools_torch.parallel import FleetRunner, build_local_dual_update

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_mesh_rank as rank_script  # noqa: E402

TOL_JAX = 1e-8
TOL_RANKS = 1e-9
TOL_ROLLOUT = 1e-8


@pytest.fixture(scope="module")
def worlds():
    """The mesh program at 1-4 ranks, all started together."""
    started = {w: rank_script.world(w) for w in (1, 2, 3, 4)}
    yield started
    for w in started.values():
        w.kill()


@pytest.fixture(scope="module")
def J():
    """The JAX package (float64; tests/conftest.py's 8 CPU devices)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    return pytest.importorskip("omg_tools_tpu")


def _close(a, b, tol, what):
    err = float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
    assert err <= tol, f"{what}: {err} > {tol}"


def _jax_inputs(problem, single=True):
    import jax.numpy as jnp
    Xs = tuple(jnp.asarray(g.X) for g in problem.groups)
    Ps = tuple(jnp.asarray(problem._pack_params(g, 0.0))
               for g in problem.groups)
    if single:
        Xs, Ps = Xs[0], Ps[0]
    return Xs, Ps, jnp.asarray(problem.Z), jnp.asarray(problem.L)


def _jax_mesh(n_dev, axes=("fleet",), shape=None):
    import jax
    from jax.sharding import Mesh
    devs = np.array(jax.devices()[:n_dev])
    return Mesh(devs.reshape(shape or (n_dev,)), axes)


def jax_mesh_iterate(J, n_dev, mixed=False, n_iter=2):
    """The JAX package's ``mesh_iterate_fn`` on n_dev CPU devices."""
    import jax.numpy as jnp
    from omg_tools_tpu.parallel.fleet_runner import FleetRunner as JRunner
    problem = rank_script.bench_formation(J, mixed=mixed)
    runner = JRunner(problem, dtype=jnp.float64, mesh=_jax_mesh(n_dev))
    (X, Z, L), (pri, dua) = runner.mesh_iterate_fn(n_iter)(
        *_jax_inputs(problem, single=not mixed))
    X = [np.asarray(x) for x in X] if mixed else [np.asarray(X)]
    return dict(X=X, Z=np.asarray(Z), L=np.asarray(L), pri=np.asarray(pri),
                dua=np.asarray(dua))


def _held_to_jax(port, ref, tol, what):
    for xp, xj in zip(port["X"], ref["X"]):
        _close(xp, xj, tol, f"{what} X")
    for key in ("Z", "L", "pri", "dua"):
        _close(port[key], ref[key], tol, f"{what} {key}")


# -- tier-1 -------------------------------------------------------------------

def test_ring_matches_jax_two_devices(J, worlds):
    """The port's 2-rank ring against the JAX package's 2-device
    ``mesh_iterate_fn(2)``: X, Z, L and the residuals within 1e-8."""
    ref = jax_mesh_iterate(J, 2)
    for r in worlds[2].results():
        _held_to_jax(r["iterate"], ref, TOL_JAX, f"rank {r['rank']}")


@pytest.mark.parametrize("size", [2, 3, 4])
def test_rank_count_invariance(worlds, size):
    """``mesh_iterate_fn(2)`` at 2, 3 and 4 ranks against one rank within
    1e-9 (the ring at 2 and 4, the gathered table at 3: 4 rows do not
    split over 3), every rank returning the whole fleet."""
    one = worlds[1].results()[0]["iterate"]
    for r in worlds[size].results():
        it = r["iterate"]
        for key in ("X", "Z", "L", "pri", "dua"):
            _close(it[key], one[key], TOL_RANKS, f"{size} ranks, rank "
                   f"{r['rank']}: {key}")


def test_collective_routes(worlds):
    """The counts show the route each world took: one rank sends nothing,
    the ring moves rows by p2p (3 exchanges an iteration, no gathered
    table), the table all-gathers them (and sends nothing); every world
    all-reduces its residuals (one an iteration) and gathers its result
    (once)."""
    n_iter = 2
    for size in (1, 2, 3, 4):
        for r in worlds[size].results():
            c = r["iterate"]["collectives"]
            assert c["all_reduce"] == n_iter, (size, c)
            if size == 3:
                assert c["p2p"] == 0 and c["all_gather"] == 3 * n_iter + 1, c
            else:
                assert c["p2p"] == (0 if size == 1 else 3 * n_iter), c
                assert c["all_gather"] == 1, (size, c)


def test_mesh_rollout_one_and_two_ranks(worlds):
    """``mesh_rollout_fn(4)`` at update_time 0.5 (a knot at period 2) at
    one and two ranks: equal within 1e-8, finite, the fleet advancing."""
    one = worlds[1].results()[0]["rollout"]
    goals = np.array([2.0, 2.0]) + RegularPolyhedron(
        0.2, rank_script.N, np.pi / 4).vertices.T
    for r in worlds[2].results():
        for key in ("states", "pri", "dua", "Z"):
            _close(r["rollout"][key], one[key], TOL_ROLLOUT,
                   f"rank {r['rank']}: {key}")
    states = np.asarray(one["states"])          # (N, steps, 2)
    assert states.shape == (rank_script.N, rank_script.ROLLOUT_STEPS, 2)
    assert np.isfinite(states).all() and np.isfinite(one["pri"]).all()
    d0 = np.linalg.norm(states[:, 0] - goals, axis=1)
    d1 = np.linalg.norm(states[:, -1] - goals, axis=1)
    assert (d1 < d0).all(), (d0, d1)


def test_mesh_dual_update_one_and_two_ranks(worlds):
    """``make_mesh_dual_update`` at one and two ranks: equal within
    1e-9, finite."""
    one = worlds[1].results()[0]["dual"]
    for r in worlds[2].results():
        for key in ("X", "Z", "L", "pri", "dua"):
            _close(r["dual"][key], one[key], TOL_RANKS,
                   f"rank {r['rank']}: {key}")
    assert np.isfinite(one["X"]).all()


def test_mesh_asserts_raise():
    """The JAX package's three asserts (N > 2, one group, N divisible by
    the mesh axis; on stand-ins of a fleet: they fire before anything else
    is read), a mesh on another device type, and the mesh functions of a
    runner without a mesh."""
    for fleet, n_dev, match in (
            (types.SimpleNamespace(N=2, groups=[None]), 1, "N>2"),
            (types.SimpleNamespace(N=4, groups=[None, None]), 2,
             "homogeneous fleet"),
            (types.SimpleNamespace(N=4, groups=[None]), 3,
             "divide the mesh axis")):
        with pytest.raises(AssertionError, match=match):
            build_local_dual_update(fleet, None, n_dev)
    with pytest.raises(ValueError, match="cuda mesh for a runner on cpu"):
        FleetRunner(None, device="cpu",
                    mesh=types.SimpleNamespace(device_type="cuda"))
    runner = FleetRunner(rank_script.bench_formation(T), device="cpu")
    for fn in (runner.mesh_iterate_fn, runner.mesh_rollout_fn):
        with pytest.raises(ValueError, match="with a mesh"):
            fn(2)


# -- against the JAX package, slow ---------------------------------------------

@pytest.mark.slow
def test_gathered_table_matches_jax_three_devices(J, worlds):
    """The gathered-table route: the port at 3 ranks against the JAX
    package on 3 devices, within 1e-8."""
    ref = jax_mesh_iterate(J, 3)
    for r in worlds[3].results():
        _held_to_jax(r["iterate"], ref, TOL_JAX, f"rank {r['rank']}")


@pytest.mark.slow
def test_mixed_fleet_matches_jax(J):
    """2 Holonomic + 2 HolonomicOrient (two groups, type masks) at 2
    ranks against the JAX package on 2 devices, within 1e-8."""
    world = rank_script.world(2, program="mixed")
    ref = jax_mesh_iterate(J, 2, mixed=True)
    for r in world.results():
        _held_to_jax(r["iterate"], ref, TOL_JAX, f"rank {r['rank']}")


@pytest.mark.slow
def test_mesh_rollout_across_a_knot_matches_jax(J, worlds):
    """``mesh_rollout_fn(4)`` at update_time 0.5 against the JAX package
    on 2 devices: the periods before the knot within 1e-8; the knot's
    period (the cold x-updates from shifted splines) within 4x the JAX
    package's own spread under three 1e-15 moves of its start, as
    tests/test_torch_fleet.py measures it; from this start, the guess,
    that spread is centimetres, so the knot's check is weak."""
    import jax.numpy as jnp
    from omg_tools_tpu.parallel.fleet_runner import FleetRunner as JRunner
    problem = rank_script.bench_formation(J)
    runner = JRunner(problem, dtype=jnp.float64, mesh=_jax_mesh(2),
                     update_time=rank_script.UPDATE_TIME)
    roll = runner.mesh_rollout_fn(rank_script.ROLLOUT_STEPS)
    X, P, Z, L = _jax_inputs(problem)
    _, (pri, dua, states) = roll(X, P, Z, L)
    ref = {"states": np.asarray(states), "pri": np.asarray(pri),
           "dua": np.asarray(dua)}
    k = runner.spk                       # the knot's period
    sens = {key: 0.0 for key in ref}
    for seed in range(3):
        rng = np.random.default_rng(seed)
        moved = X * (1.0 + 1e-15 * jnp.asarray(rng.standard_normal(X.shape)))
        _, (pm, dm, sm) = roll(moved, P, Z, L)
        for key, a in zip(("pri", "dua", "states"), (pm, dm, sm)):
            a = np.asarray(a)
            sens[key] = max(sens[key], float(np.max(np.abs(
                (a[:, k] - ref[key][:, k]) if key == "states"
                else a[k] - ref[key][k]))))
    # from the straight-line guess (rows on their bounds) the cold solves
    # of the cut budget spread ~1e-2 m at the knot (1.27e-2 on the CPU)
    assert 0.0 < sens["states"], sens
    port = worlds[2].results()[0]["rollout"]
    st = np.asarray(port["states"])
    _close(st[:, :k], ref["states"][:, :k], TOL_JAX, "states before the knot")
    _close(st[:, k], ref["states"][:, k], max(TOL_JAX, 4 * sens["states"]),
           "states at the knot")
    for key in ("pri", "dua"):
        a = np.asarray(port[key])
        _close(a[:k], ref[key][:k], TOL_JAX, f"{key} before the knot")
        _close(a[k], ref[key][k], max(TOL_JAX, 4 * sens[key]),
               f"{key} at the knot")


@pytest.mark.slow
def test_mesh_dual_update_matches_jax(J, worlds):
    """``make_mesh_dual_update`` at 2 ranks against the JAX package's on 2
    devices, within 1e-8."""
    from omg_tools_tpu.parallel.fleet_mesh import make_mesh_dual_update
    problem = rank_script.bench_formation(J)
    step = make_mesh_dual_update(problem, _jax_mesh(2),
                                 outer_iter=rank_script.DUAL_OUTER)
    Xn, Zn, Ln, pri, dua = step(*_jax_inputs(problem))
    ref = dict(X=[np.asarray(Xn)], Z=np.asarray(Zn), L=np.asarray(Ln),
               pri=float(pri), dua=float(dua))
    for r in worlds[2].results():
        d = dict(r["dual"], X=[r["dual"]["X"]])
        _held_to_jax(d, ref, TOL_JAX, f"rank {r['rank']}")


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_mesh_card_matches_cpu(cuda_device):
    """chip_smoke.py's phase 21 (c) in a one-rank process (NCCL, gloo
    beside it): ``mesh_iterate_fn(2)`` in float64 on the cut budget on the
    card and on the CPU from the card's cold solves, Z within 1e-8 (the
    CPU's own move under a 1e-15 move of that start is printed)."""
    r = rank_script.world(1, program="card").results()[0]["card"]
    print(r)
    assert r["finite"]
    assert r["card_vs_cpu_Z"] <= TOL_JAX, r


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.float64, 1e-10)])
def test_cuda_k1_at_the_hybrid_shape(cuda_device, dtype, tol):
    """K1 at the hybrid update's shape (256 fleet instances of four
    vehicles: 1,024 systems of 85 rows, the ``block`` variant) against its
    plain version."""
    from omg_tools_torch.ops import psd_kernels as pk
    rng = np.random.default_rng(11)
    A = rng.standard_normal((1024, 85, 85))
    H = torch.as_tensor(A @ A.transpose(0, 2, 1) / 85 + np.eye(85),
                        dtype=dtype, device=cuda_device)
    g = torch.as_tensor(rng.standard_normal((1024, 85)), dtype=dtype,
                        device=cuda_device)
    assert pk.variant(85, 1, dtype) == "block"
    before = pk.psd_solve.by_systems[1024]
    got = pk.psd_solve(H, g)
    want = pk.psd_solve_plain(H, g)
    torch.cuda.synchronize()
    assert pk.psd_solve.by_systems[1024] == before + 1
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())

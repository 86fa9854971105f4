"""The batched runner's dense and compact structures held to the JAX
package: ``quadratic`` (the dense quadratic form with per-phase affine
tensors), ``generic`` (AD every Newton step) and ``compact`` (no arrow
partition), beside the ``compact-arrow`` structure the port ran before.

On the CPU the structures are held on a small scene whose runners are
cheap in both packages: one Holonomic in an empty 5 m room.  Each package
is forced to each structure as tests/test_compact.py:127-140 forces the
dense path (for ``generic`` Q and the affine tensors are dropped as well),
and 4 seeded lanes are compared in float64: the cold solve and a 2-step
rollout on a cut budget (2 outer rounds of 4 inner iterations, a 2-lane x
1-round rescue).  Tolerance: 4x the JAX solve's own move under a 1e-15
perturbation of its start (5 draws), with a floor of 1e-10 (the rule of
tests/test_torch_free_time.py).  The JAX problem's transcription f and g
are compiled with ``jax.jit`` before its runner's host AD (the same
functions; op by op that AD took ~40 s a build on one CPU core).

On the bench scene the forced ``quadratic`` and ``compact`` 3-step
rollouts, warm-started from the compact-arrow cold solve, are held to
the port's ``compact-arrow`` rollout of the same batch (which
tests/test_torch_main_path.py holds to the JAX package) at
tests/test_compact.py:149's rtol 1e-4 / atol 5e-5, with its progress
assertion.  No JAX runner of the exact-integral Dubins is built here (its
constructor takes minutes in the JAX package): the ``gpu`` tests hold it
on the card against the port on the CPU.

The JAX package is imported by a fixture, so that the ``gpu`` tests run
where JAX is not installed:

    python -m pytest tests/test_torch_structures.py -m gpu --noconftest -q
"""

import os
import sys

import numpy as np
import pytest
import torch

import omg_tools_torch as T
from omg_tools_torch.ops import psd_kernels as pk
from omg_tools_torch.ops.alm import CapturedCall

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke  # noqa: E402  the bench and exact-Dubins scenes
from torch_bench_configs import jax_compiled  # noqa: E402

B = 4
CUT = {"outer_iter": 2, "inner_iter": 4}
ROLLOUT = dict(outer_iter=2, rescue_lanes=2, rescue_outer=1)
PERTURB = 1e-15
DRAWS = 5
SPREAD_FACTOR = 4.0
ROUNDING_FLOOR = 1e-10
FORCED = ("quadratic", "compact", "generic")
WARM_BUDGET = {"outer_iter": 6, "inner_iter": 8}   # the card's rollout test


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
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


def _small_scene(m, **options):
    vehicle = m.Holonomic()
    vehicle.set_initial_conditions([-1.5, -1.5])
    vehicle.set_terminal_conditions([2.0, 2.0])
    environment = m.Environment(room={"shape": m.Square(5.0)})
    problem = m.Point2point(vehicle, environment, freeT=False)
    problem.set_options({"verbose": 0, **options})
    problem.init()
    return problem


def _scenarios(seed=1):
    rng = np.random.default_rng(seed)
    starts = np.tile([-1.5, -1.5], (B, 1)) + rng.uniform(-0.2, 0.2, (B, 2))
    goals = np.tile([2.0, 2.0], (B, 1)) + rng.uniform(-0.2, 0.2, (B, 2))
    return starts, goals


def force(runner, structure):
    """Force a built runner of either package onto ``structure`` and give
    it a new solver: the compaction's arrow off (``compact``), the
    compaction off (``quadratic``), and also Q and the affine tensors off
    (``generic``)."""
    if structure == "compact":
        runner.compact.arrow = None
    else:
        runner.compact = None
    if structure == "generic":
        runner._Q_raw = None
        runner.affine_cA = False
        runner._affine_np = None
    runner.fused_plan = None
    if not isinstance(runner, T.BatchedP2PRunner):
        # the JAX runner stores its structure and its device Q
        runner.structure = structure
        runner.solver = runner.make_solver(runner._alm_options)
        runner.Q_dev = None if runner.solver.Q_scaled is None else \
            np.asarray(runner.solver.Q_scaled)
        return runner
    runner.solver = runner.make_solver(runner._alm_options)
    assert runner.structure == structure
    return runner


@pytest.fixture(scope="module")
def small(J, tmp_path_factory):
    """The small scene in both packages, float64, and runner builders; the
    JAX runners keep their host tensors in a private cache directory."""
    from omg_tools_tpu.ops.alm import ALMOptions as JALMOptions
    from omg_tools_tpu.problems.batch import BatchedP2PRunner as JRunner
    import jax.numpy as jnp
    cache = str(tmp_path_factory.mktemp("omg_cache"))
    jp = jax_compiled(_small_scene(J))
    tp = _small_scene(T, device="cpu")

    def jax_runner():
        old = os.environ.get("OMG_CACHE_DIR")
        os.environ["OMG_CACHE_DIR"] = cache
        try:
            return JRunner(jp, dtype=jnp.float64,
                           alm_options=JALMOptions(**CUT))
        finally:
            if old is None:
                os.environ.pop("OMG_CACHE_DIR")
            else:
                os.environ["OMG_CACHE_DIR"] = old

    def port_runner():
        return T.BatchedP2PRunner(tp, dtype=torch.float64, device="cpu",
                                  alm_options=T.ALMOptions(**CUT))
    return jax_runner, port_runner


def test_unforced_pick_matches_jax(small):
    jax_runner, port_runner = small
    jr, tr = jax_runner(), port_runner()
    assert tr.structure == jr.structure == "compact-arrow"


@pytest.mark.parametrize("structure", FORCED)
def test_forced_structure_matches_jax(small, structure):
    """The cold solve and a 2-step rollout with rescue on the forced
    structure, in both packages, within 4x the JAX package's own move
    under a 1e-15 start perturbation."""
    import jax
    jax_runner, port_runner = small
    jr, tr = force(jax_runner(), structure), force(port_runner(), structure)
    starts, goals = _scenarios()
    x0, p0, state = (np.asarray(a) for a in jr.make_batch(starts, goals))
    consts = jr.consts()
    init = jax.jit(jr.init_solver_state)
    roll = jax.jit(jr.rollout_fn(2, **ROLLOUT))

    def run_jax(x):
        st = init(x, p0, consts)
        _, states = roll(st, p0, state, consts)
        return np.asarray(st.x), np.asarray(states)
    want_x, want_states = run_jax(x0)
    rng = np.random.default_rng(3)
    spread_x = spread_s = 0.0
    for _ in range(DRAWS):
        xp, sp = run_jax(x0 * (1 + PERTURB * rng.standard_normal(x0.shape)))
        spread_x = max(spread_x, float(np.abs(xp - want_x).max()))
        spread_s = max(spread_s, float(np.abs(sp - want_states).max()))

    tx0, tp0, tstate = tr.make_batch(starts, goals)
    np.testing.assert_array_equal(tx0.numpy(), x0)
    np.testing.assert_array_equal(tp0.numpy(), p0)
    st = tr.init_solver_state(tx0, tp0)
    _, states = tr.rollout_fn(2, **ROLLOUT)(st, tp0, tstate)
    err_x = float(np.abs(st.x.numpy() - want_x).max())
    err_s = float(np.abs(states.numpy() - want_states).max())
    assert np.isfinite(states.numpy()).all()
    assert err_x <= max(SPREAD_FACTOR * spread_x, ROUNDING_FLOOR), \
        (err_x, spread_x)
    assert err_s <= max(SPREAD_FACTOR * spread_s, ROUNDING_FLOOR), \
        (err_s, spread_s)


def test_consts_must_match_the_structure(small):
    """Consts of another structure raise; so does a fused plan without the
    arrow it was made from."""
    _, port_runner = small
    tr = port_runner()
    x0, p0, _ = tr.make_batch(*_scenarios())
    compact_consts = tr.consts()
    force(tr, "quadratic")
    assert isinstance(tr.consts(), T.problems.batch.RolloutConsts)
    with pytest.raises(ValueError, match="consts of type CompactConsts"):
        tr.init_solver_state(x0, p0, compact_consts)
    quadratic_consts = tr.consts()
    force(tr, "generic")
    assert tr.consts().Q is None and tr.consts().c0 is None
    with pytest.raises(ValueError, match="carry Q exactly"):
        tr.init_solver_state(x0, p0, quadratic_consts)
    arrow = port_runner()
    arrow.fused_plan = object()
    arrow.compact.arrow = None
    with pytest.raises(ValueError, match="fused plan on the compact"):
        arrow.structure


@pytest.fixture(scope="module")
def bench():
    """The bench scene's float64 runner builder, its compact-arrow cold
    solve and that solve's 3-step rollout (2 outer rounds a step,
    tests/test_compact.py:117), on tests/test_torch_main_path.py's batch
    and budget (4 lanes; 5 inner iterations, 20 outer rounds in the cold
    solve).  At the full default budget (16 x 20) the cold solve
    amplifies rounding past its ~12th Newton iteration: a lane's states
    moved 1.3-2.7 cm between structures there, as far as a 1e-15 move of
    its start moves them."""
    problem = chip_smoke.build_problem(T)

    def runner():
        return T.BatchedP2PRunner(problem, dtype=torch.float64,
                                  device="cpu",
                                  alm_options=T.ALMOptions(inner_iter=5))
    rng = np.random.default_rng(0)
    starts = np.tile([-1.5, -1.5], (B, 1)) + rng.uniform(-0.3, 0.3, (B, 2))
    goals = np.tile([2.0, 2.0], (B, 1)) + rng.uniform(-0.3, 0.3, (B, 2))
    ca = runner()
    assert ca.structure == "compact-arrow"   # the JAX package's pick
    x0, p0, state = ca.make_batch(starts, goals)
    st = ca.init_solver_state(x0, p0)
    _, states = ca.rollout_fn(3, outer_iter=2)(st, p0, state)
    return runner, (starts, goals), (st, p0, state), ca.compact.row_perm, \
        states


@pytest.mark.parametrize("structure", ("quadratic", "compact"))
def test_bench_scene_forced_rollout_matches_compact_arrow(bench, structure):
    """The forced structure's 3-step rollout from the compact-arrow cold
    solve, its multipliers put back into the transcription's row order
    for ``quadratic`` (a compact solver keeps them in the compaction's)."""
    runner, (starts, goals), (st, p0, state), perm, want = bench
    r = force(runner(), structure)
    if structure == "quadratic":
        lam = torch.empty_like(st.lam)
        lam[:, torch.as_tensor(perm)] = st.lam
        st = st._replace(lam=lam)
    _, states = r.rollout_fn(3, outer_iter=2)(st, p0, state)
    np.testing.assert_allclose(states.numpy(), want.numpy(), rtol=1e-4,
                               atol=5e-5)
    d0 = np.linalg.norm(starts - goals, axis=1)
    d1 = np.linalg.norm(states.numpy()[:, -1] - goals, axis=1)
    assert np.all(d1 < d0)


# -- on the card -------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def exact_dubins(cuda_device):
    """Phase 20's scene: the exact-integral Dubins (no substitution)."""
    return chip_smoke.build_structures_problem(T, {"device": "cpu"})


@pytest.mark.gpu
def test_cuda_exact_dubins_picks_generic(exact_dubins):
    runner = T.BatchedP2PRunner(exact_dubins, dtype=torch.float32)
    assert runner.structure == "generic" and runner.compact is None
    assert runner.device.type == "cuda"


@pytest.mark.gpu
def test_cuda_generic_rollout_matches_cpu(exact_dubins):
    """The generic rollout's first 2 steps on the card (float64, CUDA
    graphs) against the port on the CPU, within 4x the CPU's own move
    under a 1e-15 perturbation of the start (2 draws; or 1e-8).  The cold
    solve (6 outer x 8 inner, from make_batch's start plus a seeded 1e-2)
    leaves every lane below recover_tol, so no lane restarts from the
    recipe's fresh guess: that guess puts rows exactly on their bounds,
    where rounding decides which rows are active (on an NVIDIA H100 one
    such row made the first Newton system differ by 9e4), and a
    rollout through it moves by centimetres between any two
    implementations.  The captures: one step graph and one constraint
    graph for the cold solve's batch and for the rescue's, none at the
    second step; K1's launches, counted by width, at those two widths
    only."""
    cpu = T.BatchedP2PRunner(exact_dubins, dtype=torch.float64,
                             device="cpu",
                             alm_options=T.ALMOptions(**WARM_BUDGET))
    card = cpu.to("cuda")
    starts, goals = _scenarios()
    x0, p0, state = cpu.make_batch(starts, goals)
    x0 = x0 + 1e-2 * torch.as_tensor(
        np.random.default_rng(2).standard_normal(tuple(x0.shape)))
    roll_cpu = cpu.rollout_fn(2, **ROLLOUT)

    def run_cpu(x):
        st = cpu.init_solver_state(x, p0)
        return st, roll_cpu(st, p0, state)[1]
    st_cpu, want = run_cpu(x0)
    assert float(st_cpu.feas_raw.max()) < 0.3     # no lane restarts
    rng = np.random.default_rng(3)
    spread = max(float((run_cpu(x0 * (1 + PERTURB * torch.as_tensor(
        rng.standard_normal(tuple(x0.shape)))))[1] - want).abs().max())
        for _ in range(2))
    before = CapturedCall.captures
    captures = []
    st = card.init_solver_state(x0.cuda(), p0.cuda())
    k1, k1_by = pk.psd_solve.launches, pk.psd_solve.by_systems.copy()
    _, states = card.rollout_fn(2, **ROLLOUT)(
        st, p0.cuda(), state.cuda(),
        on_step=lambda k: captures.append(CapturedCall.captures - before))
    err = float((states.cpu() - want).abs().max())
    assert err <= max(SPREAD_FACTOR * spread, 1e-8), (err, spread)
    assert captures == [4, 4], captures
    by_width = pk.psd_solve.by_systems - k1_by
    assert set(by_width) <= {len(starts), ROLLOUT["rescue_lanes"]}
    assert by_width[len(starts)] > 0, by_width
    assert sum(by_width.values()) == pk.psd_solve.launches - k1, by_width


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ((1024, 190), (256, 190), (4096, 151)),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_cuda_k1_at_the_structures_shapes(cuda_device, shape):
    """K1 at the generic Dubins' Newton systems (1,024 x 190 and the
    rescue's 256 x 190) and the bench scene's dense ones (4,096 x 151),
    float32, against its plain version within 5e-5 of the largest entry."""
    N, n = shape
    assert pk.variant(n, 1, torch.float32) == "block"
    H, G = chip_smoke.spd_inputs(N, n, 1, seed=11, device=cuda_device)
    before, before_N = pk.psd_solve.launches, pk.psd_solve.by_systems[N]
    got = pk.psd_solve(H, G[..., 0].contiguous())
    assert pk.psd_solve.launches == before + 1
    assert pk.psd_solve.by_systems[N] == before_N + 1
    want = pk.psd_solve_plain(H, G[..., 0].contiguous())
    assert float((got - want).abs().max()) <= 5e-5 * float(
        want.abs().max())

"""The port's SchedulerProblem held to the JAX package in float64 on the
CPU, on two scenes of ``chip_smoke.build_vast_scene``: ``scheduler1``
(examples/schedulerproblem_example1.py: shift frames, one local
FreeTPoint2point, n_x 93) and ``scheduler2``
(examples/schedulerproblem_example2.py: two-frame corridors, local
MultiFrameProblems, n_x 186, a slow mover at the corner).  Both packages'
local problems are built on a cut budget (4 outer x 8 inner iterations:
on 1 x 8 the first solve ends infeasible, 0.37, and both packages then
execute the same fresh guess, which would compare no solve).

Tolerances: the frames after ``init`` (borders, goals, member obstacles),
the obstacle slots, the structural signature, the local problem's
parameters (the slots read their live obstacles) and first-frame guess
equal to 1e-12; its f and g at a seeded point to 1e-12 relative; a
forced frame switch (the state placed in the two frames' overlap) gives
the same new frames, problem builds and guess to 1e-12.  Two
``Simulator.update``s of ``scheduler1``: the first solve's inputs equal,
and each update's solution and the simulated state within 4x the largest
move of the JAX package's own first solve over 5 draws of a 1e-15
relative perturbation of its start (tests/test_torch_free_time.py's
rule), or 1e-10 where rounding alone separates them.
"""

import numpy as np
import pytest
import torch

import omg_tools_torch as T
from torch_bench_configs import one_torch_thread  # noqa: F401
from test_torch_multiframe import cut_budget
import chip_smoke

RTOL = 1e-12
BUDGET = {"outer_iter": 4, "inner_iter": 8}
DRAWS = 5
PERTURB = 1e-15
SPREAD_FACTOR = 4.0
ROUNDING_FLOOR = 1e-10
_BUILT = {}


@pytest.fixture(scope="module")
def J():
    """The JAX package (float64)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    return pytest.importorskip("omg_tools_tpu")


def _snapshot(p):
    """What the read-only checks compare, taken right after ``init``."""
    local = p.local_problem
    return {"frames": [(list(f.border), np.array(f.goal), np.array(f.start),
                        _members(f, p.environment)) for f in p.frames],
            "slots": [_slots(p, f) for f in p.frames],
            "signature": p._signature(), "builds": p.cnt_problem_builds,
            "switches": p.cnt_frame_switches,
            "local": type(local).__name__,
            "x": np.array(local._x_result, np.float64),
            "P": np.array(local.pack_parameters(0.0), np.float64)}


def _members(frame, env):
    return ([env.obstacles.index(o) for o in frame.stationary_obstacles],
            [env.obstacles.index(o) for o in frame.moving_obstacles])


def _slots(p, frame):
    """The frame's obstacle slots: per class, an environment obstacle's
    index, or a parked dummy's position and checkpoints."""
    out = []
    for cls, members in sorted(p._frame_slots(frame).items()):
        row = []
        for obs in members:
            if obs in p.environment.obstacles:
                row.append(p.environment.obstacles.index(obs))
            else:
                chck, rad = obs.shape.get_checkpoints()
                row.append((tuple(obs.signals["position"][:, -1]),
                            tuple(np.ravel(chck)), tuple(np.ravel(rad))))
        out.append((cls, row))
    return out


def _pair(J, scene):
    """(JAX scheduler, port scheduler, their snapshots) of a scene, built
    once per module on the cut budget."""
    if scene not in _BUILT:
        out = []
        with cut_budget(J, T, budget=BUDGET):
            for m, options in ((J, {}), (T, {"device": "cpu"})):
                p = chip_smoke.build_scene(m, scene, options)
                p.init()
                out.append(p)
        _BUILT[scene] = (*out, *map(_snapshot, out))
    return _BUILT[scene]


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def _same_snapshot(a, b):
    assert len(a["frames"]) == len(b["frames"])
    for (ba, ga, sa, ma), (bb, gb, sb, mb) in zip(a["frames"], b["frames"]):
        _close(ba, bb)
        _close(ga, gb)
        _close(sa, sb)
        assert ma == mb
    assert len(a["slots"]) == len(b["slots"])
    for sa, sb in zip(a["slots"], b["slots"]):
        assert [c for c, _ in sa] == [c for c, _ in sb]
        for (_, ra), (_, rb) in zip(sa, sb):
            assert len(ra) == len(rb)
            for u, v in zip(ra, rb):
                if isinstance(u, int):
                    assert u == v
                else:
                    for x, y in zip(u, v):
                        _close(x, y)
    for key in ("signature", "builds", "switches", "local"):
        assert a[key] == b[key], key
    _close(a["x"], b["x"])
    _close(a["P"], b["P"])


@pytest.mark.parametrize("scene,n_x,local,n_frames", [
    ("scheduler1", 93, "FreeTPoint2point", 1),
    ("scheduler2", 186, "MultiFrameProblem", 2)])
def test_frames_slots_signature_and_guess_match_jax(J, scene, n_x, local,
                                                    n_frames):
    jp, tp, js, ts = _pair(J, scene)
    _same_snapshot(ts, js)
    assert ts["local"] == local and len(ts["frames"]) == n_frames
    assert tp.local_problem.transcription.n_x == n_x
    assert ts["builds"] == 1


@pytest.mark.parametrize("scene", ["scheduler1", "scheduler2"])
def test_local_transcription_matches_jax(J, scene):
    """The local problem's layout, and its f and g at a seeded point with
    the parameters of its frames' slots."""
    import jax.numpy as jnp
    jp, tp, js, ts = _pair(J, scene)
    a = jp.local_problem.transcription
    b = tp.local_problem.transcription
    assert (a.n_x, a.n_g, a.n_p) == (b.n_x, b.n_g, b.n_p)
    for u, v in zip(a.bounds(0.0), b.bounds(0.0)):
        np.testing.assert_array_equal(v, u)
    x = ts["x"] + 0.1 * np.random.default_rng(0).standard_normal(b.n_x)
    xj, pj = jnp.asarray(x), jnp.asarray(js["P"])
    xt, pt = torch.as_tensor(x), torch.as_tensor(ts["P"])
    _close(b.constraints(xt, pt), a.constraints(xj, pj))
    _close(b.objective(xt, pt), a.objective(xj, pj))
    np.testing.assert_allclose(tp.local_problem._row_scale,
                               jp.local_problem._row_scale, rtol=1e-10)


def test_forced_frame_switch_matches_jax(J):
    """scheduler2 with its state placed in the overlap of its two frames:
    the frames are no longer valid, and the switch (recreated frames from
    the state, the local problem re-targeted or built) gives the same
    frames, builds and hand-down guess."""
    jp, tp, js, ts = _pair(J, "scheduler2")
    ov = tp.frames[0].overlap_with(tp.frames[1])
    assert ov is not None and ov == jp.frames[0].overlap_with(jp.frames[1])
    point = np.array([0.5 * (ov[0] + ov[2]), 0.5 * (ov[1] + ov[3])])
    for p in (jp, tp):
        p.vehicle.prediction["state"][:2] = point
        p.curr_state = point.copy()
        assert not p._check_frames()
        p._shift_frames()
    snaps = [_snapshot(p) for p in (tp, jp)]
    _same_snapshot(*snaps)
    assert snaps[0]["switches"] == ts["switches"] + 1
    assert [f[0] for f in snaps[0]["frames"]] != \
        [f[0] for f in ts["frames"]]


def _recording(solve, calls):
    def run(*args):
        calls.append(tuple(np.array(a, np.float64) for a in args[:4]))
        return solve(*args)
    return run


def test_two_updates_match_jax(J):
    """Two closed-loop updates of scheduler1 (predict, frame checks, the
    local free-time solve, store, simulate) in both packages."""
    import jax.numpy as jnp
    jp, tp, js, ts = _pair(J, "scheduler1")
    jcalls, feas = [], []
    jl = jp.local_problem
    jsolve = jl._jit_solve
    jl._jit_solve = _recording(jsolve, jcalls)
    jl._jit_resolve = jl._jit_reslack = _recording(jl._jit_resolve, jcalls)
    states = []
    with chip_smoke.recorded_solves() as tcalls:
        for p, m in ((jp, J), (tp, T)):
            sim = m.Simulator(p)
            p.initialize(0.0)
            out = []
            for _ in range(2):
                sim.update()
                out.append((np.array(p.local_problem._x_result),
                            np.array(p.vehicle.signals["state"][:, -1])))
                feas.append(p.solver_stats["feas"])
            states.append(out)
    for u, v in zip(tcalls[0][1:5], jcalls[0]):
        _close(u, v)
    x0, P, lb, ub = (jnp.asarray(a) for a in jcalls[0])
    base = np.asarray(jsolve(x0, P, lb, ub).x)
    rng = np.random.default_rng(3)
    spread = max(float(np.abs(np.asarray(jsolve(
        x0 * (1 + PERTURB * rng.standard_normal(x0.shape)), P, lb, ub).x)
        - base).max()) for _ in range(DRAWS))
    tol = max(SPREAD_FACTOR * spread, ROUNDING_FLOOR)
    errs = [(float(np.abs(a[0] - b[0]).max()),
             float(np.abs(a[1] - b[1]).max()))
            for a, b in zip(states[1], states[0])]
    print("two updates: port vs JAX (x, state)", errs, "spread", spread,
          "feas", feas)
    # solved, not fallen back to a fresh guess
    assert max(feas) < 1e-3 and len(jcalls) == len(tcalls) == 2
    for ex, es in errs:
        assert ex <= tol and es <= tol, (errs, spread)
    assert tp.cnt_frame_switches == jp.cnt_frame_switches
    assert tp.cnt_problem_builds == jp.cnt_problem_builds == 1


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


# the replay against the eager step, as for the free-time scenes
# (tests/test_torch_free_time.py): equal to rounding, replays bit for bit
REPLAY_RTOL = 1e-12


@pytest.mark.gpu
def test_cuda_captured_scheduler_step_equals_eager(cuda_device):
    """scheduler2's local problem (n_x 186: K1's block variant) on the
    card: its generic Newton step replayed from a CUDA graph equals the
    eager step, before and after a forced frame switch that re-targets
    the cached problem (new room borders and slot parameters copied into
    the graph's inputs, nothing captured again), one K1 launch a
    replay."""
    from omg_tools_torch.ops import psd_kernels as pk
    from omg_tools_torch.ops.alm import CapturedCall
    p = chip_smoke.build_scene(T, "scheduler2", {"device": "cuda"})
    p.init()
    local = p.local_problem
    tr, solver = local.transcription, local._solver
    assert pk.variant(tr.n_x, 1, torch.float64) == "block"
    dev = dict(dtype=torch.float64, device=cuda_device)
    x = tr.initial_guess() + 1e-2 * np.random.default_rng(5).standard_normal(
        tr.n_x)

    def args():
        return (torch.as_tensor(x, **dev)[None],
                torch.zeros((1, tr.n_g), **dev),
                torch.full((1,), 10.0, **dev),
                *solver.scale_bounds(tr.lb, tr.ub, torch.float64,
                                     cuda_device),
                torch.as_tensor(local.pack_parameters(0.0), **dev)[None])
    graphed = CapturedCall(solver.generic_step, args())
    captures = CapturedCall.captures
    borders = [list(f.border) for f in p.frames]
    for switch in (False, True):
        if switch:
            ov = p.frames[0].overlap_with(p.frames[1])
            point = np.array([0.5 * (ov[0] + ov[2]), 0.5 * (ov[1] + ov[3])])
            p.vehicle.prediction["state"][:2] = point
            p.curr_state = point
            p._shift_frames()
            assert p.local_problem is local and p.cnt_problem_builds == 1
            assert [list(f.border) for f in p.frames] != borders
        a = args()
        eager = solver.generic_step(*a)
        before = pk.psd_solve.launches
        replayed = [t.clone() for t in graphed(*a)]
        again = graphed(*a)
        torch.cuda.synchronize()
        assert pk.psd_solve.launches == before + 2 == \
            before + 2 * graphed.k1_launches
        for u, v, w in zip(eager, replayed, again):
            assert torch.equal(v, w)
            scale = max(1.0, float(u.abs().max()))
            assert float((u - v).abs().max()) <= REPLAY_RTOL * scale
    assert CapturedCall.captures == captures

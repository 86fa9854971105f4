"""The port's reference solver, parity harness and host-tensor cache.

- ``ops.refsolver`` against the JAX package's on small NLPs: the same
  objective within 1e-7, both feasible.  SLSQP follows rounding into
  different iterates, so the two are held by objective value and
  feasibility, not by x;
- one warm solve of the bench scene from a point of the JAX package's
  reference record, held to that record's solution the same way;
- ``tools.parity.openloop_parity`` on the port's float32 runner (the
  fused structure, K3's plain version on the CPU) along the JAX package's
  reference record (tools/parity.py ``cached_reference_rollout``, 12 steps),
  under tests/test_parity.py's gates;
- ``utils.cache``: a store/load round trip, the fingerprint's stability
  across two builds, and float64 storage read back by a float32 runner
  equal, bit for bit, to the uncached build.
"""

import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omg_tools_tpu as J
from omg_tools_tpu.ops.refsolver import make_ref_solver as j_make_ref_solver
from omg_tools_tpu.problems.rollout_models import \
    make_rollout_model as j_make_rollout_model

import omg_tools_torch as T
from omg_tools_torch.ops.refsolver import make_ref_solver
from omg_tools_torch.tools.parity import openloop_parity
from omg_tools_torch.utils import cache

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
sys.path.insert(0, os.path.dirname(__file__))

from parity import cached_reference_rollout  # noqa: E402
import test_torch_alm_modes as nlps  # noqa: E402

N_STEPS = 12
BUDGETS = ((2, 8), (1, 6))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These eager solves are small: torch's intra-op threads only spin
    beside the other test processes.  One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(m):
    """tools/parity.py's build_p2p_holonomic (bench.py's scene)."""
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
    problem.set_options({"verbose": 0, "solver": "alm"})
    problem.init()
    return problem


def _viol(g, x, p, lb, ub):
    gv = np.asarray(g(x, p), np.float64)
    return float(np.max(np.maximum(lb - gv, 0.0) + np.maximum(gv - ub, 0.0),
                        initial=0.0))


@pytest.mark.parametrize("name", ["qp_inequality", "qp_equality",
                                  "box_active_upper", "hs071",
                                  "shutdown_widened_bounds"])
def test_refsolver_matches_jax_on_small_nlps(name):
    n, n_p, f, g, lb, ub, x0, p0 = nlps.GENERIC[name]()
    lb0, ub0 = nlps.BUILD_BOUNDS.get(name, (lb, ub))
    lb, ub = np.asarray(lb, float), np.asarray(ub, float)
    js = j_make_ref_solver(lambda x, p: f(x, p, jnp),
                           lambda x, p: g(x, p, jnp), n, np.asarray(lb0),
                           np.asarray(ub0))
    ts = make_ref_solver(lambda x, p: f(x, p, torch),
                         lambda x, p: g(x, p, torch), n, np.asarray(lb0),
                         np.asarray(ub0))
    x0, p0 = np.asarray(x0, float), np.asarray(p0, float)
    want = js(x0, p0, lb, ub)
    got = ts(x0, p0, lb, ub)
    assert float(got.feas) < 1e-6 and float(want.feas) < 1e-6
    assert float(got.stat) == float(want.stat) == 0.0

    def fval(x):
        return float(f(torch.as_tensor(x), torch.as_tensor(p0), torch))
    assert fval(got.x) == pytest.approx(fval(want.x), rel=1e-7, abs=1e-7)


@pytest.fixture(scope="module")
def jax_scene():
    return _scene(J)


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """The port's float32 bench runner built twice on the CPU into an empty
    private cache: the first build computes the host tensors (and stores
    them), the second reads them back."""
    old = os.environ.get("OMG_CACHE_DIR")
    os.environ["OMG_CACHE_DIR"] = str(tmp_path_factory.mktemp("omg_cache"))
    try:
        built = []
        for _ in range(2):
            problem = _scene(T)
            built.append(T.BatchedP2PRunner(
                problem, dtype=torch.float32, device="cpu",
                alm_options=T.ALMOptions(inner_iter=5)))
        stored = {name: cache.load_tensors(built[0]._cache_key, name)
                  for name in ("scales", "quadQ", "affine_v")}
    finally:
        if old is None:
            os.environ.pop("OMG_CACHE_DIR")
        else:
            os.environ["OMG_CACHE_DIR"] = old
    return built, stored


@pytest.fixture(scope="module")
def jax_record(jax_scene, runners):
    """The JAX package's reference rollout record of the bench scenario
    (tests/test_parity.py's: start (-1.5, -1.5), goal (2, 2), the float32
    runner's x0/p0), from tools/parity.py.  Its harness reads only the
    runner's layout and rollout recipe, which this view supplies without
    the JAX runner's host AD."""
    problem = jax_scene
    tr = problem.transcription
    vehicle = problem.vehicles[0]

    def idx(child, name):
        sl, _ = tr.par_slice(child, name)
        return np.arange(sl.start, sl.stop)
    sl, shape = tr.var_slice(vehicle, "splines_seg0")
    view = types.SimpleNamespace(
        tr=tr, vehicle=vehicle, dtype=jnp.float64,
        horizon=problem.options["horizon_time"], update_time=0.1,
        steps_per_knot=int(round(problem.knot_time / 0.1)),
        shift_M=tr.spline_shift_matrix(lambda b: b.shiftoverknot_T()),
        spline_shape=shape, i_splines=np.arange(sl.start, sl.stop),
        i_t=idx(problem, "t"), _cache_key=tr.fingerprint,
        obstacle_idx=[(idx(o, "x"), idx(o, "v"), idx(o, "a"))
                      for o in problem.environment.obstacles])
    view.model = j_make_rollout_model(view)
    runner = runners[0][0]
    x0, p0, _ = runner.make_batch(np.array([[-1.5, -1.5]]),
                                  np.array([[2.0, 2.0]]))
    x0, p0 = x0[0].double().numpy(), p0[0].double().numpy()
    return x0, p0, cached_reference_rollout(view, x0, p0, N_STEPS)


def test_refsolver_warm_solve_matches_the_jax_record(jax_record, runners):
    """Step 5 of the JAX reference rollout (no knot passage before step
    10, so the record's next warm start is that step's solution): the
    port's reference from the same warm start reaches the same objective
    within 1e-7 and is feasible."""
    _, _, ref = jax_record
    tr = runners[0][0].tr
    k = 5
    x_in, p = ref["x_in"][k], ref["p_in"][k]
    lb, ub = tr.bounds(0.0)
    got = make_ref_solver(tr.objective, tr.constraints, tr.n_x, tr.lb,
                          tr.ub)(x_in, p, lb, ub)
    pt = torch.as_tensor(p)

    def fval(x):
        return float(tr.objective(torch.as_tensor(x), pt))
    want = ref["x_in"][k + 1]
    assert float(got.feas) < 1e-4
    assert _viol(tr.constraints, torch.as_tensor(want), pt, lb, ub) < 1e-4
    assert fval(got.x) == pytest.approx(fval(want), rel=1e-7, abs=1e-7)


def test_openloop_parity_along_the_jax_record(jax_record, runners):
    """The port's open-loop parity (the float32 runner's own fused
    structure, K3's plain version on the CPU) along the JAX package's
    reference record: tests/test_parity.py's gates."""
    x0, p0, ref = jax_record
    runner = runners[0][0]
    assert runner.structure == "compact-arrow-fused"
    res = openloop_parity(runner, x0, p0, N_STEPS, budgets=BUDGETS, ref=ref)
    assert res["ref_feas_max"] < 1e-3
    assert res["openloop_max_err"] < 0.02, res["per_step"]
    assert float(np.percentile(res["per_step"], 90)) < 5e-3, res["per_step"]


def test_cache_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("OMG_CACHE_DIR", str(tmp_path))
    arrays = {"f32": np.arange(3, dtype=np.float32) / 3,
              "idx": np.arange(4, dtype=np.int64),
              "flag": np.asarray(True)}
    path = cache.store_tensors("k", "name", arrays)
    assert os.path.dirname(path) == os.path.join(str(tmp_path), "torch")
    back = cache.load_tensors("k", "name")
    assert back["f32"].dtype == np.float64
    np.testing.assert_array_equal(back["f32"], arrays["f32"])
    assert back["idx"].dtype == np.int64 and bool(back["flag"])
    assert cache.load_tensors("other", "name") is None
    with open(path, "wb") as fh:
        fh.write(b"not an npz")
    assert cache.load_tensors("k", "name") is None


def test_fingerprint_is_stable_across_builds(runners):
    """Two builds of the scene share a key (their problems' transcriptions
    differ as objects only); a moved obstacle changes it."""
    (a, b), _ = runners
    assert a._cache_key == b._cache_key == a.tr.fingerprint
    problem = _scene(T)
    assert cache.problem_fingerprint(problem.transcription,
                                     problem.pack_parameters(0.0)) \
        == a._cache_key
    problem.environment.obstacles[2].signals["position"][:, -1] += 0.1
    assert cache.problem_fingerprint(problem.transcription,
                                     problem.pack_parameters(0.0)) \
        != a._cache_key


def test_cached_float32_runner_equals_the_uncached_build(runners):
    """The host tensors are stored in float64; the runner built from them
    has the uncached runner's host tensors and device consts bit for bit."""
    (fresh, cached), stored = runners
    for name, arrays in stored.items():
        assert arrays is not None, name
        for key, a in arrays.items():
            assert a.dtype in (np.float64, np.int64, np.bool_), (name, key)
    np.testing.assert_array_equal(cached.problem._row_scale,
                                  fresh.problem._row_scale)
    np.testing.assert_array_equal(cached._Q_raw, fresh._Q_raw)
    for key, a in fresh._affine_np.items():
        np.testing.assert_array_equal(cached._affine_np[key], a)
    c1, c2 = fresh.consts(), cached.consts()
    flat1 = torch.utils._pytree.tree_flatten(c1)[0]
    flat2 = torch.utils._pytree.tree_flatten(c2)[0]
    assert len(flat1) == len(flat2)
    for u, v in zip(flat1, flat2):
        if isinstance(u, torch.Tensor):
            assert u.dtype == v.dtype and torch.equal(u, v)
        elif isinstance(u, np.ndarray):
            np.testing.assert_array_equal(u, v)
        else:
            assert u == v

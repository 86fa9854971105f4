"""Shared tests of the port's batched runner on one of bench.py's
configurations beyond p2p_holonomic, held to the JAX package in float64
on the CPU.  A test module sets ``CONFIG`` ("p2p_3dquadrotor" or
"p2p_dubins") and imports everything from here; the fixtures read
``CONFIG`` from the requesting module.

Both packages build the scene of ``chip_smoke.build_problem`` (bench.py's,
letter for letter) and a float64 runner with bench.py's ALM options
(inner_iter 5, rho_init 10).  The port's float32 runner shares the port's
host-tensor cache (float64, so it pays no second host AD); the JAX runner
computes its host tensors into a private cache directory.

Tolerances: f and g agree to rtol 1e-12; the host AD tensors to 1e-10 of
each tensor's largest entry; make_batch exactly; the rollout recipes to
1e-12; solves to x 1e-8 and feasibility 1e-9 over a cut budget; rollouts
to 1e-8 m per state; K3's compressed tables exactly and their products to
1e-12; the emulated kernel and the plain K3 to 1e-9.

Cold solves are compared from make_batch's start perturbed by a seeded
1e-2 noise.  At make_batch's start itself some rows sit exactly on a
bound (straight-line guesses, zero lifts;
test_make_batch_start_puts_rows_on_their_bounds), where the multiplier
estimate's activity test switches, so that rounding decides the first
Gauss-Newton step's active set and two implementations that sum in
another order take other steps.

JAX and the JAX package are imported inside fixtures, so that the ``gpu``
tests also collect where JAX is not installed:

    python -m pytest tests/test_torch_p2p_3dquadrotor.py \\
        tests/test_torch_p2p_dubins.py -m gpu --noconftest -q
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

import omg_tools_torch as T
from omg_tools_torch.ops import fused_alm as fa
from omg_tools_torch.ops.alm import make_alm_solver
from omg_tools_torch.ops.compact import resolve_phase

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
import chip_smoke  # noqa: E402  the bench scenes and the curvature check

B = 4
N_STEPS = 11        # covers the knot-passage (hard budget) step at k = 10
HOST_RTOL = 1e-10
CUT = dict(outer_iter=2, inner_iter=5)      # the cut budget of cold solves
START_NOISE = 1e-2
# the arrow partition and K3's compressed sizes of each plan
PLANS = {
    "p2p_3dquadrotor": dict(n_x=128, m=568, head=42, blocks=[44, 14, 14, 14],
                            n_j=5120, values=27256, desc=126560,
                            smem_one_lane=53424, lanes_at_4096=2),
    "p2p_dubins": dict(n_x=171, m=597, head=54, blocks=[43, 33, 14, 14, 13],
                       n_j=4896, values=18212, desc=91372,
                       smem_one_lane=68912, lanes_at_4096=1),
}
# lanes of the curvature check on the CPU: where d'Q d decides the step on
# a few lanes in a hundred (the quadrotor), 64; on most (Dubins), 8
CURVATURE_LANES = {"p2p_3dquadrotor": 64, "p2p_dubins": 8}


def _rollout_options(config, rescue_lanes=2):
    """bench.py's rollout settings of ``config`` (chip_smoke.CONFIGS) with
    a rescue of ``rescue_lanes`` lanes, as B is small here."""
    return dict(chip_smoke.CONFIGS[config]["rollout"],
                rescue_lanes=rescue_lanes)


def _close(got, want, rtol=HOST_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _strip(label):
    return re.sub(r"\d+$", "", label)


def _layout_rows(layout, table):
    """(label, name, offset, shape) of a layout table, every object label
    stripped of its instance number (other test files build objects too)."""
    labels = sorted({lbl for t in ("variables", "parameters")
                     for (lbl, _) in getattr(layout, t)}, key=len,
                    reverse=True)

    def norm(name):
        for lbl in labels:
            name = name.replace(lbl, _strip(lbl))
        return name
    return [(_strip(lbl), norm(name), blk.offset, tuple(blk.shape))
            for (lbl, name), blk in getattr(layout, table).items()]


def jax_compiled(problem):
    """A JAX package problem, initialised, with its transcription's
    constraints and objective compiled by ``jax.jit``: the same functions,
    traced once instead of replayed op by op at every later call (host AD,
    solver traces, evaluations), where a replay of these scenes takes
    seconds.  Returns the problem."""
    import jax
    tr = problem.transcription
    tr.constraints = jax.jit(tr.constraints)
    tr.objective = jax.jit(tr.objective)
    return problem


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These eager solves are small: torch's intra-op threads only spin
    beside the other test processes.  One thread for this module.  (The
    name has no leading underscore, so that the configuration modules'
    ``from torch_bench_configs import *`` takes this fixture too.)"""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def config(request):
    return request.module.CONFIG


@pytest.fixture(scope="module")
def port(config, tmp_path_factory):
    """(problem, float64 runner, float32 runner) of the port on the CPU,
    on one private host-tensor cache."""
    old = os.environ.get("OMG_CACHE_DIR")
    os.environ["OMG_CACHE_DIR"] = str(tmp_path_factory.mktemp("omg_cache"))
    try:
        tp = chip_smoke.build_problem(T, config)
        opt = T.ALMOptions(inner_iter=chip_smoke.INNER_ITER, rho_init=10.0)
        r64 = T.BatchedP2PRunner(tp, dtype=torch.float64, alm_options=opt,
                                 device="cpu")
        r32 = T.BatchedP2PRunner(tp, dtype=torch.float32, alm_options=opt,
                                 device="cpu")
    finally:
        if old is None:
            os.environ.pop("OMG_CACHE_DIR")
        else:
            os.environ["OMG_CACHE_DIR"] = old
    return tp, r64, r32


@pytest.fixture(scope="module")
def jax_pair(config, tmp_path_factory):
    """(JAX problem, JAX float64 runner) on a private cache."""
    import jax.numpy as jnp
    import omg_tools_tpu as J
    from omg_tools_tpu.ops.alm import ALMOptions as JALMOptions
    from omg_tools_tpu.problems.batch import BatchedP2PRunner as JRunner
    old = os.environ.get("OMG_CACHE_DIR")
    os.environ["OMG_CACHE_DIR"] = str(tmp_path_factory.mktemp("jax_cache"))
    try:
        jp = jax_compiled(chip_smoke.build_problem(J, config))
        jr = JRunner(jp, dtype=jnp.float64, alm_options=JALMOptions(
            inner_iter=chip_smoke.INNER_ITER, rho_init=10.0))
    finally:
        if old is None:
            os.environ.pop("OMG_CACHE_DIR")
        else:
            os.environ["OMG_CACHE_DIR"] = old
    return jp, jr


@pytest.fixture(scope="module")
def scen(config):
    return chip_smoke.scenarios(B, config)


@pytest.fixture(scope="module")
def batch(port, scen):
    return port[1].make_batch(*scen)


@pytest.fixture(scope="module")
def plan(port):
    """K3's plan of the configuration (the float32 runner's)."""
    return port[2].fused_plan


# -- transcription and host tensors ---------------------------------------------

def test_transcription_layout(port, jax_pair):
    a, b = jax_pair[0].transcription, port[0].transcription
    assert (a.n_x, a.n_p, a.n_g) == (b.n_x, b.n_p, b.n_g)
    for table in ("variables", "parameters"):
        assert _layout_rows(a.layout, table) == \
            _layout_rows(b.layout, table), table
    assert [(c.offset, c.rows) for c in a.layout.constraints] == \
        [(c.offset, c.rows) for c in b.layout.constraints]


@pytest.mark.parametrize("seed", [0, 1])
def test_objective_constraints_bounds(port, jax_pair, seed):
    import jax.numpy as jnp
    jp, tp = jax_pair[0], port[0]
    a, b = jp.transcription, tp.transcription
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(a.n_x) * 0.3
    p = jp.pack_parameters(0.0) + rng.standard_normal(a.n_p) * 0.05
    want = np.asarray(a.constraints(jnp.asarray(x), jnp.asarray(p)))
    np.testing.assert_allclose(
        b.constraints(torch.as_tensor(x), torch.as_tensor(p)).numpy(), want,
        rtol=1e-12, atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(
        float(b.objective(torch.as_tensor(x), torch.as_tensor(p))),
        float(a.objective(jnp.asarray(x), jnp.asarray(p))), rtol=1e-12)
    for t in (0.0, 0.1 * seed):
        for u, v in zip(a.bounds(t), b.bounds(t)):
            np.testing.assert_array_equal(v, u)


def test_host_ad_tensors(port, jax_pair):
    jp, jr = jax_pair
    tp, tr = port[0], port[1]
    _close(tp._row_scale, jp._row_scale)
    assert tp._obj_scale == pytest.approx(jp._obj_scale, rel=1e-12)
    _close(tr._Q_raw, jr._Q_raw)
    for key in ("c0", "C1", "A0", "TA", "f0", "gf"):
        _close(tr._affine_np[key], jr._affine_np[key])
    np.testing.assert_array_equal(tr._affine_np["vsel"],
                                  jr._affine_np["vsel"])


def test_compact_structure_and_arrow(port, jax_pair, config):
    """Families, row order and the arrow partition equal the JAX
    package's; the head and tail blocks are the ones K3 was sized for."""
    a, b = jax_pair[1].compact, port[1].compact
    assert [tuple(f) for f in a.families] == [tuple(f) for f in b.families]
    np.testing.assert_array_equal(a.row_perm, b.row_perm)
    assert tuple(a.arrow) == tuple(b.arrow)
    want = PLANS[config]
    assert b.arrow.head == (0, want["head"])
    assert [sz for _, sz in b.arrow.blocks] == want["blocks"]
    for key in ("c0", "C1", "f0", "gf"):
        _close(b.tensors[key], a.tensors[key])
    for key in ("A0c", "TAc", "Qc"):
        for u, v in zip(a.tensors[key], b.tensors[key]):
            assert (u is None) == (v is None)
            if u is not None:
                _close(v, u)


def test_structure_gate(port, jax_pair, config):
    """float64 runners take compact-arrow in both packages; the port's
    float32 runner takes compact-arrow-fused, since K3 takes the plan
    (where the JAX package's TPU VMEM gate keeps compact-arrow), and says
    why."""
    _, r64, r32 = port
    assert jax_pair[1].structure == r64.structure == "compact-arrow"
    assert "float64" in r64.structure_reason
    assert r32.structure == "compact-arrow-fused"
    assert r32.structure_reason.startswith("K3 takes the plan")
    assert r32.fused_plan.kernel_refusal() is None
    assert r32.fused_plan.head == r64.compact.arrow.head


def test_fused_plan_sizes(plan, config):
    """The plan's compressed sizes and K3's lanes a block at B = 4096 on
    the card's 132 SMs."""
    want = PLANS[config]
    assert (plan.n_x, plan.m, plan.n_j, plan.values_len) == (
        want["n_x"], want["m"], want["n_j"], want["values"])
    assert plan.descriptor().size == want["desc"]
    assert plan.smem_bytes(1) == want["smem_one_lane"]
    assert fa.lanes_per_block(4096, 132, plan.smem_bytes) == \
        want["lanes_at_4096"]


def test_make_batch(port, jax_pair, scen):
    x0, p0, state = port[1].make_batch(*scen)
    jx0, jp0, jstate = jax_pair[1].make_batch(*scen)
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jx0))
    np.testing.assert_array_equal(p0.numpy(), np.asarray(jp0))
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))


# -- the rollout recipe ----------------------------------------------------------

def _recipe_inputs(r64, seed=0):
    rng = np.random.default_rng(seed)
    n_coef, n_spl = r64.spline_shape
    p = np.tile(r64.problem.pack_parameters(0.0), (B, 1)) \
        + 0.1 * rng.standard_normal((B, r64.n_p))
    cfs = rng.standard_normal((B, n_coef, n_spl))
    return p, cfs


def test_recipe_batch_params_and_guesses(port, jax_pair, scen):
    m_t, m_j = port[1].model, jax_pair[1].model
    starts, goals = scen
    p0 = np.tile(port[1].problem.pack_parameters(0.0), (B, 1))
    _close(m_t.batch_params(p0.copy(), starts, goals),
           m_j.batch_params(p0.copy(), starts, goals), rtol=1e-12)
    n_coef = port[1].spline_shape[0]
    _close(m_t.init_guess(starts, goals, n_coef),
           m_j.init_guess(starts, goals, n_coef), rtol=1e-12)
    assert [list(i) for i in m_t.varying_params()] == \
        [list(i) for i in m_j.varying_params()]


def test_recipe_reset_guess(port, jax_pair, scen):
    import jax
    import jax.numpy as jnp
    m_t, m_j = port[1].model, jax_pair[1].model
    rng = np.random.default_rng(1)
    dim = len(port[1].i_poseT)
    state = rng.standard_normal((B, dim))
    goal = rng.standard_normal((B, dim))
    n_coef = port[1].spline_shape[0]
    got = m_t.reset_guess(torch.as_tensor(state), torch.as_tensor(goal),
                          n_coef, torch.float64)
    want = jax.vmap(lambda s, g: m_j.reset_guess(s, g, n_coef, jnp.float64))(
        jnp.asarray(state), jnp.asarray(goal))
    _close(got.numpy(), np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("row", [1, 5, 10])
def test_recipe_update(port, jax_pair, row):
    """The ideal plant update of seeded parameters and splines at sample
    instant ``row``: the new parameters and the returned state."""
    import jax
    import jax.numpy as jnp
    r64 = port[1]
    m_t, m_j = r64.model, jax_pair[1].model
    p, cfs = _recipe_inputs(r64, seed=row)
    got_p, got_s = m_t.update(torch.as_tensor(p), torch.as_tensor(cfs), row,
                              r64.horizon)
    want_p, want_s = jax.vmap(lambda a, c: m_j.update(a, c, row,
                                                      r64.horizon))(
        jnp.asarray(p), jnp.asarray(cfs))
    _close(got_p.numpy(), np.asarray(want_p), rtol=1e-12)
    _close(got_s.numpy(), np.asarray(want_s), rtol=1e-12)


# -- solves and rollouts ---------------------------------------------------------

def _noisy_start(x0):
    rng = np.random.default_rng(5)
    return x0.numpy() + START_NOISE * rng.standard_normal(tuple(x0.shape))


def test_make_batch_start_puts_rows_on_their_bounds(port, batch):
    """Why the cold solves here start off make_batch's start: there some
    inequality rows of g sit exactly on a bound; the moved start has
    none on one."""
    r = port[1]
    x0, p0, _ = batch
    lb, ub = r.tr.bounds(0.0)

    def on_bound(x):
        g = np.stack([r.tr.constraints(torch.as_tensor(xb), p0[b]).numpy()
                      for b, xb in enumerate(x)])
        return int((((g == lb) | (g == ub)) & (lb != ub)).sum())
    assert on_bound(x0.numpy()) > 0
    assert on_bound(_noisy_start(x0)) == 0


def test_cold_solve_cut_budget(port, jax_pair, batch):
    """A cold solve of the B lanes (phase 0) on the cut budget, from
    make_batch's start moved off its bounds (module docstring): x within
    1e-8, feasibility within 1e-9."""
    import jax
    import jax.numpy as jnp
    from omg_tools_tpu.ops.alm import ALMOptions as JALMOptions
    from omg_tools_tpu.ops.compact import resolve_phase as j_resolve_phase
    jr, tr = jax_pair[1], port[1]
    x0, p0, _ = batch
    xs = _noisy_start(x0)
    opt = dict(CUT, rho_init=10.0)
    ts = tr.make_solver(T.ALMOptions(**opt))
    C = tr.consts()
    st = ts(torch.as_tensor(xs), p0, C.lb, C.ub,
            ct=resolve_phase(tr.compact, C.CT, 0, p0))
    js = jr.make_solver(JALMOptions(**opt))
    Cj = jr.consts()
    want = jax.jit(jax.vmap(lambda x, p: js(
        x, p, Cj.lb, Cj.ub, ct=j_resolve_phase(jr.compact, Cj.CT, 0, p))))(
            jnp.asarray(xs), jnp.asarray(p0.numpy()))
    np.testing.assert_allclose(st.x.numpy(), np.asarray(want.x), atol=1e-8)
    np.testing.assert_allclose(st.feas.numpy(), np.asarray(want.feas),
                               atol=1e-9)
    np.testing.assert_array_equal(st.n_iter.numpy(), np.asarray(want.n_iter))


def test_rollout_matches_jax(port, jax_pair, batch, config):
    """An 11-step float64 rollout at bench.py's recovery settings for the
    configuration (its metric and tolerances) from the port's cold-solve
    state, in both packages: every state within 1e-8 m, the final x
    within 1e-7.  One budget (bench.py's 2 outer rounds of the runner's 5
    inner iterations) and no rescue: with bench.py's two budgets and its
    rescue the JAX package compiles three solvers, minutes on a CPU; the
    budgets' switch and the rescue are held to the JAX package on the
    holonomic bench in tests/test_torch_main_path.py."""
    import jax
    import jax.numpy as jnp
    from omg_tools_tpu.ops.alm import ALMState as JState
    jr, tr = jax_pair[1], port[1]
    x0, p0, state = batch
    st = tr.init_solver_state(x0, p0)
    kw = dict(_rollout_options(config, rescue_lanes=0), budgets=None)
    carry, states = tr.rollout_fn(N_STEPS, **kw)(st, p0, state)
    assert states.shape == (B, N_STEPS, len(tr.i_poseT))
    jst = JState(*(jnp.asarray(a.numpy()) for a in st))
    jcarry, jstates = jax.jit(jr.rollout_fn(N_STEPS, **kw))(
        jst, jnp.asarray(p0.numpy()), jnp.asarray(state.numpy()),
        jr.consts())
    np.testing.assert_allclose(states.numpy(), np.asarray(jstates),
                               atol=1e-8)
    np.testing.assert_allclose(carry[0].x.numpy(), np.asarray(jcarry[0].x),
                               atol=1e-7)


def test_recover_metric_is_checked(port):
    with pytest.raises(ValueError, match="recover_metric"):
        port[1].rollout_fn(1, recover_metric="scaled_raw")


# -- K3 on this plan (CPU side) -------------------------------------------------

@pytest.mark.parametrize("phase", [0, 7])
def test_compressed_tables_scatter_back(plan, phase):
    """One phase's compressed values, put back where the descriptor's
    indices say, rebuild the plan's dense tables exactly
    (tests/test_torch_fused.py's check on this plan)."""
    from test_torch_fused import (_Desc, _family_of_row, _local_cols)
    D = _Desc(plan.descriptor(), plan.phase_values(phase))
    A = D.arr
    fam = _family_of_row(plan)
    locs = [_local_cols(f) for f in plan.fams]
    dense_A = [np.zeros_like(a[phase]) for a in plan.uA]
    dense_T = [np.zeros_like(a[phase]) for a in plan.uTA]
    dense_Q = [np.zeros_like(q) for q in plan.uQ]
    dense_C = np.zeros_like(plan.C1[phase])
    for r in range(plan.m):
        f = plan.fams[fam[r]]
        i, loc = r - f.row_start, locs[fam[r]]
        for p in D.entries(fa.O_ROFF, fa.O_RLEN, r):
            j = loc[int(A[fa.O_COL][p])]
            dense_A[f.iA][i, j] = D.val[fa.V_A][p]
            for k in D.entries(fa.O_TOFF, fa.O_TLEN, p):
                q = f.qpos.index(int(A[fa.O_TIDX][k]))
                dense_T[f.iTA][i, j, q] = D.val[fa.V_T][k]
            for k in D.entries(fa.O_QOFF, fa.O_QLEN, p):
                dense_Q[f.iQ][i * len(loc) + j, loc[int(A[fa.O_QIDX][k])]] \
                    = D.val[fa.V_Q][k]
        for k in D.entries(fa.O_COFF, fa.O_CLEN, r):
            dense_C[r, A[fa.O_CIDX][k]] = D.val[fa.V_C][k]
    for got, want in zip(dense_A, plan.uA):
        np.testing.assert_array_equal(got, want[phase])
    for got, want in zip(dense_T, plan.uTA):
        np.testing.assert_array_equal(got, want[phase])
    for got, want in zip(dense_Q, plan.uQ):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(dense_C, plan.C1[phase])
    np.testing.assert_array_equal(D.val[fa.V_C0], plan.c0[phase])
    np.testing.assert_array_equal(D.val[fa.V_GF], plan.gf[phase])


def test_gauss_newton_lists_reproduce_jtdj(plan):
    """The gradient and Gauss-Newton pair lists, applied to random J
    values on J's pattern, give J'y and J' diag(d) J where
    fused_inner_plain puts them, over unequal tail blocks."""
    from test_torch_fused import (_Desc, _family_of_row, _local_cols,
                                  _lists_into_arrow, _tri)
    D = _Desc(plan.descriptor(), plan.phase_values(0))
    rng = np.random.default_rng(7)
    rho = 10.0
    y = rng.normal(size=plan.m) * (rng.uniform(size=plan.m) > 1 / 3)
    J = np.zeros(D.nJ)
    fam = _family_of_row(plan)
    dense = [np.zeros((f.row_stop - f.row_start, len(_local_cols(f))))
             for f in plan.fams]
    for r in range(plan.m):
        f = plan.fams[fam[r]]
        loc = _local_cols(f)
        for p in D.entries(fa.O_ROFF, fa.O_RLEN, r):
            J[p] = rng.normal()
            dense[fam[r]][r - f.row_start, loc[int(D.arr[fa.O_COL][p])]] = \
                J[p]
    grad, ar = _lists_into_arrow(D, J, y, rho)
    h = plan.head[1]
    t = lambda a: torch.as_tensor(a)[None]  # noqa: E731
    g_want = torch.zeros((1, plan.n_x), dtype=torch.float64)
    S = torch.zeros((1, h, h), dtype=torch.float64)
    Ds = [torch.zeros((1, sz, sz), dtype=torch.float64)
          for _, sz in plan.blocks]
    Ms = [torch.zeros((1, sz, h + 2), dtype=torch.float64)
          for _, sz in plan.blocks]
    for f, Jf in zip(plan.fams, dense):
        yf = y[f.row_start:f.row_stop]
        d = np.where(np.abs(yf) > 0, rho, 0.0)
        fa._scatter(plan, f, t(yf @ Jf), t((Jf * d[:, None]).T @ Jf),
                    g_want, S, Ds, Ms)
    np.testing.assert_allclose(grad, g_want[0].numpy(), rtol=1e-12,
                               atol=1e-12)
    want = np.zeros_like(ar)
    want[:_tri(h)] = S[0].numpy()[np.tril_indices(h)]
    for r, Dm, Mb in zip(D.blk, Ds, Ms):
        sz = int(r[fa.B_SIZE])
        want[r[fa.B_D]:r[fa.B_D] + _tri(sz)] = \
            Dm[0].numpy()[np.tril_indices(sz)]
        want[r[fa.B_M]:r[fa.B_M] + sz * (h + 2)] = Mb[0].numpy().ravel()
    np.testing.assert_allclose(ar, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def _k3_inputs(r, x0, p0, lanes, dtype=torch.float64):
    plan = r.fused_plan
    lb, ub = r.solver.scale_bounds(r.lb, r.ub, dtype, "cpu")
    lam = torch.zeros((lanes, plan.m), dtype=dtype)
    lam[-1] = torch.as_tensor(np.random.default_rng(3).normal(size=plan.m))
    return dict(x=x0[:lanes].to(dtype), lam=lam,
                rho=torch.tensor([10.0, 30.0][:lanes], dtype=dtype),
                pv=p0[:lanes, torch.as_tensor(plan.pcols)].to(dtype),
                lb=lb, ub=ub)


def test_compressed_kernel_emulation_matches_plain(port, batch):
    """The kernel's phases (P1-P10 of csrc/fused_alm.cu) emulated in numpy
    on this plan's compressed tables agree with fused_inner_plain on the
    dense ones: 2 lanes (one with non-zero multipliers), 2 iterations,
    phase 3, float64, to 1e-9 of each output's scale."""
    from test_torch_fused import _Desc, _emulate_kernel
    r = port[2]
    plan = r.fused_plan
    x0, p0, _ = batch
    fs = fa.FusedPlan.slice_phase(plan.shared(torch.float64, "cpu"), 3)
    a = _k3_inputs(r, x0, p0, 2)
    opt = T.ALMOptions()
    want = fa.fused_inner_plain(plan, fs, a["x"], a["lam"], a["rho"],
                                a["pv"], a["lb"], a["ub"], opt, 2)
    got = _emulate_kernel(_Desc(fs["desc_host"], fs["vals"].numpy()),
                          *(a[k].numpy() for k in ("x", "lam", "rho", "pv",
                                                   "lb", "ub")), opt, 2)
    for g, w in zip(got, want):
        _close(g, w.numpy(), rtol=1e-9)


def test_plain_k3_matches_compact_arrow(port, batch):
    """The plain K3 (the fused solver) against the port's compact-arrow
    solve on the same plan, which test_cold_solve_cut_budget holds to the
    JAX package: a cold solve on the cut budget from the noisy start, x
    within 1e-8 and feasibility within 1e-9 (float64)."""
    _, r64, _ = port
    x0, p0, _ = batch
    xs = torch.as_tensor(_noisy_start(x0))
    C = r64.consts()
    opt = T.ALMOptions(**CUT, rho_init=10.0)
    st_c = r64.make_solver(opt)(xs, p0, C.lb, C.ub,
                                ct=resolve_phase(r64.compact, C.CT, 0, p0))
    plan = fa.FusedPlan(r64.compact)
    fused = make_alm_solver(
        r64.tr.objective, r64.tr.constraints, r64.tr.n_x, r64.tr.lb,
        r64.tr.ub, opt, row_scale=r64.problem._row_scale,
        obj_scale=r64.problem._obj_scale, compact=r64.compact,
        fused_plan=plan)
    fs = fa.FusedPlan.slice_phase(plan.shared(torch.float64, "cpu"), 0)
    st_f = fused(xs, p0, C.lb, C.ub, fshared=fs)
    np.testing.assert_allclose(st_f.x.numpy(), st_c.x.numpy(), atol=1e-8)
    np.testing.assert_allclose(st_f.feas.numpy(), st_c.feas.numpy(),
                               atol=1e-9)


def test_jax_structure_q_is_symmetrized_not_refused(jax_pair):
    """The JAX package's compact structure (its quad families' Q detected
    by AD, symmetric to rounding only) builds the port's plan: the plan
    holds 0.5 (Q + Q'), and only an asymmetry beyond rounding is refused."""
    from omg_tools_torch.interop import compact_from_numpy
    c = jax_pair[1].compact
    struct = compact_from_numpy(c.families, c.row_perm, c.tensors, c.n_x,
                                c.n_p, c.arrow)
    plan = fa.FusedPlan(struct)
    for f in plan.fams:
        if f.iQ >= 0:
            m_f = f.row_stop - f.row_start
            Q = plan.uQ[f.iQ].reshape(m_f, -1, plan.uQ[f.iQ].shape[1])
            np.testing.assert_array_equal(Q, Q.transpose(0, 2, 1))
    quad = next(i for i, q in enumerate(struct.tensors["Qc"])
                if q is not None)
    Qc = np.array(struct.tensors["Qc"][quad])
    Qc[0, 0, 1] += 1e-6 * np.abs(Qc).max()
    struct.tensors["Qc"] = list(struct.tensors["Qc"])
    struct.tensors["Qc"][quad] = Qc
    with pytest.raises(ValueError, match="not symmetric"):
        fa.FusedPlan(struct)


def test_curvature_check_sees_dqd(port, config):
    """The K3 check that sees the line search's d'Q d term
    (chip_smoke.k3_curvature_errors): on CURVATURE_LANES of the bench
    scenarios, a plain K3 blind to that term fails it on at least one lane
    that float32 resolves; the plain version itself passes it."""
    r = port[2]
    starts, goals = chip_smoke.scenarios(CURVATURE_LANES[config], config)
    x0, p0, _ = r.make_batch(starts, goals)
    e = chip_smoke.k3_curvature_errors(r, r.consts(), x0, p0,
                                       fa.fused_inner_plain)
    res = e["resolved"]
    assert int(res.sum()) > 0
    assert float(e["kernel"][res].max()) == 0.0
    assert int((e["blind"][res] > chip_smoke.K3_TOL_DX).sum()) > 0


# -- on the card ----------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 runs on the card only")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_runner(port, card, config):
    """The float32 fused runner on the card and 1031 bench scenarios."""
    r = port[2].to(card)
    return r, r.make_batch(*chip_smoke.scenarios(1031, config))


@pytest.mark.gpu
@pytest.mark.parametrize("B,n_inner", [(256, 8), (257, 8), (1031, 10),
                                       (128, 5), (256, 5)])
def test_cuda_k3_matches_plain(card_runner, config, B, n_inner):
    """K3 on this plan against its plain float32 version with the
    well-conditioned ridge (chip_smoke's first K3 check and its
    tolerances), at the widths the gate's lane counts take, odd ones
    included, and the rescue's.  Dubins: from make_batch's start moved off
    its bounds (as chip_smoke does), g held to g at the kernel's own x,
    and the step and gradient norm to float64 on as many lanes as the
    plain float32 version meets them."""
    r, (x0, p0, _) = card_runner
    noise = chip_smoke.CONFIGS[config].get("k3_start_noise", 0.0)
    x0 = x0 + noise * torch.as_tensor(
        np.random.default_rng(5).standard_normal(tuple(x0.shape)),
        dtype=x0.dtype, device=x0.device)
    plan = r.fused_plan
    opt = r.solver.options._replace(gn_delta_rel=chip_smoke.K3_WELL_RIDGE)
    fs = fa.FusedPlan.slice_phase(r.consts().FS, 0)
    lb, ub = r.solver.scale_bounds(r.lb, r.ub, torch.float32, x0.device)
    a = (x0[:B].contiguous(), torch.zeros((B, plan.m), device=x0.device),
         torch.full((B,), opt.rho_init, device=x0.device),
         p0[:B, torch.as_tensor(plan.pcols, device=x0.device)].contiguous(),
         lb, ub)
    before = fa.fused_inner.launches
    kw = fa.fused_inner(plan, fs, *a, opt, n_inner)
    pw = fa.fused_inner_plain(plan, fs, *a, opt, n_inner)
    assert fa.fused_inner.launches == before + 1
    assert all(bool(torch.isfinite(t).all()) for t in kw)
    if chip_smoke.CONFIGS[config].get("k3_well_quantile") is None:
        e_dx = float((kw[0] - pw[0]).abs().max()
                     / (pw[0] - a[0]).abs().max())
        e_gv = float((kw[1] - pw[1]).abs().max() / pw[1].abs().max())
        e_st = float(((kw[2] - pw[2]).abs() / pw[2].abs()).max())
        assert e_dx <= chip_smoke.K3_TOL_DX and e_gv <= chip_smoke.K3_TOL_GV \
            and e_st <= chip_smoke.K3_TOL_STAT, (e_dx, e_gv, e_st)
        return
    # Dubins: g against g at the kernel's own x in float64, every lane;
    # the step and gradient norm against float64 on as many lanes as the
    # plain float32 version (a few more at most: B / 100, at least 2),
    # since at these widths a quantile of 0.99 is a lane or two, where
    # float32 may not resolve an activity switch
    fs64 = dict(fs, tables=fs["tables"].double())
    a64 = tuple(t.double() for t in a)
    g_own = fa.fused_inner_plain(plan, fs64, kw[0].double(), *a64[1:],
                                 opt._replace(ls_candidates=(0.0,)), 1)[1]
    e_gv = float((kw[1].double() - g_own).abs().max() / g_own.abs().max())
    assert e_gv <= chip_smoke.K3_TOL_GV, e_gv
    p64 = fa.fused_inner_plain(plan, fs64, *a64, opt, n_inner)
    step = (p64[0] - a64[0]).abs().max()

    def off(out):
        e_x = (out[0].double() - p64[0]).abs().amax(-1) / step
        e_s = (out[2].double() - p64[2]).abs() / p64[2].abs()
        return int(((e_x > chip_smoke.K3_TOL_DX)
                    | (e_s > chip_smoke.K3_TOL_STAT)).sum())
    assert off(kw) <= off(pw) + max(2, B // 100), (off(kw), off(pw))


@pytest.mark.gpu
def test_cuda_smem_matches_python(card_runner):
    r, _ = card_runner
    plan = r.fused_plan
    desc = r.consts().FS["desc_host"]
    for lanes in (1, 2):
        assert fa.kernel_smem_bytes(desc, lanes) == plan.smem_bytes(lanes)


@pytest.mark.gpu
def test_cuda_k3_curvature_check(card_runner):
    """The curvature check on the card (chip_smoke.k3_curvature_check's
    rule): on 1031 lanes the plain version blind to d'Q d leaves the plain
    step on some lanes that float32 resolves, the kernel on at most a
    quarter as many."""
    r, (x0, p0, _) = card_runner
    e = chip_smoke.k3_curvature_errors(r, r.consts(), x0, p0, fa.fused_inner)
    res = e["resolved"]
    assert e["finite"] and int(res.sum()) > 0
    blind = int((e["blind"][res] > chip_smoke.K3_TOL_DX).sum())
    kernel = int((e["kernel"][res] > chip_smoke.K3_TOL_DX).sum())
    assert blind > 0 and kernel <= chip_smoke.K3_CURV_RATIO * blind, \
        (kernel, blind)


@pytest.mark.gpu
def test_cuda_fused_rollout_matches_cpu(port, card, config):
    """Three steps of the fused rollout at bench.py's settings on the card
    (K3) against the same float32 runner on the CPU (the plain K3): the
    planned states within bench.py's 2 cm parity bound."""
    r_cpu = port[2]
    r_card = r_cpu.to(card)
    starts, goals = chip_smoke.scenarios(64, config)
    out = []
    for r in (r_cpu, r_card):
        x0, p0, state = r.make_batch(starts, goals)
        st = r.init_solver_state(x0, p0)
        _, states = r.rollout_fn(3, **_rollout_options(config, 8))(
            st, p0, state)
        out.append(states.double().cpu().numpy())
    assert np.isfinite(out[1]).all()
    assert np.abs(out[1] - out[0]).max() < chip_smoke.PARITY_GATE_M

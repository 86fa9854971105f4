"""K3, the torch port's fused ALM inner loop
(omg_tools_torch/ops/fused_alm.py), held to the JAX package's fused path on
the bench scene.

Both packages build the bench scene (bench.py's p2p_holonomic) in float64
on the CPU; both runners get a FusedPlan forced onto them, as
tests/test_fused_alm.py forces it onto the JAX runner.  The port's plan
must equal the JAX plan (structure exactly, tables to 1e-10 of each table's
scale); its plain K3 must agree with the JAX Pallas kernel in interpret
mode, and its fused rollout with the JAX runner's fused path, to the
tolerances of tests/test_fused_alm.py (x 1e-8, feasibility 1e-9) and
1e-8 m per rollout state.

JAX is imported inside fixtures, so that the ``gpu`` tests (the CUDA
kernel against its plain version, on the card) also collect where JAX is
not installed:

    python -m pytest tests/test_torch_fused.py -m gpu --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

import omg_tools_torch as T
from omg_tools_torch.ops import fused_alm as fa
from omg_tools_torch.ops.compact import resolve_phase

pytestmark = pytest.mark.fast

B = 4
N_STEPS = 11        # covers the knot-passage (hard budget) step at k = 10
ROLLOUT = dict(outer_iter=2, rescue_lanes=2, rescue_outer=6,
               recover_tol=0.01, budgets=((3, 8), (1, 7)))
HOST_RTOL = 1e-10
INNER = 2
OUTER = 3


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


def _scenarios(n=B, seed=0):
    rng = np.random.default_rng(seed)
    starts = np.tile([-1.5, -1.5], (n, 1)) + rng.uniform(-0.3, 0.3, (n, 2))
    goals = np.tile([2.0, 2.0], (n, 1)) + rng.uniform(-0.3, 0.3, (n, 2))
    return starts, goals


def _force_fused(runner, plan):
    """Put a fused plan on a float64 runner, as tests/test_fused_alm.py
    does: the solver is rebuilt with it and the consts carry FS."""
    runner.fused_plan = plan
    runner.solver = runner.make_solver(runner._alm_options)
    if hasattr(runner, "_consts"):
        runner._consts = None


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX runner, JAX plan, port problem, port runner), float64, both
    runners with the fused plan forced; the port runner's structure as
    built is kept in ``built_structure``."""
    import jax.numpy as jnp
    import omg_tools_tpu as J
    from omg_tools_tpu.ops.alm import ALMOptions as JALMOptions
    from omg_tools_tpu.ops.fused_alm import FusedPlan as JFusedPlan
    from omg_tools_tpu.problems.batch import BatchedP2PRunner as JRunner
    old = os.environ.get("OMG_CACHE_DIR")
    os.environ["OMG_CACHE_DIR"] = str(tmp_path_factory.mktemp("omg_cache"))
    try:
        jp = _build_problem(J)
        jp.init()
        jr = JRunner(jp, dtype=jnp.float64,
                     alm_options=JALMOptions(inner_iter=5))
    finally:
        if old is None:
            os.environ.pop("OMG_CACHE_DIR")
        else:
            os.environ["OMG_CACHE_DIR"] = old
    jplan = JFusedPlan(jr.compact)
    _force_fused(jr, jplan)
    tp = _build_problem(T)
    tp.init()
    tr = T.BatchedP2PRunner(tp, dtype=torch.float64,
                            alm_options=T.ALMOptions(inner_iter=5),
                            device="cpu")
    tr.built_structure = tr.structure
    _force_fused(tr, fa.FusedPlan(tr.compact))
    return jr, jplan, tp, tr


@pytest.fixture(scope="module")
def batch(pair):
    jr, _, _, tr = pair
    x0, p0, state = tr.make_batch(*_scenarios())
    jx0, jp0, _ = jr.make_batch(*_scenarios())
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jx0))
    np.testing.assert_array_equal(p0.numpy(), np.asarray(jp0))
    return x0, p0, state


def _close(got, want, rtol=HOST_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def test_plan_matches_jax(pair):
    _, jplan, _, tr = pair
    plan = tr.fused_plan
    assert [tuple(f) for f in plan.fams] == [tuple(f) for f in jplan.fams]
    assert (plan.head, plan.blocks) == (jplan.head, jplan.blocks)
    assert (plan.n_x, plan.m, plan.n_v, plan.spk) == \
        (jplan.n_x, jplan.m, jplan.n_v, jplan.spk)
    np.testing.assert_array_equal(plan.pcols, jplan.pcols)
    for key in ("uA", "uTA", "uQ", "uP"):
        mine, theirs = getattr(plan, key), getattr(jplan, key)
        assert len(mine) == len(theirs), key
        for u, v in zip(mine, theirs):
            _close(u, v)
    for key in ("c0", "C1", "gf"):
        _close(getattr(plan, key), getattr(jplan, key))
    # the bench plan (ISSUE sizing): 21 families, 2 Q tables
    assert len(plan.fams) == 21 and len(plan.uQ) == 2
    assert plan.head == (0, 26) and plan.schur_order == (0, 1, 2, 3, 4)


def test_descriptor_and_tables_encode_the_plan(pair):
    """The flat encoding the CUDA kernel reads, decoded against the plan."""
    plan = pair[3].fused_plan
    d = plan.descriptor()
    assert d.dtype == np.int32 and d[fa.H_MAGIC] == fa.MAGIC
    assert d[fa.H_LEN] == d.size
    assert tuple(d[fa.H_N:fa.H_NF + 1]) == (
        plan.n_x, plan.m, plan.n_v, plan.head[0], plan.head[1],
        len(plan.blocks), len(plan.fams))
    assert (d[fa.H_C0], d[fa.H_C1], d[fa.H_GF], d[fa.H_PLEN]) == (
        plan.off_c0, plan.off_C1, plan.off_gf, plan.phase_len)
    nb = len(plan.blocks)
    blocks = d[fa.HEADER:fa.HEADER + 2 * nb].reshape(nb, 2)
    assert [tuple(b) for b in blocks] == [tuple(b) for b in plan.blocks]
    fam0 = d[fa.H_FAM0]
    assert tuple(d[fa.HEADER + 2 * nb:fam0]) == plan.schur_order
    tables = plan.shared(torch.float64, "cpu")["tables"]
    assert tables.shape == (plan.spk, plan.phase_len)
    for fi, f in enumerate(plan.fams):
        rec = d[fam0 + fa.FAM * fi:fam0 + fa.FAM * (fi + 1)]
        m_f, n_f = f.row_stop - f.row_start, sum(z for _, z in f.runs)
        assert tuple(rec[:fa.F_NQ + 1]) == (
            fa.KIND_CODE[f.kind], f.row_start, m_f, n_f, len(f.runs),
            len(f.segs), len(f.qpos))
        runs = rec[fa.F_RUNS:fa.F_RUNS + 2 * len(f.runs)].reshape(-1, 2)
        assert [tuple(r) for r in runs] == [tuple(r) for r in f.runs]
        segs = rec[fa.F_SEGS:fa.F_SEGS + 4 * len(f.segs)].reshape(-1, 4)
        assert [tuple(g) for g in segs] == [tuple(g) for g in f.segs]
        assert tuple(rec[fa.F_QPOS:fa.F_QPOS + len(f.qpos)]) == f.qpos
        for ph in (0, plan.spk - 1):
            flat = tables[ph].numpy()
            A = plan.uA[f.iA][ph]
            np.testing.assert_array_equal(
                flat[rec[fa.F_A]:rec[fa.F_A] + A.size], A.ravel())
            for field, arrs, idx, phased in (
                    (fa.F_TA, plan.uTA, f.iTA, True),
                    (fa.F_Q, plan.uQ, f.iQ, False),
                    (fa.F_P, plan.uP, f.iP, True)):
                assert (rec[field] < 0) == (idx < 0)
                if idx >= 0:
                    a = arrs[idx][ph] if phased else arrs[idx]
                    np.testing.assert_array_equal(
                        flat[rec[field]:rec[field] + a.size], a.ravel())
    for ph in range(plan.spk):
        views = plan.tables(tables[ph])
        np.testing.assert_array_equal(views["c0"].numpy(), plan.c0[ph])
        np.testing.assert_array_equal(views["C1"].numpy(), plan.C1[ph])
        np.testing.assert_array_equal(views["gf"].numpy(), plan.gf[ph])


def test_descriptor_layout_names_match_the_cuda_source():
    """The field names and values of the descriptor as
    csrc/fused_alm.cu declares them, read from the source, equal this
    module's; on the card the wrapper checks them again through the
    library's omg_fused_layout before its first launch."""
    import re
    from pathlib import Path
    src = (Path(fa.__file__).resolve().parent.parent / "csrc"
           / "fused_alm.cu").read_text()
    consts = {name: int(val, 0) for name, val in re.findall(
        r"\b(k\w+) = (0x[0-9A-Fa-f]+|\d+)", src)}
    assert (consts["kMagic"], consts["kHeader"], consts["kFam"],
            consts["kMaxRuns"], consts["kMaxSegs"], consts["kMaxQ"]) == \
        fa.LAYOUT[:6]

    def enum(first):
        body = re.search(r"enum \{ (" + first + r"[^}]*)\}", src).group(1)
        out, nxt = {}, 0
        for item in body.replace("\n", " ").split(","):
            item = item.strip()
            if not item:
                continue
            name, _, val = item.partition("=")
            nxt = int(val) if val.strip() else nxt
            out[name.strip()] = nxt
            nxt += 1
        return out
    for name, val in {**enum("H_MAGIC"), **enum("F_KIND")}.items():
        assert getattr(fa, name) == val, name
    assert "omg_fused_layout" in fa._build.SIGNATURES["fused_alm"]


def _one_obstacle_problem():
    """A one-obstacle scene, whose host AD is cheaper than the bench's."""
    vehicle = T.Holonomic()
    vehicle.set_initial_conditions([-1.5, -1.5])
    vehicle.set_terminal_conditions([2.0, 2.0])
    environment = T.Environment(room={"shape": T.Square(5.0)})
    environment.add_obstacle(T.Obstacle({"position": [1.5, 0.5]},
                                        shape=T.Circle(0.4)))
    problem = T.Point2point(vehicle, environment, freeT=False)
    problem.set_options({"verbose": 0})
    problem.init()
    return problem


@pytest.fixture(scope="module")
def small32():
    """A float32 runner on the CPU over the one-obstacle scene."""
    problem = _one_obstacle_problem()
    return problem, T.BatchedP2PRunner(problem, dtype=torch.float32,
                                       device="cpu")


def test_structure_gate(pair, small32, monkeypatch):
    """float32 picks compact-arrow-fused, float64 keeps compact-arrow, and
    OMG_DISABLE_FUSED=1 keeps compact-arrow in float32."""
    assert pair[3].built_structure == "compact-arrow"
    problem, r32 = small32
    assert r32.structure == "compact-arrow-fused"
    assert isinstance(r32.fused_plan, fa.FusedPlan)
    assert r32.consts().FS["tables"].dtype == torch.float32
    monkeypatch.setenv("OMG_DISABLE_FUSED", "1")
    r32 = T.BatchedP2PRunner(problem, dtype=torch.float32, device="cpu")
    assert r32.structure == "compact-arrow" and r32.fused_plan is None


def test_fused_plan_is_the_one_selector(small32):
    """The runner's fused plan alone picks the path: taking it off makes
    the structure compact-arrow and the consts drop FS; consts that do not
    match the plan are refused rather than switching paths."""
    _, r = small32
    x0, p0, state = r.make_batch(*_scenarios(2))
    C = r.consts()
    assert C.FS is not None
    with pytest.raises(ValueError, match="fused plan"):
        r.init_solver_state(x0, p0, C._replace(FS=None))
    with pytest.raises(ValueError, match="fused plan"):
        r.rollout_fn(1, **ROLLOUT)(None, p0, state, C._replace(FS=None))
    plan = r.fused_plan
    try:
        r.fused_plan = None
        assert r.structure == "compact-arrow"
        assert r.consts().FS is None
        with pytest.raises(ValueError, match="fused plan"):
            r.init_solver_state(x0, p0, C)
    finally:
        r.fused_plan = plan
    assert r.structure == "compact-arrow-fused"
    assert r.consts().FS is not None


def _port_solve(tr, x0, p0, fused):
    C = tr.consts()
    solver = tr.make_solver(T.ALMOptions(inner_iter=INNER))
    if fused:
        return solver(x0, p0, C.lb, C.ub, outer_iter=OUTER,
                      fshared=fa.FusedPlan.slice_phase(C.FS, 0))
    return solver(x0, p0, C.lb, C.ub, outer_iter=OUTER,
                  ct=resolve_phase(tr.compact, C.CT, 0, p0))


def test_plain_k3_matches_jax_kernel_interpret(pair, batch, monkeypatch):
    """The plain K3 against the JAX Pallas kernel in interpret mode, through
    a 3-outer-round solve with 2 inner iterations (tests/test_fused_alm.py
    :89-120)."""
    import jax
    from omg_tools_tpu.ops.alm import ALMOptions as JALMOptions
    from omg_tools_tpu.ops.fused_alm import FusedPlan as JFusedPlan
    jr = pair[0]
    x0, p0, _ = batch
    consts = jr.consts()
    fs0 = JFusedPlan.slice_phase(consts.FS, 0)
    monkeypatch.setenv("OMG_FUSED_INTERPRET", "1")
    solver = jr.make_solver(JALMOptions(inner_iter=INNER))
    st_j = jax.jit(jax.vmap(lambda x, p: solver(
        x, p, consts.lb, consts.ub, outer_iter=OUTER, fshared=fs0)))(
        x0.numpy(), p0.numpy())
    st = _port_solve(pair[3], x0, p0, fused=True)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(st_j.x), atol=1e-8)
    np.testing.assert_allclose(st.feas.numpy(), np.asarray(st_j.feas),
                               atol=1e-9)
    np.testing.assert_array_equal(st.n_iter.numpy(), np.asarray(st_j.n_iter))


def test_fused_matches_compact_arrow(pair, batch):
    """The port's fused solve against its own compact-arrow solve."""
    tr = pair[3]
    x0, p0, _ = batch
    st_f = _port_solve(tr, x0, p0, fused=True)
    st_c = _port_solve(tr, x0, p0, fused=False)
    np.testing.assert_allclose(st_f.x.numpy(), st_c.x.numpy(), atol=1e-8)
    np.testing.assert_allclose(st_f.feas.numpy(), st_c.feas.numpy(),
                               atol=1e-9)


def test_fused_rollout_matches_jax(pair, batch):
    """The port's fused rollout against the JAX runner's fused path (its
    XLA version on the CPU), 11 steps with the knot passage."""
    import jax
    jr, _, _, tr = pair
    x0, p0, state = batch
    consts = jr.consts()
    jx0, jp0, jstate = (jax.numpy.asarray(a.numpy()) for a in batch)
    st0 = jax.jit(jr.init_solver_state)(jx0, jp0, consts)
    _, states_j = jax.jit(jr.rollout_fn(N_STEPS, **ROLLOUT))(
        st0, jp0, jstate, consts)
    launches = fa.fused_inner.launches
    st = tr.init_solver_state(x0, p0)
    # the cold solve (up to 100 inner iterations): the splines (the head)
    # agree to 1e-8; a few hyperplane variables of an inactive obstacle,
    # which the objective does not pin down, drift ~1e-7 apart between the
    # Pallas kernel's arithmetic and the XLA path's
    h0, h = tr.fused_plan.head
    np.testing.assert_allclose(st.x[:, h0:h0 + h].numpy(),
                               np.asarray(st0.x)[:, h0:h0 + h], atol=1e-8)
    np.testing.assert_allclose(st.feas.numpy(), np.asarray(st0.feas),
                               atol=1e-9)
    _, states = tr.rollout_fn(N_STEPS, **ROLLOUT)(st, p0, state)
    assert fa.fused_inner.launches == launches    # CPU: the plain version
    assert states.shape == (B, N_STEPS, 2)
    np.testing.assert_allclose(states.numpy(), np.asarray(states_j),
                               atol=1e-8)


def test_wrapper_dispatch_on_cpu(pair, batch):
    """CPU tensors take the plain version and count no launch; a CPU/CUDA
    mix or a non-CUDA, non-CPU set is refused before any launch."""
    tr = pair[3]
    x0, p0, _ = batch
    plan = tr.fused_plan
    C = tr.consts()
    fs = fa.FusedPlan.slice_phase(C.FS, 0)
    lb, ub = tr.solver.scale_bounds(tr.lb, tr.ub, torch.float64, "cpu")
    pv = p0[:, torch.as_tensor(plan.pcols)]
    lam = torch.zeros((B, plan.m), dtype=torch.float64)
    rho = torch.full((B,), 10.0, dtype=torch.float64)
    opt = T.ALMOptions()
    before = fa.fused_inner.launches
    got = fa.fused_inner(plan, fs, x0, lam, rho, pv, lb, ub, opt, 2)
    want = fa.fused_inner_plain(plan, fs, x0, lam, rho, pv, lb, ub, opt, 2)
    assert fa.fused_inner.launches == before
    for u, v in zip(got, want):
        assert u.dtype == torch.float64
        np.testing.assert_array_equal(u.numpy(), v.numpy())
    with pytest.raises(ValueError, match="CUDA"):
        fa.fused_inner(plan, fs, x0.to("meta"), lam, rho, pv, lb, ub, opt, 2)


# -- on the card --------------------------------------------------------------

WELL_RIDGE = 1e-2      # the well-conditioned check's gn_delta_rel
TOL_DX, TOL_GV, TOL_STAT = 2e-3, 1e-3, 1e-3
MERIT_GATE = 0.25


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 runs on the card only")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_inputs(card):
    """The float32 fused runner on the card and K3's inputs at B = 256:
    make_batch's x0 and pv, zero multipliers, rho = rho_init (the cold
    solve's first outer round), phase 0."""
    problem = _build_problem(T)
    problem.init()
    runner = T.BatchedP2PRunner(problem, dtype=torch.float32, device=card,
                                alm_options=T.ALMOptions(inner_iter=8))
    assert runner.structure == "compact-arrow-fused"
    x0, p0, _ = runner.make_batch(*_scenarios(256, seed=1))
    plan = runner.fused_plan
    C = runner.consts()
    lb, ub = runner.solver.scale_bounds(runner.lb, runner.ub, torch.float32,
                                        card)
    pv = p0[:, torch.as_tensor(plan.pcols, device=card)].contiguous()
    lam = torch.zeros((256, plan.m), device=card)
    rho = torch.full((256,), 10.0, device=card)
    return plan, C.FS, dict(x=x0, lam=lam, rho=rho, pv=pv, lb=lb, ub=ub)


def _run(fn, plan, fs, a, opt, n_inner):
    return fn(plan, fs, a["x"], a["lam"], a["rho"], a["pv"], a["lb"],
              a["ub"], opt, n_inner)


def _merit(x, gv, a, gf):
    """gf'x plus the penalty at g(x) = gv, in float64."""
    rho = a["rho"].double()
    rr = gv.double() + a["lam"].double() / rho[:, None]
    viol = rr - torch.clamp(rr, a["lb"].double(), a["ub"].double())
    return x.double() @ gf + 0.5 * rho * (viol * viol).sum(-1)


@pytest.mark.gpu
def test_cuda_k3_matches_plain(card_inputs):
    """With a well-conditioned ridge the kernel agrees with the plain
    float32 version to a small tolerance (step, g, gradient norm); with
    the bench options, whose float32 runs leave the float64 trajectory, the
    merit it reaches lies near the float64 run's (chip_smoke.py's K3
    checks, at B = 256)."""
    plan, FS, a = card_inputs
    fs = fa.FusedPlan.slice_phase(FS, 0)
    opt = T.ALMOptions()
    well = opt._replace(gn_delta_rel=WELL_RIDGE)
    before = fa.fused_inner.launches
    k = _run(fa.fused_inner, plan, fs, a, well, 8)
    assert fa.fused_inner.launches == before + 1
    p = _run(fa.fused_inner_plain, plan, fs, a, well, 8)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in k + p)
    step = (p[0] - a["x"]).abs().max()
    assert float((k[0] - p[0]).abs().max()) <= TOL_DX * float(step)
    assert float((k[1] - p[1]).abs().max()) <= \
        TOL_GV * float(p[1].abs().max())
    assert float(((k[2] - p[2]).abs() / p[2].abs()).max()) <= TOL_STAT

    fs64 = dict(fs, tables=fs["tables"].double())
    a64 = {key: v.double() for key, v in a.items()}
    gf = plan.tables(fs64["tables"])["gf"]
    k = _run(fa.fused_inner, plan, fs, a, opt, 8)
    ref = _run(fa.fused_inner_plain, plan, fs64, a64, opt, 8)
    g_in = _run(fa.fused_inner_plain, plan, fs64, a64,
                opt._replace(ls_candidates=(0.0,)), 1)[1]
    m_ref = _merit(ref[0], ref[1], a64, gf)
    decrease = _merit(a64["x"], g_in, a64, gf) - m_ref
    err = (_merit(k[0], k[1], a64, gf) - m_ref).abs() / decrease.abs()
    assert float(torch.quantile(err, 0.99)) <= MERIT_GATE


@pytest.mark.gpu
def test_cuda_k3_rejects_what_it_does_not_take(card_inputs):
    plan, FS, inp = card_inputs
    fs = fa.FusedPlan.slice_phase(FS, 0)
    opt = T.ALMOptions()
    a = dict(inp)
    before = fa.fused_inner.launches

    def call(**kw):
        b = dict(a, **kw)
        return fa.fused_inner(plan, fs, b["x"], b["lam"], b["rho"], b["pv"],
                              b["lb"], b["ub"], opt, 2)
    with pytest.raises(ValueError):                 # CPU/CUDA mix
        call(lam=a["lam"].cpu())
    with pytest.raises(TypeError):                  # float64 on the card
        call(x=a["x"].double())
    with pytest.raises(ValueError):                 # not contiguous
        call(x=a["x"].t().contiguous().t())
    # a plan too large for the kernel's shared memory: the C entry point
    # refuses it and nothing is launched
    big = fs["desc_host"].copy()
    big[12] = 200_000                               # J buffer of 800 KB
    huge = dict(fs, desc_host=big,
                desc=torch.as_tensor(big, device=a["x"].device))
    with pytest.raises(RuntimeError, match="cudaError"):
        fa.fused_inner(plan, huge, a["x"], a["lam"], a["rho"], a["pv"],
                       a["lb"], a["ub"], opt, 2)
    assert fa.fused_inner.launches == before

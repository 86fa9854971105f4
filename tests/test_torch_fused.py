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
from torch_bench_configs import jax_compiled

B = 4
N_STEPS = 11        # covers the knot-passage (hard budget) step at k = 10
ROLLOUT = dict(outer_iter=2, rescue_lanes=2, rescue_outer=6,
               recover_tol=0.01, budgets=((3, 8), (1, 7)))
HOST_RTOL = 1e-10
INNER = 2
OUTER = 3


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
        jr = JRunner(jax_compiled(jp), dtype=jnp.float64,
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
    """The plain version's dense tables and the kernel's descriptor header,
    tail-block records and Schur order, decoded against the plan."""
    plan = pair[3].fused_plan
    d = plan.descriptor()
    assert d.dtype == np.int32 and d[fa.H_MAGIC] == fa.MAGIC
    assert d[fa.H_LEN] == d.size
    h0, h = plan.head
    nb = len(plan.blocks)
    assert tuple(d[fa.H_N:fa.H_NB + 1]) == (
        plan.n_x, plan.m, plan.n_v, h0, h, nb)
    assert (d[fa.H_NJ], d[fa.H_ARROW], d[fa.H_VLEN], d[fa.H_STAGE]) == (
        plan.n_j, plan.arrow_len, plan.values_len, plan.stage_len())
    assert [d[f] for f in (fa.V_A, fa.V_Q, fa.V_T, fa.V_C, fa.V_C0,
                           fa.V_GF)] == [plan.voff[k] for k in (
                               "A", "Q", "T", "C", "c0", "gf")]
    recs = d[fa.HEADER:fa.HEADER + fa.B_REC * nb].reshape(nb, fa.B_REC)
    assert [tuple(r[:2]) for r in recs] == [tuple(b) for b in plan.blocks]
    # the arrow region: S packed, r_h, then per block D packed and M
    at = fa._r4(h * (h + 1) // 2) + fa._r4(h)
    for (_, sz), r in zip(plan.blocks, recs):
        assert (r[fa.B_D], r[fa.B_M]) == (at, at + fa._r4(sz * (sz + 1) // 2))
        at = r[fa.B_M] + fa._r4(sz * (h + 2))
    assert at == plan.arrow_len
    assert tuple(d[fa.HEADER + fa.B_REC * nb:d[fa.H_STAGE]]) == \
        plan.schur_order
    # every index array is 16-byte aligned, after the staged part, in order
    offs = [d[f] for f in range(fa.O_ROFF, fa.H_END)]
    assert all(o % 4 == 0 for o in offs) and offs == sorted(offs)
    assert offs[0] >= d[fa.H_STAGE] and offs[-1] < d.size
    # the bench plan's compressed sizes (PERF.md): list entries of J, Q,
    # TA, C1 and the Gauss-Newton pairs, the pairs' targets, J's sliced
    # positions, one phase's values and the descriptor, against 298,160
    # floats of dense tables a phase
    D = _Desc(d, plan.phase_values(0))
    lists = [int(D.arr[o].sum()) for o in (fa.O_RLEN, fa.O_QLEN, fa.O_TLEN,
                                            fa.O_CLEN, fa.O_GNLEN)]
    assert lists == [3262, 2118, 2754, 56, 12964]
    assert (d[fa.H_NGN], plan.n_j, plan.values_len, d.size,
            plan.phase_len) == (1605, 4224, 13176, 72532, 298160)
    tables = plan.shared(torch.float64, "cpu")["tables"]
    assert tables.shape == (plan.spk, plan.phase_len)
    for ph in (0, plan.spk - 1):
        views = plan.tables(tables[ph])
        for f in plan.fams:
            np.testing.assert_array_equal(views["uA"][f.iA].numpy(),
                                          plan.uA[f.iA][ph])
            if f.iQ >= 0:
                np.testing.assert_array_equal(views["uQ"][f.iQ].numpy(),
                                              plan.uQ[f.iQ])
            if f.iP >= 0:
                np.testing.assert_array_equal(views["uP"][f.iP].numpy(),
                                              plan.uP[f.iP][ph])
    for ph in range(plan.spk):
        views = plan.tables(tables[ph])
        np.testing.assert_array_equal(views["c0"].numpy(), plan.c0[ph])
        np.testing.assert_array_equal(views["C1"].numpy(), plan.C1[ph])
        np.testing.assert_array_equal(views["gf"].numpy(), plan.gf[ph])


class _Desc:
    """Named views of a kernel descriptor and one phase's values, and the
    sliced lists' entries (entry j of item i at off[i] + 32 j)."""

    def __init__(self, d, vals):
        self.d, self.vals = d, np.asarray(vals)
        self.n, self.m = int(d[fa.H_N]), int(d[fa.H_M])
        self.h0, self.h, self.nb = (int(d[fa.H_H0]), int(d[fa.H_H]),
                                    int(d[fa.H_NB]))
        self.nJ = int(d[fa.H_NJ])
        self.blk = d[fa.HEADER:fa.HEADER + fa.B_REC * self.nb].reshape(
            self.nb, fa.B_REC)
        self.order = d[fa.HEADER + fa.B_REC * self.nb:int(d[fa.H_STAGE])]
        sizes = {fa.O_ROFF: self.m, fa.O_RLEN: self.m, fa.O_COFF: self.m,
                 fa.O_CLEN: self.m, fa.O_CIDX: int(d[fa.H_NC]),
                 fa.O_QIDX: int(d[fa.H_NQ]), fa.O_TIDX: int(d[fa.H_NT]),
                 fa.O_GROFF: self.n, fa.O_GRLEN: self.n,
                 fa.O_GRENT: int(d[fa.H_NGR]), fa.O_GRROW: int(d[fa.H_NGR]),
                 fa.O_GNENT: int(d[fa.H_NGE]), fa.O_GNROW: int(d[fa.H_NGE])}
        for f in (fa.O_COL, fa.O_QOFF, fa.O_QLEN, fa.O_TOFF, fa.O_TLEN):
            sizes[f] = self.nJ
        for f in (fa.O_GNOFF, fa.O_GNLEN, fa.O_GNDST):
            sizes[f] = int(d[fa.H_NGN])
        self.arr = {f: d[int(d[f]):int(d[f]) + c] for f, c in sizes.items()}
        vsz = {fa.V_A: self.nJ, fa.V_Q: int(d[fa.H_NQ]),
               fa.V_T: int(d[fa.H_NT]), fa.V_C: int(d[fa.H_NC]),
               fa.V_C0: self.m, fa.V_GF: self.n}
        self.val = {f: self.vals[int(d[f]):int(d[f]) + c]
                    for f, c in vsz.items()}

    def entries(self, o_off, o_len, i):
        return int(self.arr[o_off][i]) + fa.SLICE * np.arange(
            int(self.arr[o_len][i]))


def _tri(i):
    return i * (i + 1) // 2


def _lists_into_arrow(D, J, y, rho):
    """The kernel's phase P2 in numpy: the gradient less gf (J'y) and the
    arrow region from the Gauss-Newton pair lists, for one lane."""
    grad = np.array([sum(J[D.arr[fa.O_GRENT][k]] * y[D.arr[fa.O_GRROW][k]]
                         for k in D.entries(fa.O_GROFF, fa.O_GRLEN, v))
                     for v in range(D.n)])
    ar = np.zeros(int(D.d[fa.H_ARROW]))
    for t in range(int(D.d[fa.H_NGN])):
        hv = 0.0
        for k in D.entries(fa.O_GNOFF, fa.O_GNLEN, t):
            e = int(D.arr[fa.O_GNENT][k])
            u, v = e & 0xffff, e >> 16
            dd = rho if abs(y[D.arr[fa.O_GNROW][k]]) > 0 else 0.0
            hv += (J[u] * dd) * J[v]
        ar[D.arr[fa.O_GNDST][t]] = hv
    return grad, ar


def _emulate_kernel(D, x, lam, rho, pv, lb, ub, opt, n_inner):
    """K3 as csrc/fused_alm.cu computes it, phase by phase (P1-P10), one
    lane at a time in numpy (float64), reading only the descriptor and one
    phase's values; the dense factorizations go to numpy."""
    n, m, h0, h, nb = D.n, D.m, D.h0, D.h, D.nb
    hp = h + 2
    A = D.arr
    VA, VQ, VT, VC = (D.val[f] for f in (fa.V_A, fa.V_Q, fa.V_T, fa.V_C))
    c0, gf = D.val[fa.V_C0], D.val[fa.V_GF]
    col = A[fa.O_COL]
    rt0 = fa._r4(_tri(h))
    B = x.shape[0]
    xo, gvo, so = np.empty_like(x), np.empty((B, m)), np.empty(B)
    for b in range(B):
        xl = x[b].copy()
        for _ in range(n_inner):
            J, gv, y = np.zeros(D.nJ), np.zeros(m), np.zeros(m)
            for r in range(m):                                   # P1
                s = 0.0
                for p in D.entries(fa.O_ROFF, fa.O_RLEN, r):
                    a = VA[p] + sum(VT[k] * pv[b, A[fa.O_TIDX][k]] for k in
                                    D.entries(fa.O_TOFF, fa.O_TLEN, p))
                    t1 = sum(VQ[k] * xl[A[fa.O_QIDX][k]] for k in
                             D.entries(fa.O_QOFF, fa.O_QLEN, p))
                    s += (a + t1) * xl[col[p]]
                    J[p] = a + 2 * t1
                cs = sum(VC[k] * pv[b, A[fa.O_CIDX][k]] for k in
                         D.entries(fa.O_COFF, fa.O_CLEN, r))
                gv[r] = (c0[r] + cs) + s
                rr = gv[r] + lam[b, r] / rho[b]
                y[r] = rho[b] * (rr - min(max(rr, lb[r]), ub[r]))
            grad, ar = _lists_into_arrow(D, J, y, rho[b])       # P2
            grad = gf + grad
            assert not ar[rt0:rt0 + h].any()

            def full(off, sz):            # packed lower triangle, mirrored
                L = np.zeros((sz, sz))
                for i in range(sz):
                    L[i, :i + 1] = ar[off + _tri(i):off + _tri(i) + i + 1]
                return L + np.tril(L, -1).T
            S = full(0, h)
            Ds = [full(int(r[fa.B_D]), int(r[fa.B_SIZE])) for r in D.blk]
            Ms = [ar[int(r[fa.B_M]):int(r[fa.B_M]) + int(r[fa.B_SIZE]) * hp]
                  .reshape(-1, hp).copy() for r in D.blk]
            rt = grad[h0:h0 + h].copy()                          # P3
            dm = max(np.abs(np.diag(S)).max(),
                     *(np.abs(np.diag(Dm)).max() for Dm in Ds))
            ridge = opt.gn_delta_rel * max(dm, 1.0) + opt.delta
            S += ridge * np.eye(h)
            for r, Dm, Mb in zip(D.blk, Ds, Ms):
                s0, sz = int(r[fa.B_START]), int(r[fa.B_SIZE])
                Mb[:, h] = grad[s0:s0 + sz]
                Dm += ridge * np.eye(sz)
            Ls = [np.linalg.cholesky(Dm) for Dm in Ds]           # P4
            Ys = [np.linalg.solve(L, Mb[:, :h + 1]) for L, Mb in zip(Ls, Ms)]
            for bi in D.order:                                   # P5
                G = Ys[bi][:, :h].T @ Ys[bi]
                S -= G[:, :h]
                rt -= G[:, h]
            Lh = np.linalg.cholesky(S)                           # P6
            dxh = np.linalg.solve(Lh.T, np.linalg.solve(Lh, rt))
            dx = np.empty(n)                                     # P7
            for r, L, Y in zip(D.blk, Ls, Ys):
                s0, sz = int(r[fa.B_START]), int(r[fa.B_SIZE])
                dx[s0:s0 + sz] = -np.linalg.solve(
                    L.T, Y[:, h] - Y[:, :h] @ dxh)
            dx[h0:h0 + h] = -dxh                                 # P8
            if not np.isfinite(dx).all():
                dx = -grad / max(np.sqrt(grad @ grad), 1.0)
            dx = dx * min(1.0, opt.max_step / max(np.abs(dx).max(), 1e-12))
            slope, df = grad @ dx, gf @ dx
            jd, qd = np.zeros(m), np.zeros(m)                    # P9
            for r in range(m):
                for p in D.entries(fa.O_ROFF, fa.O_RLEN, r):
                    jd[r] += J[p] * dx[col[p]]
                    qd[r] += sum(VQ[k] * dx[A[fa.O_QIDX][k]] for k in
                                 D.entries(fa.O_QOFF, fa.O_QLEN, p)) \
                        * dx[col[p]]

            def pen(g):                                          # P10
                t = g + lam[b] / rho[b]
                t = t - np.clip(t, lb, ub)
                return 0.5 * rho[b] * (t @ t)
            m0, alpha = pen(gv), 0.0
            for a in opt.ls_candidates:
                mv = a * df + pen(gv + a * jd + a * a * qd)
                if np.isfinite(mv) and mv <= m0 + opt.armijo * a * slope:
                    alpha = a
                    break
            xl = xl + alpha * dx
        xo[b], gvo[b] = xl, gv + alpha * jd + alpha * alpha * qd
        so[b] = np.abs(grad).max()
    return xo, gvo, so


def _family_of_row(plan):
    out = np.empty(plan.m, np.int64)
    for fi, f in enumerate(plan.fams):
        out[f.row_start:f.row_stop] = fi
    return out


def _local_cols(f):
    cols = np.concatenate([np.arange(s, s + z) for s, z in f.runs])
    return {int(v): j for j, v in enumerate(cols)}


@pytest.mark.parametrize("phase", range(10))
def test_compressed_tables_scatter_back_to_the_dense_tables(pair, phase):
    """Every value of one phase's compressed tables, put back where its
    indices say, rebuilds the dense A0, TA, Q, C1, c0 and gf of every
    family exactly; every non-zero of them is encoded.  The gradient and
    Gauss-Newton lists name the row of each J position they read."""
    plan = pair[3].fused_plan
    assert plan.spk == 10
    D = _Desc(plan.descriptor(), plan.phase_values(phase))
    A = D.arr
    fam = _family_of_row(plan)
    locs = [_local_cols(f) for f in plan.fams]
    dense_A = [np.zeros_like(a[phase]) for a in plan.uA]
    dense_T = [np.zeros_like(a[phase]) for a in plan.uTA]
    dense_Q = [np.zeros_like(q) for q in plan.uQ]
    dense_C = np.zeros_like(plan.C1[phase])
    row_of = {}
    for r in range(plan.m):
        f = plan.fams[fam[r]]
        i, loc = r - f.row_start, locs[fam[r]]
        n_f = len(loc)
        for p in D.entries(fa.O_ROFF, fa.O_RLEN, r):
            row_of[p] = r
            j = loc[int(A[fa.O_COL][p])]
            dense_A[f.iA][i, j] = D.val[fa.V_A][p]
            for k in D.entries(fa.O_TOFF, fa.O_TLEN, p):
                q = f.qpos.index(int(A[fa.O_TIDX][k]))
                dense_T[f.iTA][i, j, q] = D.val[fa.V_T][k]
            for k in D.entries(fa.O_QOFF, fa.O_QLEN, p):
                dense_Q[f.iQ][i * n_f + j, loc[int(A[fa.O_QIDX][k])]] = \
                    D.val[fa.V_Q][k]
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
    for v in range(plan.n_x):
        for k in D.entries(fa.O_GROFF, fa.O_GRLEN, v):
            p = int(A[fa.O_GRENT][k])
            assert row_of[p] == A[fa.O_GRROW][k]
            assert A[fa.O_COL][p] == v
    for t in range(int(D.d[fa.H_NGN])):
        for k in D.entries(fa.O_GNOFF, fa.O_GNLEN, t):
            e = int(A[fa.O_GNENT][k])
            assert row_of[e & 0xffff] == row_of[e >> 16] == A[fa.O_GNROW][k]


def test_gauss_newton_lists_reproduce_jtdj(pair):
    """The gradient and Gauss-Newton pair lists, applied to random J values
    on J's pattern and random multipliers (a third of the rows inactive),
    give J'y and J' diag(d) J in the S / C' / D targets where
    fused_inner_plain puts them (float64); every other entry of the arrow
    region stays zero."""
    plan = pair[3].fused_plan
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
    t = lambda a: torch.as_tensor(a)[None]
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
    lower = np.tril_indices(h)
    want[:_tri(h)] = S[0].numpy()[lower]
    for r, Dm, Mb in zip(D.blk, Ds, Ms):
        sz = int(r[fa.B_SIZE])
        want[r[fa.B_D]:r[fa.B_D] + _tri(sz)] = \
            Dm[0].numpy()[np.tril_indices(sz)]
        want[r[fa.B_M]:r[fa.B_M] + sz * (h + 2)] = Mb[0].numpy().ravel()
    np.testing.assert_allclose(ar, want, rtol=1e-12, atol=1e-12)
    assert np.count_nonzero(ar) > 1000


def test_compressed_kernel_emulation_matches_plain(pair, batch):
    """The kernel's phases (P1-P10 of csrc/fused_alm.cu) emulated in numpy
    on the compressed tables agree with fused_inner_plain on the dense
    ones: 2 lanes (one with non-zero multipliers), 2 iterations, phase 3,
    float64, to 1e-9 of each output's scale."""
    tr = pair[3]
    plan = tr.fused_plan
    x0, p0, _ = batch
    fs = fa.FusedPlan.slice_phase(plan.shared(torch.float64, "cpu"), 3)
    lb, ub = tr.solver.scale_bounds(tr.lb, tr.ub, torch.float64, "cpu")
    x = x0[:2].clone()
    pv = p0[:2, torch.as_tensor(plan.pcols)]
    lam = torch.zeros((2, plan.m), dtype=torch.float64)
    lam[1] = torch.as_tensor(np.random.default_rng(3).normal(size=plan.m))
    rho = torch.tensor([10.0, 30.0], dtype=torch.float64)
    opt = T.ALMOptions()
    want = fa.fused_inner_plain(plan, fs, x, lam, rho, pv, lb, ub, opt, 2)
    got = _emulate_kernel(_Desc(fs["desc_host"], fs["vals"].numpy()),
                          x.numpy(), lam.numpy(), rho.numpy(), pv.numpy(),
                          lb.numpy(), ub.numpy(), opt, 2)
    for g, w in zip(got, want):
        _close(g, w.numpy(), rtol=1e-9)


def test_lanes_per_block_and_shared_memory(pair):
    """The wrapper's lane count per block and the block's shared memory at
    the bench plan (held to the CUDA side's count by a gpu test): 2 lanes
    at B = 4096 (two blocks an SM), 1 at the rescue's 128 lanes and at
    small or ragged widths, never more than the per-SM share holds."""
    plan = pair[3].fused_plan
    lane = 4 * plan.lane_floats()
    assert plan.smem_bytes(3) - plan.smem_bytes(2) == lane
    assert plan.smem_bytes(1) == 4 * fa._r4(plan.stage_len()) + lane
    budget = fa.SMEM_PER_SM // fa.BLOCKS_PER_SM - fa.SMEM_RESERVED
    assert plan.smem_bytes(2) <= budget < plan.smem_bytes(3)
    pick = lambda B: fa.lanes_per_block(B, 132, plan.smem_bytes)
    assert [pick(B) for B in (1, 128, 130, 257, 528, 4096, 1 << 20)] == \
        [1, 1, 1, 1, 2, 2, 2]
    # at most two lanes a block, whatever the plan: a plan a quarter as
    # large would fit four in the per-SM share and still takes two
    assert fa.MAX_LANES == 2
    assert fa.lanes_per_block(4096, 132, lambda L: L * lane // 4) == 2
    assert fa.lanes_per_block(4096, 132, lambda L: L * 10 ** 6) == 1


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
    assert (consts["kMagic"], consts["kHeader"], consts["kSlice"],
            consts["kMaxBlocks"], consts["kMaxLanes"], consts["kMaxCands"],
            consts["kLaneScalars"], consts["kPhases"]) == \
        fa.LAYOUT[:6] + fa.LAYOUT[8:]
    assert (consts["kMaxJ"], consts["kMaxSize"], consts["kMaxSmem"]) == (
        fa.MAX_J, fa.MAX_SIZE, fa.SMEM_BLOCK_MAX)

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
    fields = {**enum("H_MAGIC"), **enum("B_START")}
    assert fields["H_END"] == fa.LAYOUT[6] and fields["B_REC"] == fa.LAYOUT[7]
    for name, val in fields.items():
        assert getattr(fa, name) == val, name
    assert {"omg_fused_layout", "omg_fused_smem"} <= set(
        fa._build.SIGNATURES["fused_alm"])


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
    """The float32 fused runner on the card and K3's inputs at B = 1031:
    make_batch's x0 and pv, zero multipliers, rho = rho_init (the cold
    solve's first outer round), phase 0."""
    problem = _build_problem(T)
    problem.init()
    runner = T.BatchedP2PRunner(problem, dtype=torch.float32, device=card,
                                alm_options=T.ALMOptions(inner_iter=8))
    assert runner.structure == "compact-arrow-fused"
    x0, p0, _ = runner.make_batch(*_scenarios(1031, seed=1))
    plan = runner.fused_plan
    C = runner.consts()
    lb, ub = runner.solver.scale_bounds(runner.lb, runner.ub, torch.float32,
                                        card)
    pv = p0[:, torch.as_tensor(plan.pcols, device=card)].contiguous()
    lam = torch.zeros((1031, plan.m), device=card)
    rho = torch.full((1031,), 10.0, device=card)
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


def _lanes(plan, B):
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return fa.lanes_per_block(B, n_sm, plan.smem_bytes)


@pytest.mark.gpu
@pytest.mark.parametrize("B,n_inner,lanes", [
    (256, 8, 1), (1, 8, 1), (130, 8, 1), (257, 8, 1), (528, 8, 2),
    (529, 8, 2), (1031, 8, 2), (128, 5, 1)])
def test_cuda_k3_matches_plain(card_inputs, B, n_inner, lanes):
    """With a well-conditioned ridge the kernel agrees with the plain
    float32 version to a small tolerance (step, g, gradient norm); with
    the bench options, whose float32 runs leave the float64 trajectory, the
    merit it reaches lies near the float64 run's (chip_smoke.py's K3
    checks).  At B = 256, at one lane a block (B < 528) and at two, where
    B = 529 and 1031 leave the last block one lane short, and at the
    rescue shape (128 lanes, 5 iterations)."""
    assert _lanes(card_inputs[0], B) == lanes
    plan, FS, a = card_inputs
    a = {k: (v[:B].contiguous() if k not in ("lb", "ub") else v)
         for k, v in a.items()}
    fs = fa.FusedPlan.slice_phase(FS, 0)
    opt = T.ALMOptions()
    well = opt._replace(gn_delta_rel=WELL_RIDGE)
    before = fa.fused_inner.launches
    k = _run(fa.fused_inner, plan, fs, a, well, n_inner)
    assert fa.fused_inner.launches == before + 1
    p = _run(fa.fused_inner_plain, plan, fs, a, well, n_inner)
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
    k = _run(fa.fused_inner, plan, fs, a, opt, n_inner)
    ref = _run(fa.fused_inner_plain, plan, fs64, a64, opt, n_inner)
    g_in = _run(fa.fused_inner_plain, plan, fs64, a64,
                opt._replace(ls_candidates=(0.0,)), 1)[1]
    m_ref = _merit(ref[0], ref[1], a64, gf)
    decrease = _merit(a64["x"], g_in, a64, gf) - m_ref
    err = (_merit(k[0], k[1], a64, gf) - m_ref).abs() / decrease.abs()
    assert float(torch.quantile(err, 0.99)) <= MERIT_GATE


@pytest.mark.gpu
def test_cuda_smem_matches_python(card_inputs):
    """The CUDA side lays out a block's shared memory as FusedPlan says,
    for every lane count it takes, and refuses the others."""
    plan, FS, _ = card_inputs
    desc = FS["desc_host"]
    for L in range(1, fa.MAX_LANES + 1):
        assert fa.kernel_smem_bytes(desc, L) == plan.smem_bytes(L), L
    assert fa.kernel_smem_bytes(desc, 0) == -1
    assert fa.kernel_smem_bytes(desc, fa.MAX_LANES + 1) == -1


@pytest.mark.gpu
def test_cuda_k3_clock_profile_leaves_outputs_unchanged(card_inputs):
    """A launch with the per-phase clock profile on gives the same x, g
    and gradient norm, bit for bit, as one without it (two lanes a block,
    the last block one lane short), and counts cycles in every phase."""
    plan, FS, inp = card_inputs
    B = 529
    a = {k: (v[:B].contiguous() if k not in ("lb", "ub") else v)
         for k, v in inp.items()}
    fs = fa.FusedPlan.slice_phase(FS, 0)
    opt = T.ALMOptions()
    clocks = torch.zeros(len(fa.PHASES), dtype=torch.int64,
                         device=a["x"].device)
    plain = _run(fa.fused_inner, plan, fs, a, opt, 8)
    prof = fa.fused_inner(plan, fs, a["x"], a["lam"], a["rho"], a["pv"],
                          a["lb"], a["ub"], opt, 8, clocks=clocks)
    torch.cuda.synchronize()
    for u, v in zip(prof, plain):
        assert torch.equal(u.view(torch.int32), v.view(torch.int32))
    assert bool((clocks > 0).all())


def _c_launch(plan, fs, a, opt, desc_host, lanes):
    """omg_fused_inner_f32 called directly, as the wrapper calls it but
    with a descriptor and a lane count of the caller's, into outputs that
    hold NaN; the error code and the outputs."""
    B = a["x"].shape[0]
    out = [torch.full_like(a["x"], float("nan")),
           torch.full((B, plan.m), float("nan"), device=a["x"].device),
           torch.full((B,), float("nan"), device=a["x"].device)]
    opts = np.asarray([opt.armijo, opt.max_step, opt.gn_delta_rel,
                       opt.delta, *opt.ls_candidates], dtype=np.float64)
    err = fa._load().omg_fused_inner_f32(
        desc_host.ctypes.data, fs["desc"].data_ptr(), fs["vals"].data_ptr(),
        a["lb"].data_ptr(), a["ub"].data_ptr(), a["x"].data_ptr(),
        a["lam"].data_ptr(), a["rho"].data_ptr(), a["pv"].data_ptr(),
        opts.ctypes.data, len(opt.ls_candidates), *[t.data_ptr()
                                                    for t in out],
        B, 2, int(lanes), None,
        torch.cuda.current_stream(a["x"].device).cuda_stream)
    torch.cuda.synchronize()
    return err, out


@pytest.mark.gpu
def test_cuda_k3_rejects_what_it_does_not_take(card_inputs):
    plan, FS, inp = card_inputs
    fs = fa.FusedPlan.slice_phase(FS, 0)
    opt = T.ALMOptions()
    a = dict(inp)
    before = fa.fused_inner.launches

    def call(fs=fs, **kw):
        b = dict(a, **kw)
        return fa.fused_inner(plan, fs, b["x"], b["lam"], b["rho"], b["pv"],
                              b["lb"], b["ub"], opt, 2)
    with pytest.raises(ValueError):                 # CPU/CUDA mix
        call(lam=a["lam"].cpu())
    with pytest.raises(TypeError):                  # float64 on the card
        call(x=a["x"].double())
    with pytest.raises(ValueError):                 # not contiguous
        call(x=a["x"].t().contiguous().t())
    d = fs["desc_host"].copy()                      # another plan's width
    d[fa.H_N] += 1
    with pytest.raises(ValueError, match="descriptor"):
        call(fs=dict(fs, desc_host=d))

    def corrupt(field, at, value):
        d = fs["desc_host"].copy()
        d[d[field] + at] = value
        return dict(fs, desc_host=d, desc=torch.as_tensor(
            d, device=a["x"].device))
    # compressed plans whose index lies out of range: the C entry point
    # refuses each, the wrapper raises and nothing is launched
    for bad in (corrupt(fa.O_COL, 5, plan.n_x),
                corrupt(fa.O_QIDX, 0, -1),
                corrupt(fa.O_GNDST, 3, plan.arrow_len),
                corrupt(fa.O_GNENT, 0, plan.n_j << 16),
                corrupt(fa.O_RLEN, plan.m - 1, 1 << 20)):
        with pytest.raises(RuntimeError, match="cudaError"):
            call(fs=bad)
    assert fa.fused_inner.launches == before

    # lane counts the kernel does not take, and a block too large for
    # shared memory (H_NV raised by an eighth of the block limit in floats:
    # every index stays in range, a block of one lane still fits, one of
    # two does not): refused with cudaErrorInvalidValue, the outputs
    # untouched; the same call with a valid plan and two lanes runs
    invalid = 1                                     # cudaErrorInvalidValue
    desc = np.ascontiguousarray(fs["desc_host"], dtype=np.int32)
    big = desc.copy()
    big[fa.H_NV] += fa.SMEM_BLOCK_MAX // 8
    assert fa.kernel_smem_bytes(big, 1) <= fa.SMEM_BLOCK_MAX \
        < fa.kernel_smem_bytes(big, 2)
    for d, lanes in ((desc, 0), (desc, fa.MAX_LANES + 1), (big, 2)):
        err, out = _c_launch(plan, fs, a, opt, d, lanes)
        assert err == invalid, (lanes, err)
        assert all(bool(torch.isnan(t).all()) for t in out)
    err, out = _c_launch(plan, fs, a, opt, desc, 2)  # the same call, valid
    assert err == 0 and all(bool(torch.isfinite(t).all()) for t in out)

"""The port's ALM modes held to the JAX package's on small NLPs.

The generic mode (AD every iteration; Gauss-Newton or the saddle-free
``eigh`` Hessian) runs the small NLPs of tests/test_solver.py; the dense
quadratic mode runs linear-objective problems with quadratic constraints
(its closed form assumes a linear objective).  Each case runs at B = 1 and
on a batch of 3 (the JAX solver under ``vmap``), from the same numpy
inputs, in float64 on the CPU: x within 1e-9, and ``diagnose`` (the
violation, stationarity, rho and every row's violation) of the same state
within 1e-9 of each value's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tools_tpu.ops.alm import (ALMOptions as JOptions,
                                   detect_quadratic_structure as j_detect,
                                   make_alm_solver as j_make)
from omg_tools_torch.interop import state_from_numpy
from omg_tools_torch.ops.alm import (ALMOptions, detect_quadratic_structure,
                                     make_alm_solver)
from omg_tools_torch.ops.solver import BIG

TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These eager solves are small: torch's intra-op threads only spin
    beside the other test processes.  One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(xp, parts):
    return xp.stack(parts) if xp is jnp else torch.stack(parts)


# (name, n_x, n_p, f(x, p, xp), g(x, p, xp), lb, ub, x0, p0): xp is jnp or
# torch, so that one definition serves both packages
def _qp_ineq():
    return (2, 1, lambda x, p, xp: x @ x,
            lambda x, p, xp: _stack(xp, [x[0] + x[1]]),
            [1.0], [BIG], [0.0, 0.0], [0.0])


def _qp_eq():
    return (2, 1, lambda x, p, xp: x @ x + p[0] * x[0],
            lambda x, p, xp: _stack(xp, [x[0] + x[1]]),
            [1.0], [1.0], [0.0, 0.0], [0.0])


def _box_upper():
    return (1, 1, lambda x, p, xp: (x[0] - 2.0) ** 2,
            lambda x, p, xp: _stack(xp, [x[0]]), [0.0], [1.0], [0.5], [0.0])


def _hs071():
    def g(x, p, xp):
        cat = jnp.concatenate if xp is jnp else torch.cat
        return cat([_stack(xp, [x[0] * x[1] * x[2] * x[3], x @ x]), x])
    return (4, 1,
            lambda x, p, xp: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2], g,
            [25.0, 40.0, 1, 1, 1, 1], [BIG, 40.0, 5, 5, 5, 5],
            [1.0, 5.0, 5.0, 1.0], [0.0])


def _shutdown():
    # built with x <= 1, solved with the bound widened to BIG: x -> 2
    return (1, 1, lambda x, p, xp: (x[0] - 2.0) ** 2,
            lambda x, p, xp: _stack(xp, [x[0]]), [-BIG], [BIG], [0.0], [0.0])


def _shifted_qp():
    # tests/test_solver.py's batch: min |x - p|^2 s.t. x >= 0
    return (2, 2, lambda x, p, xp: ((x - p) ** 2).sum(),
            lambda x, p, xp: x, [0.0, 0.0], [BIG, BIG], [0.5, 0.5],
            [-1.0, 2.0])


GENERIC = {"qp_inequality": _qp_ineq, "qp_equality": _qp_eq,
           "box_active_upper": _box_upper, "hs071": _hs071,
           "shutdown_widened_bounds": _shutdown, "shifted_qp": _shifted_qp}
BUILD_BOUNDS = {"shutdown_widened_bounds": ([-BIG], [1.0])}


# linear objectives with quadratic constraints (the dense quadratic mode)
def _disc():
    # min -x0 - 2 x1 + p0 x0  s.t.  |x|^2 <= 1, x0 >= 0.6: two active rows
    # at the optimum (0.6, 0.8), so that the Gauss-Newton Hessian (the
    # constraints' curvature left out) is regular there
    return (2, 1, lambda x, p, xp: -x[0] - 2.0 * x[1] + p[0] * x[0],
            lambda x, p, xp: _stack(xp, [x @ x, x[0]]),
            [-BIG, 0.6], [1.0, BIG], [0.1, 0.1], [0.0])


def _hyperbola():
    # min x0 + x1 + x2  s.t.  x0 x1 = 1 + p0, x2^2 + x0 >= 2, 0 <= x <= 3
    def g(x, p, xp):
        return _stack(xp, [x[0] * x[1] - p[0], x[2] * x[2] + x[0], x[0],
                           x[1], x[2]])
    return (3, 1, lambda x, p, xp: x[0] + x[1] + x[2], g,
            [1.0, 2.0, 0.0, 0.0, 0.0], [1.0, BIG, 3.0, 3.0, 3.0],
            [1.5, 1.5, 1.5], [0.0])


QUADRATIC = {"disc": _disc, "hyperbola": _hyperbola}


def _batch(spec, B, seed):
    """x0 (B, n) and p (B, n_p): the case's own at B = 1, numpy-seeded
    perturbations of it otherwise."""
    n, n_p, _, _, _, _, x0, p0 = spec
    x0 = np.tile(np.asarray(x0, np.float64), (B, 1))
    p0 = np.tile(np.asarray(p0, np.float64), (B, 1))
    if B > 1:
        rng = np.random.default_rng(seed)
        x0 += rng.uniform(-0.1, 0.1, x0.shape)
        p0 += rng.uniform(-0.3, 0.3, p0.shape)
    return x0, p0


def _solvers(spec, opt, lb0, ub0, Q=None):
    n, _, f, g, *_ = spec
    js = j_make(lambda x, p: f(x, p, jnp), lambda x, p: g(x, p, jnp), n,
                lb0, ub0, JOptions(**opt), quadratic_Q=Q)
    ts = make_alm_solver(lambda x, p: f(x, p, torch),
                         lambda x, p: g(x, p, torch), n, lb0, ub0,
                         ALMOptions(**opt), quadratic_Q=Q)
    return js, ts


def _run_both(js, ts, x0, p0, lb, ub, jstate=None, tstate=None,
              outer_iter=None):
    lbj, ubj = jnp.asarray(lb), jnp.asarray(ub)
    if jstate is None:
        jst = jax.vmap(lambda x, p: js(x, p, lbj, ubj,
                                       outer_iter=outer_iter))(
            jnp.asarray(x0), jnp.asarray(p0))
    else:
        jst = jax.vmap(lambda x, p, s: js(x, p, lbj, ubj, state0=s,
                                          outer_iter=outer_iter))(
            jnp.asarray(x0), jnp.asarray(p0), jstate)
    tst = ts(torch.as_tensor(x0), torch.as_tensor(p0), lb, ub,
             state0=tstate, outer_iter=outer_iter)
    return jst, tst


def _check(js, ts, jst, tst, p0, lb, ub):
    """x within TOL; the port's diagnose of the JAX package's state against
    the JAX package's (the same state: an unconverged solve's stationarity
    amplifies a 1e-10 difference in x by its penalty, up to 1e4)."""
    np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(tst.n_iter.numpy(), np.asarray(jst.n_iter))
    same = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst),
                            device="cpu")
    got = ts.diagnose(same, torch.as_tensor(p0), lb, ub)
    for b in range(p0.shape[0]):
        lane = jax.tree_util.tree_map(lambda a: a[b], jst)
        want = js.diagnose(lane, jnp.asarray(p0[b]), jnp.asarray(lb),
                           jnp.asarray(ub))
        for key in ("feas", "stat", "rho", "row_viol"):
            w = np.asarray(want[key], np.float64)
            scale = max(1.0, float(np.max(np.abs(w))))
            np.testing.assert_allclose(got[key][b], w, rtol=0,
                                       atol=TOL * scale, err_msg=key)


# HS071 under Gauss-Newton does not converge in the 320-iteration budget
# (stationarity 50-600): the unconverged iteration amplifies rounding, so
# the JAX package's own x moves ~1e-7 when x0 moves by 1e-15
# (test_unconverged_gauss_newton_within_jax_sensitivity)
# every case at B = 1; the batch of 3 on the cases with a parameter (the
# per-iteration cost is the host's, so a batch costs what a lane does)
CASES = [(name, hes, 1) for name in sorted(GENERIC) for hes in ("gn", "eigh")
         if (name, hes) != ("hs071", "gn")] \
    + [(name, hes, 3) for name in ("qp_equality", "shifted_qp")
       for hes in ("gn", "eigh")]


@pytest.mark.parametrize("name,hessian,B", CASES)
def test_generic_mode_matches_jax(name, hessian, B):
    spec = GENERIC[name]()
    n, n_p, f, g, lb, ub, _, _ = spec
    lb0, ub0 = BUILD_BOUNDS.get(name, (lb, ub))
    js, ts = _solvers(spec, {"hessian": hessian}, np.asarray(lb0, float),
                      np.asarray(ub0, float))
    x0, p0 = _batch(spec, B, seed=len(name))
    lb, ub = np.asarray(lb, float), np.asarray(ub, float)
    jst, tst = _run_both(js, ts, x0, p0, lb, ub)
    _check(js, ts, jst, tst, p0, lb, ub)


@pytest.mark.parametrize("B", [1, 3])
def test_unconverged_gauss_newton_within_jax_sensitivity(B):
    """HS071 under Gauss-Newton, full budget: the port within 1e-9 of the
    JAX package's x or, where rounding has been amplified, within the JAX
    package's own move under a 1e-15 relative perturbation of x0; and to
    1e-9 over the first two outer rounds, before the amplification."""
    spec = _hs071()
    lb, ub = np.asarray(spec[4], float), np.asarray(spec[5], float)
    x0, p0 = _batch(spec, B, seed=len("hs071"))
    js, ts = _solvers(spec, {"hessian": "gn"}, lb, ub)
    jst, tst = _run_both(js, ts, x0, p0, lb, ub)
    rng = np.random.default_rng(1)
    jst1, _ = _run_both(js, ts, x0 * (1 + 1e-15 * rng.standard_normal(
        x0.shape)), p0, lb, ub)
    own = float(np.abs(np.asarray(jst1.x) - np.asarray(jst.x)).max())
    err = float(np.abs(tst.x.numpy() - np.asarray(jst.x)).max())
    assert err <= max(TOL, own), (err, own)
    js, ts = _solvers(spec, {"hessian": "gn", "outer_iter": 2}, lb, ub)
    jst, tst = _run_both(js, ts, x0, p0, lb, ub)
    _check(js, ts, jst, tst, p0, lb, ub)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("hessian", ["gn", "eigh"])
def test_warm_start_reuse_matches_jax(hessian, B):
    """A second solve warm-started from the first's state (x, lam, rho)
    with a small outer budget, after the targets moved."""
    spec = _shifted_qp()
    js, ts = _solvers(spec, {"hessian": hessian}, np.zeros(2),
                      np.full(2, BIG))
    lb, ub = np.zeros(2), np.full(2, BIG)
    x0, p0 = _batch(spec, B, seed=7)
    jst, tst = _run_both(js, ts, x0, p0, lb, ub)
    p1 = p0 + 0.01
    jst2, tst2 = _run_both(js, ts, np.asarray(jst.x), p1, lb, ub,
                           jstate=jst, tstate=tst, outer_iter=2)
    _check(js, ts, jst2, tst2, p1, lb, ub)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("name", sorted(QUADRATIC))
def test_dense_quadratic_mode_matches_jax(name, B):
    spec = QUADRATIC[name]()
    n, n_p, f, g, lb, ub, _, p_ref = spec
    Q = detect_quadratic_structure(lambda x, p: g(x, p, torch), n,
                                   torch.as_tensor(p_ref, dtype=torch.float64),
                                   f=lambda x, p: f(x, p, torch))
    Qj = j_detect(lambda x, p: g(x, p, jnp), n, jnp.asarray(p_ref),
                  f=lambda x, p: f(x, p, jnp))
    assert Q is not None and Qj is not None
    np.testing.assert_allclose(Q, Qj, rtol=0, atol=1e-12)
    lb, ub = np.asarray(lb, float), np.asarray(ub, float)
    js, ts = _solvers(spec, {}, lb, ub, Q=Qj)
    assert np.array_equal(ts.Q_scaled, np.asarray(js.Q_scaled))
    x0, p0 = _batch(spec, B, seed=3)
    jst, tst = _run_both(js, ts, x0, p0, lb, ub)
    _check(js, ts, jst, tst, p0, lb, ub)
    # the eigh Hessian on the same quadratic form
    js, ts = _solvers(spec, {"hessian": "eigh"}, lb, ub, Q=Qj)
    jst, tst = _run_both(js, ts, x0, p0, lb, ub)
    _check(js, ts, jst, tst, p0, lb, ub)


def test_quadratic_detection_rejects_a_nonlinear_objective():
    spec = _qp_ineq()
    n, _, f, g, *_ = spec
    assert detect_quadratic_structure(
        lambda x, p: g(x, p, torch), n, torch.zeros(1, dtype=torch.float64),
        f=lambda x, p: f(x, p, torch)) is None


def test_dense_quadratic_mode_takes_cA_and_Q():
    """The dense quadratic mode given its affine part cA = (c, A, f0, gf)
    in raw units and the scaled Q (``solve.Q_scaled``) as arguments, as a
    batched runner passes them, with row and objective scaling: x equal to
    the solve that takes them by its own AD at x = 0, and within 1e-9 of
    the JAX package's solve given the same cA and Q."""
    spec = _hyperbola()
    n, n_p, f, g, lb, ub, _, p_ref = spec
    lb, ub = np.asarray(lb, float), np.asarray(ub, float)
    Q = j_detect(lambda x, p: g(x, p, jnp), n, jnp.asarray(p_ref),
                 f=lambda x, p: f(x, p, jnp))
    scaling = dict(quadratic_Q=Q, row_scale=np.linspace(0.5, 2.0, len(lb)),
                   obj_scale=0.7)
    js = j_make(lambda x, p: f(x, p, jnp), lambda x, p: g(x, p, jnp), n,
                lb, ub, JOptions(), **scaling)
    ts = make_alm_solver(lambda x, p: f(x, p, torch),
                         lambda x, p: g(x, p, torch), n, lb, ub,
                         ALMOptions(), **scaling)
    x0, p0 = _batch(spec, 3, seed=5)
    P = torch.as_tensor(p0)
    zero = torch.zeros(n, dtype=torch.float64)

    def gt(x, p):
        return g(x, p, torch)

    def ft(x, p):
        return f(x, p, torch)
    cA = tuple(torch.stack([fn(zero, p) for p in P]) for fn in (
        gt, torch.func.jacfwd(gt), ft, torch.func.grad(ft)))
    own = ts(torch.as_tensor(x0), P, lb, ub)
    given = ts(torch.as_tensor(x0), P, lb, ub, cA=cA,
               Q=torch.as_tensor(ts.Q_scaled))
    np.testing.assert_array_equal(given.x.numpy(), own.x.numpy())
    Qj = jnp.asarray(js.Q_scaled)
    lbj, ubj = jnp.asarray(lb), jnp.asarray(ub)
    want = jax.vmap(lambda x, p, *a: js(x, p, lbj, ubj, cA=a, Q=Qj))(
        jnp.asarray(x0), jnp.asarray(p0), *(jnp.asarray(a.numpy())
                                            for a in cA))
    np.testing.assert_allclose(given.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=TOL)

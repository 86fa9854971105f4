"""Independent CPU reference NLP solver, the parity trust anchor
(counterpart of ``omg_tools_tpu.ops.refsolver``).

omgtools anchors on a CasADi+Ipopt solve; here scipy's SLSQP, an
independent and mature SQP implementation, solves the *same* transcribed
NLP (the same objective and constraint functions, bounds and parameters)
in float64 on the host CPU, whatever device the problem runs on.  The ALM
solvers are held to it: ``tools/parity.py``'s open-loop control parity.

The solver has the ``solve(x0, p, lb, ub, state0=None)`` protocol of
``ops/alm.py``, so that ``Problem`` takes it as its ``"scipy"`` backend.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, jacfwd

from .solver import BIG

__all__ = ["RefState", "make_ref_solver"]


class RefState(NamedTuple):
    x: np.ndarray       # (n,)
    feas: np.ndarray    # () raw-unit constraint violation (inf-norm)
    stat: np.ndarray    # () 0 when feasible to 1e-4, else 1
    n_iter: np.ndarray  # () iterations

    @property
    def kkt_err(self):
        return np.maximum(self.feas, self.stat)


def _host64(a):
    """A float64 numpy copy of a numpy array or tensor on any device."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.array(a, dtype=np.float64)


def make_ref_solver(f: Callable, g: Callable, n_x: int,
                    lb0: np.ndarray, ub0: np.ndarray,
                    tol: float = 1e-7, max_iter: int = 300):
    """Build the reference solve function.  ``f(x, p)`` / ``g(x, p)`` are the
    transcription's functions of one scenario; they, the gradient of f and
    the Jacobian of g (``torch.func``) are evaluated on float64 CPU
    tensors.  Runtime ``lb/ub`` may differ from ``lb0/ub0`` (constraint
    shutdown masking), so the eq/ineq split happens per call."""
    grad_f = grad(f)
    jac_g = jacfwd(g)

    def solve(x0, p, lb, ub, state0: Optional[RefState] = None,
              outer_iter=None, **_ignored):
        from scipy.optimize import minimize

        x0 = _host64(x0)
        lb = _host64(lb)
        ub = _host64(ub)
        p_t = torch.as_tensor(_host64(p))
        eq = np.abs(ub - lb) < 1e-14
        has_lb = (~eq) & (lb > -BIG / 2)
        has_ub = (~eq) & (ub < BIG / 2)

        def at(fn, x):
            return fn(torch.as_tensor(x), p_t).numpy()

        # g and J at the last point asked for, shared across scipy's
        # per-constraint calls (each taken only when asked for)
        memo = {"x": None}

        def _eval(x, key):
            if memo["x"] is None or not np.array_equal(memo["x"], x):
                memo.clear()
                memo["x"] = x.copy()
            if key not in memo:
                memo[key] = at(g if key == "g" else jac_g, x)
            return memo[key]

        constraints = []
        if np.any(eq):
            constraints.append({
                "type": "eq",
                "fun": lambda x: _eval(x, "g")[eq] - lb[eq],
                "jac": lambda x: _eval(x, "J")[eq]})
        if np.any(has_ub):
            constraints.append({
                "type": "ineq",
                "fun": lambda x: ub[has_ub] - _eval(x, "g")[has_ub],
                "jac": lambda x: -_eval(x, "J")[has_ub]})
        if np.any(has_lb):
            constraints.append({
                "type": "ineq",
                "fun": lambda x: _eval(x, "g")[has_lb] - lb[has_lb],
                "jac": lambda x: _eval(x, "J")[has_lb]})

        def fun(x):
            return float(at(f, x))

        def jac(x):
            return at(grad_f, x)

        def _viol(x):
            gv = _eval(x, "g")
            return float(np.max(np.maximum(lb - gv, 0.0)
                                + np.maximum(gv - ub, 0.0), initial=0.0))

        def _try(start, method="SLSQP"):
            opts = {"maxiter": max_iter, "ftol": tol} if method == "SLSQP" \
                else {"maxiter": max_iter}
            r = minimize(fun, start, jac=jac, constraints=constraints,
                         method=method, options=opts)
            x = np.asarray(r.x, dtype=np.float64)
            return x, _viol(x), fun(x), r.nit

        # SLSQP can fail from degenerate warm starts (e.g. right after a
        # knot-passage shift); retry from perturbed starts and keep the best
        # feasible candidate -- the anchor must be the NLP's optimum, not
        # the first attempt
        feas_ok = 1e-4
        best = _try(x0)
        total_nit = best[3]
        if best[1] > feas_ok:
            rng = np.random.default_rng(0)
            for scale in (1e-3, 1e-2):
                cand = _try(x0 + scale * rng.standard_normal(n_x))
                total_nit += cand[3]
                if cand[1] < best[1] or (cand[1] <= feas_ok
                                         and cand[2] < best[2]):
                    best = cand
                if best[1] <= feas_ok:
                    break
        # polish: SLSQP restarted at its own best iterate (a fresh BFGS
        # estimate) usually clears the residual infeasibility it plateaus
        # at after a knot-passage shift
        for _ in range(2):
            if best[1] <= feas_ok:
                break
            cand = _try(best[0])
            total_nit += cand[3]
            if cand[1] < best[1] or (cand[1] <= feas_ok
                                     and cand[2] < best[2]):
                best = cand
            else:
                break
        # last resort: an independent interior-point restoration, only when
        # SLSQP is stuck above the anchor's acceptance level (1e-3, the
        # parity gate's)
        if best[1] > 1e-3:
            cand = _try(best[0], method="trust-constr")
            total_nit += cand[3]
            if cand[1] < best[1] or (cand[1] <= feas_ok
                                     and cand[2] < best[2]):
                best = cand
        x, feas, fval, _ = best
        return RefState(x=x, feas=np.float64(feas),
                        stat=np.float64(0.0 if feas <= feas_ok else 1.0),
                        n_iter=np.int64(total_nit))

    return solve

"""Batched primal-dual interior-point NLP solver, solver constants and
Ipopt-style row scaling (counterpart of ``omg_tools_tpu.ops.solver``).

The interior-point method (``make_ip_solver``, the ``ipm`` backend of
``Problem``) keeps the JAX package's algorithm step for step:

- g rows with lb == ub are equalities, all other rows get slacks with log
  barriers on their finite bounds; a monotone Fiacco-McCormick barrier
  schedule drives the complementarity (or the adaptive rule);
- one condensed Newton step an iteration: the Hessian of the Lagrangian
  plus the slacks' J_I' Sigma J_I, clamped to positive definite in its
  eigenbasis (``torch.linalg.eigh``, an eigenvalue floor and the adaptive
  regularization delta), then the KKT system with the equality rows or H
  alone (``torch.linalg.solve_ex``, which, like ``jnp.linalg.solve``,
  returns a singular system's non-finite solution instead of raising); a
  non-finite step is dropped;
- element-wise fraction-to-boundary projections of the slacks and bound
  duals, and a merit backtracking over ten fixed candidate steps,
  evaluated as one batch; no improving candidate rejects the step and
  raises delta;
- converged problems are frozen.

Every runtime tensor has a leading batch axis B (the JAX solver is written
per scenario and lifted by ``vmap``); the JAX ``fori_loop`` becomes a host
loop that stops once every lane has converged (frozen lanes keep their
state, so the result is the loop's).  One iteration takes three
evaluations of the problem: g, J, the Lagrangian's gradient and Hessian
from one forward-over-reverse pass (given ``fg``, one replay of a
transcription), f and g at the current point and the candidates from one
batched pass, and g and grad f at the new point from one reverse pass.

``torch.linalg.eigh`` and ``torch.linalg.solve_ex`` are library calls, as the
JAX package's ``jnp.linalg`` calls are: no Pallas kernel is on this path.
``eigh`` synchronizes with the host, so it is never captured: on a CUDA
card an iteration is two CUDA graphs (``ops.alm.CapturedCall``, a pair a
solver, batch size, dtype and device) with ``eigh`` run eagerly between
them, the first from the state to the condensed Hessian, the second from
its eigensystem to the next state.  Eagerly, an iteration's ~10,000
small launches cost ~290 ms on an H100 for examples/
p2p_holonomic_solvertest.py's scene (n_x 144); that scene does not
converge, in the JAX package either, so its updates run 60 iterations
and a retry.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

__all__ = ["IPState", "IPOptions", "make_ip_solver", "BIG",
           "gradient_row_scales"]

BIG = 1e20


class IPOptions(NamedTuple):
    max_iter: int = 40
    tol: float = 1e-4
    mu_init: float = 1e-2
    mu_min: float = 1e-9
    mu_kappa: float = 0.2      # geometric barrier decrease factor
    mu_theta: float = 1.5      # superlinear decrease exponent
    tau_min: float = 0.99      # fraction-to-boundary
    delta_w: float = 1e-7      # Hessian (inertia) regularization
    delta_c: float = 1e-8      # equality-block regularization
    slack_min: float = 1e-6
    kappa_sigma: float = 1e10  # dual safeguard vs primal iterate
    ls_candidates: tuple = (1.0, 0.7, 0.45, 0.3, 0.2, 0.12, 0.07, 0.04,
                            0.02, 0.01)
    nu_merit: float = 100.0    # minimum constraint-violation weight in merit
    mu_rule: str = "monotone"  # "monotone" (Fiacco-McCormick) or "adaptive"


class IPState(NamedTuple):
    x: torch.Tensor        # (B, n)
    s: torch.Tensor        # (B, mI) slacks of the inequality rows
    yE: torch.Tensor       # (B, mE) equality multipliers
    yI: torch.Tensor       # (B, mI) inequality multipliers
    zL: torch.Tensor       # (B, mI) lower-bound duals
    zU: torch.Tensor       # (B, mI) upper-bound duals
    mu: torch.Tensor       # (B,) barrier parameter
    delta: torch.Tensor    # (B,) adaptive regularization
    kkt_err: torch.Tensor  # (B,) convergence error
    n_iter: torch.Tensor   # (B,) iterations applied (int32)


def gradient_row_scales(jac_fn, x0, p0, max_gradient=100.0):
    """Ipopt-style gradient-based constraint scaling: rows whose Jacobian
    infinity-norm at the reference point exceeds ``max_gradient`` are scaled
    down (Ipopt's nlp_scaling_method=gradient-based)."""
    J = np.asarray(jac_fn(x0, p0))
    row_norm = np.max(np.abs(J), axis=1)
    return 1.0 / np.maximum(1.0, row_norm / max_gradient)


def _max_abs(a):
    """Per lane max |a| over the last axis, 0 over an empty one (the JAX
    package's ``jnp.max(jnp.abs(a), initial=0.0)``)."""
    if a.shape[-1] == 0:
        return torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
    return a.abs().amax(-1)


def make_ip_solver(f: Callable, g: Callable, n_x: int,
                   lb0: np.ndarray, ub0: np.ndarray,
                   options: IPOptions = IPOptions(),
                   row_scale: Optional[np.ndarray] = None,
                   obj_scale: float = 1.0,
                   fg: Optional[Callable] = None):
    """Build ``solve(x0, p, lb, ub, state0=None, max_iter=None,
    reslack=False)`` for

        min f(x, p)  s.t.  lb <= g(x, p) <= ub

    over a batch: x0 (B, n), p (B, n_p), lb/ub (m,) or (B, m) in raw units.
    ``f(x, p)`` and ``g(x, p)`` take one scenario's (n,) and (n_p,)
    tensors; ``fg(x, p) -> (f, g)`` gives both from one evaluation (a
    transcription's ``objective_and_constraints``).  The row
    classification (equality or inequality, which sides are bounded) is
    static, from (lb0, ub0); runtime bounds may widen rows to +/-BIG (the
    constraint shutdown) without changing it.

    ``row_scale`` / ``obj_scale`` are static scaling factors (see
    :func:`gradient_row_scales`); the solution is in original units.
    Returns the final IPState."""
    lb0 = np.asarray(lb0, dtype=np.float64)
    ub0 = np.asarray(ub0, dtype=np.float64)
    d_np = None
    if row_scale is not None:
        d_np = np.asarray(row_scale, dtype=np.float64)
        lb0 = np.where(lb0 > -BIG / 2, d_np * lb0, lb0)
        ub0 = np.where(ub0 < BIG / 2, d_np * ub0, ub0)
    m = lb0.shape[0]
    eq_rows = np.where((ub0 - lb0) <= 1e-12)[0]
    in_rows = np.where((ub0 - lb0) > 1e-12)[0]
    has_lb = (lb0[in_rows] > -BIG / 2)
    has_ub = (ub0[in_rows] < BIG / 2)
    mE, mI = len(eq_rows), len(in_rows)
    n_barrier = max(int(has_lb.sum() + has_ub.sum()), 1)
    opt = options
    _consts = {}

    def consts(dtype, device):
        """(d, eq_rows, in_rows, has_lb, has_ub, candidates) on
        ``device``, made once per (dtype, device) as plain tensors."""
        key = (dtype, device)
        if key not in _consts:
            with torch._C._DisableFuncTorch():
                _consts[key] = (
                    None if d_np is None else torch.as_tensor(
                        d_np, dtype=dtype, device=device),
                    torch.as_tensor(eq_rows, device=device),
                    torch.as_tensor(in_rows, device=device),
                    torch.as_tensor(has_lb, device=device),
                    torch.as_tensor(has_ub, device=device),
                    torch.as_tensor(opt.ls_candidates, dtype=dtype,
                                    device=device))
        return _consts[key]

    # the scaled functions of one scenario
    fg_raw = fg if fg is not None else (
        lambda x, p, f=f, g=g: (f(x, p), g(x, p)))

    def fg_s(x, p):
        fv, gv = fg_raw(x, p)
        d = consts(x.dtype, x.device)[0]
        return obj_scale * fv, (gv if d is None else d * gv)

    def derivatives(x, p, lam):
        """(f, g, grad L, J, Hess L) of one scenario at multipliers lam,
        L = f + g'lam, from one forward-over-reverse evaluation."""
        def lagrangian(x):
            fv, gv = fg_s(x, p)
            return fv + gv @ lam, (fv, gv)

        def outer(x):
            gL, (fv, gv) = grad(lagrangian, has_aux=True)(x)
            return torch.cat([gv, gL]), (fv, gv, gL)
        jac, (fv, gv, gL) = jacfwd(outer, has_aux=True)(x)
        # forward mode can promote a float32 tangent to float64
        jac = jac.to(x.dtype)
        return fv, gv, gL, jac[:m], jac[m:]

    def g_and_grad_f(x, p):
        gf, gv = grad(lambda x: fg_s(x, p), has_aux=True)(x)
        return gv, gf

    def scale_rt(lb, ub, dtype, device):
        lb = torch.as_tensor(lb, dtype=dtype, device=device)
        ub = torch.as_tensor(ub, dtype=dtype, device=device)
        d = consts(dtype, device)[0]
        if d is not None:
            lb = torch.where(lb > -BIG / 2, d * lb, lb)
            ub = torch.where(ub < BIG / 2, d * ub, ub)
        return lb, ub

    def init_state(x0, p, lb, ub, mu0=None):
        dtype, device = x0.dtype, x0.device
        B = x0.shape[0]
        _, eq_j, in_j, has_lb_j, has_ub_j, _ = consts(dtype, device)
        if mu0 is None:
            mu0 = torch.full((B,), opt.mu_init, dtype=dtype, device=device)
        gv = vmap(lambda x, p: fg_s(x, p)[1])(x0, p)
        lbI, ubI = lb[..., in_j], ub[..., in_j]
        width = ubI - lbI
        # place the slacks inside the interval at a distance proportional
        # to the initial violation: a violated row then allows a near-unit
        # fraction-to-boundary step towards feasibility instead of being
        # pinned against its bound
        gI = gv[:, in_j]
        viol = torch.clamp(lbI - gI, min=0.0) + torch.clamp(gI - ubI, min=0.0)
        pad = torch.minimum(0.45 * width,
                            torch.clamp(1.1 * viol + 1e-2, min=1e-2))
        s = torch.clamp(gI, torch.where(has_lb_j, lbI + pad, -BIG),
                        torch.where(has_ub_j, ubI - pad, BIG))
        mu_c = mu0[:, None]
        zL = torch.where(has_lb_j, mu_c / torch.clamp(s - lbI,
                                                      min=opt.slack_min),
                         0.0)
        zU = torch.where(has_ub_j, mu_c / torch.clamp(ubI - s,
                                                      min=opt.slack_min),
                         0.0)
        return IPState(
            x=x0, s=s, yE=torch.zeros((B, mE), dtype=dtype, device=device),
            yI=zU - zL, zL=zL, zU=zU, mu=mu0.to(dtype),
            delta=torch.full((B,), opt.delta_w, dtype=dtype, device=device),
            kkt_err=torch.full((B,), float("inf"), dtype=dtype,
                               device=device),
            n_iter=torch.zeros((B,), dtype=torch.int32, device=device))

    def merit(fv, gv, s, lb, ub, mu, nu):
        """Barrier merit with l1 constraint violation; the leading axes of
        fv/gv/s are the lanes (and candidates), mu/nu broadcast to them."""
        _, eq_j, in_j, has_lb_j, has_ub_j, _ = consts(fv.dtype, fv.device)
        lbI, ubI = lb[..., in_j], ub[..., in_j]
        barL = torch.where(has_lb_j,
                           torch.log(torch.clamp(s - lbI, min=1e-30)), 0.0)
        barU = torch.where(has_ub_j,
                           torch.log(torch.clamp(ubI - s, min=1e-30)), 0.0)
        viol = torch.sum(torch.abs(gv[..., in_j] - s), -1)
        if mE:
            viol = torch.sum(torch.abs(gv[..., eq_j] - lb[..., eq_j]), -1) \
                + viol
        return fv - mu * (torch.sum(barL, -1) + torch.sum(barU, -1)) \
            + nu * viol

    def slack_terms(s, yI, zL, zU, mu, gv, lbI, ubI):
        """The slacks' distances to their bounds, Sigma, the
        complementarity residuals, the condensed right-hand side's beta and
        the inequality residual rI = g_I - s."""
        has_lb_j, has_ub_j = consts(s.dtype, s.device)[3:5]
        mu_c = mu[:, None]
        sL = torch.where(has_lb_j, s - lbI, 1.0)
        sU = torch.where(has_ub_j, ubI - s, 1.0)
        SigL = torch.where(has_lb_j, zL / torch.clamp(sL, min=1e-12), 0.0)
        SigU = torch.where(has_ub_j, zU / torch.clamp(sU, min=1e-12), 0.0)
        Sig = SigL + SigU
        r_s = yI + zL - zU
        r_zL = torch.where(has_lb_j, zL * sL - mu_c, 0.0)
        r_zU = torch.where(has_ub_j, zU * sU - mu_c, 0.0)
        # the condensed right-hand side: beta collects the complementarity
        # residuals through the slack equation
        beta = -r_s - torch.where(has_lb_j,
                                  r_zL / torch.clamp(sL, min=1e-12), 0.0) \
            + torch.where(has_ub_j, r_zU / torch.clamp(sU, min=1e-12), 0.0)
        rI = gv[:, consts(s.dtype, s.device)[2]] - s
        return sL, sU, Sig, r_zL, r_zU, beta, rI

    def newton_system(x, s, yE, yI, zL, zU, mu, delta, p, lb, ub):
        """The first half of an iteration: f, g, J and the Lagrangian's
        gradient r_x = grad f + JE'yE + JI'yI and Hessian W, and the
        condensed Hessian H_raw = W + JI' Sigma JI (symmetrized)."""
        dtype, device = x.dtype, x.device
        B = x.shape[0]
        _, eq_j, in_j = consts(dtype, device)[:3]
        lam = torch.zeros((B, m), dtype=dtype, device=device)
        if mE:
            lam[:, eq_j] = yE
        lam[:, in_j] = yI
        fv, gv, r_x, J, W = vmap(derivatives)(x, p, lam)
        JI = J[:, in_j]
        Sig = slack_terms(s, yI, zL, zU, mu, gv, lb[:, in_j],
                          ub[:, in_j])[2]
        H_raw = W + JI.transpose(1, 2) @ (Sig[:, :, None] * JI)
        H_raw = 0.5 * (H_raw + H_raw.transpose(1, 2))
        return H_raw, fv, gv, r_x, J

    def take_step(evals, evecs, fv, gv, r_x, J, x, s, yE, yI, zL, zU, mu,
                  delta, p, lb, ub):
        """The second half, from the condensed Hessian's eigensystem: the
        regularized Newton step, the fraction-to-boundary projections, the
        merit line search, the dual safeguard, the KKT error at the new
        point and the barrier and regularization updates.  Returns the
        new (x, s, yE, yI, zL, zU, mu, delta, kkt_err)."""
        dtype, device = x.dtype, x.device
        B = x.shape[0]
        _, eq_j, in_j, has_lb_j, has_ub_j, cands = consts(dtype, device)
        lbE = lb[:, eq_j]
        lbI, ubI = lb[:, in_j], ub[:, in_j]
        mu_c = mu[:, None]
        JE = J[:, eq_j]
        JI = J[:, in_j]
        JIt = JI.transpose(1, 2)
        cE = gv[:, eq_j] - lbE
        sL, sU, Sig, r_zL, r_zU, beta, rI = slack_terms(
            s, yI, zL, zU, mu, gv, lbI, ubI)
        rhs_x = -r_x - (JIt @ (Sig * rI - beta)[:, :, None])[:, :, 0]

        # inertia correction: the condensed Hessian clamped to positive
        # definite in its eigenbasis (the batched analog of Ipopt's
        # delta_w loop: a descent direction for the merit line search)
        eig_floor = torch.clamp(1e-8 * evals.abs().amax(-1),
                                min=opt.delta_w) + delta
        evals_pd = torch.maximum(evals, eig_floor[:, None])
        H = (evecs * evals_pd[:, None, :]) @ evecs.transpose(1, 2)
        if mE:
            K = torch.cat([
                torch.cat([H, JE.transpose(1, 2)], 2),
                torch.cat([JE, (-opt.delta_c * torch.eye(
                    mE, dtype=dtype, device=device)).expand(B, mE, mE)],
                    2)], 1)
            rhs = torch.cat([rhs_x, -cE], 1)
            sol = torch.linalg.solve_ex(K, rhs)[0]
            dx, dyE = sol[:, :n_x], sol[:, n_x:]
        else:
            sol = torch.linalg.solve_ex(H, rhs_x)[0]
            dx, dyE = sol, torch.zeros((B, 0), dtype=dtype, device=device)

        bad = ~torch.isfinite(sol).all(-1)
        dx = torch.where(bad[:, None], 0.0, dx)
        dyE = torch.where(bad[:, None], 0.0, dyE)

        ds = (JI @ dx[:, :, None])[:, :, 0] + rI
        dzL = torch.where(has_lb_j,
                          -(r_zL + zL * ds) / torch.clamp(sL, min=1e-12), 0.0)
        dzU = torch.where(has_ub_j,
                          (-r_zU + zU * ds) / torch.clamp(sU, min=1e-12), 0.0)

        # element-wise fraction-to-boundary: each slack and dual is damped
        # on its own (one global step length would let a single pinned row
        # freeze the whole primal step): take the step, then project back
        # to a tau-fraction of its old distance to the boundary
        tau = torch.clamp(1.0 - mu, min=opt.tau_min)[:, None]
        lo = torch.where(has_lb_j, lbI + (1 - tau) * sL, -float("inf"))
        hi = torch.where(has_ub_j, ubI - (1 - tau) * sU, float("inf"))

        def project_z(z_t, z_old, active):
            return torch.where(active, torch.maximum(z_t, (1 - tau) * z_old),
                               0.0)

        # the merit backtracking over the fixed candidates, evaluated as
        # one batch; the violation weight must dominate the multipliers
        # for the merit to be exact
        nu = torch.clamp(2.0 * torch.maximum(_max_abs(yE), _max_abs(yI)),
                         min=opt.nu_merit)
        K_c = cands.shape[0]
        X_c = x[:, None, :] + cands[None, :, None] * dx[:, None, :]
        S_c = torch.clamp(s[:, None, :] + cands[None, :, None]
                          * ds[:, None, :], lo[:, None, :], hi[:, None, :])
        fv_c, gv_c = vmap(fg_s)(X_c.reshape(B * K_c, n_x),
                                p.repeat_interleave(K_c, 0))
        merits = merit(fv_c.reshape(B, K_c), gv_c.reshape(B, K_c, m), S_c,
                       lb[:, None, :], ub[:, None, :], mu_c, nu[:, None])
        merits = torch.where(torch.isfinite(merits), merits, float("inf"))
        m0 = merit(fv, gv, s, lb, ub, mu, nu)
        # the largest candidate that improves the merit; if none does,
        # reject the step (alpha = 0) and raise the regularization
        improves = merits < m0[:, None]
        first_improving = torch.argmax(improves.to(torch.int8), -1)
        any_improves = improves.any(-1)
        alpha = torch.where(any_improves, cands[first_improving], 0.0)
        bad = bad | ~any_improves
        a_c = alpha[:, None]

        x_n = x + a_c * dx
        s_n = torch.clamp(s + a_c * ds, lo, hi)
        yE_n = yE + a_c * dyE
        zL_n = project_z(zL + a_c * dzL, zL, has_lb_j)
        zU_n = project_z(zU + a_c * dzU, zU, has_ub_j)
        # the dual safeguard (Ipopt eq. 16): keep z in step with mu / s
        sL_n = torch.where(has_lb_j, torch.clamp(s_n - lbI, min=1e-12), 1.0)
        sU_n = torch.where(has_ub_j, torch.clamp(ubI - s_n, min=1e-12), 1.0)
        zL_n = torch.clamp(zL_n, mu_c / (opt.kappa_sigma * sL_n),
                           opt.kappa_sigma * mu_c / sL_n)
        zL_n = torch.where(has_lb_j, zL_n, 0.0)
        zU_n = torch.clamp(zU_n, mu_c / (opt.kappa_sigma * sU_n),
                           opt.kappa_sigma * mu_c / sU_n)
        zU_n = torch.where(has_ub_j, zU_n, 0.0)
        # slack-form optimality fixes yI = zU - zL identically
        yI_n = zU_n - zL_n

        # the KKT error at the new point (mu = 0 target), with Ipopt's
        # s_d/s_c normalization, so that degenerate active sets (large
        # multipliers of redundant coefficient-wise rows) do not stall the
        # barrier schedule
        gv_n, gf_n = vmap(g_and_grad_f)(x_n, p)
        r_x_n = gf_n
        if mE:
            r_x_n = r_x_n + (JE.transpose(1, 2) @ yE_n[:, :, None])[:, :, 0]
        r_x_n = r_x_n + (JIt @ yI_n[:, :, None])[:, :, 0]
        s_max = 100.0
        dual_l1 = torch.sum(torch.abs(yE_n), -1) \
            + torch.sum(torch.abs(yI_n), -1) + torch.sum(zL_n, -1) \
            + torch.sum(zU_n, -1)
        n_duals = mE + 3 * mI
        s_d = torch.clamp(dual_l1 / max(n_duals, 1), min=s_max) / s_max
        s_c = torch.clamp((torch.sum(zL_n, -1) + torch.sum(zU_n, -1))
                          / max(2 * mI, 1), min=s_max) / s_max
        err_x = _max_abs(r_x_n) / s_d
        err_E = _max_abs(gv_n[:, eq_j] - lbE)
        err_I = _max_abs(gv_n[:, in_j] - s_n)
        cL = torch.where(has_lb_j, zL_n * sL_n, 0.0)
        cU = torch.where(has_ub_j, zU_n * sU_n, 0.0)
        comp = torch.maximum(_max_abs(cL), _max_abs(cU)) / s_c
        err_xEI = torch.maximum(err_x, torch.maximum(err_E, err_I))
        err = torch.maximum(err_xEI, comp)

        # the monotone barrier update: shrink when the barrier-KKT error
        # is small
        comp_mu = torch.maximum(
            _max_abs(torch.where(has_lb_j, zL_n * sL_n - mu_c, 0.0)),
            _max_abs(torch.where(has_ub_j, zU_n * sU_n - mu_c, 0.0))) / s_c
        err_mu = torch.maximum(err_xEI, comp_mu)
        if opt.mu_rule == "adaptive":
            comp_avg = (torch.sum(cL, -1) + torch.sum(cU, -1)) / n_barrier
            mu_n = torch.clamp(0.1 * comp_avg, opt.mu_min,
                               opt.mu_init * 100)
        else:
            mu_n = torch.where(
                err_mu < 10.0 * mu,
                torch.clamp(torch.minimum(opt.mu_kappa * mu,
                                          mu ** opt.mu_theta),
                            min=opt.mu_min),
                mu)
        delta_n = torch.where(bad, torch.clamp(delta * 10.0, max=1.0),
                              torch.clamp(delta / 3.0, min=opt.delta_w))

        return x_n, s_n, yE_n, yI_n, zL_n, zU_n, mu_n, delta_n, err

    graphs = {}

    def step(state: IPState, p, lb, ub):
        """One iteration.  On a CUDA card its two halves are CUDA graphs
        (one pair a batch size, dtype and device) with the eigensolver,
        which synchronizes with the host, run eagerly between them."""
        x = state.x
        B = x.shape[0]
        args = (x, state.s, state.yE, state.yI, state.zL, state.zU, state.mu,
                state.delta, p, lb.expand(B, m), ub.expand(B, m))
        if x.device.type == "cuda":
            from .alm import CapturedCall
            key = (B, x.dtype, x.device)
            if key not in graphs:
                graphs[key] = (CapturedCall(newton_system, args), None)
            first, second = graphs[key]
            system = first(*args)
            evals, evecs = torch.linalg.eigh(system[0])
            rest = (evals, evecs) + tuple(system[1:]) + args
            if second is None:
                second = CapturedCall(take_step, rest)
                graphs[key] = (first, second)
            # the graph's outputs are its own buffers, overwritten by the
            # next replay
            out = tuple(a.clone() for a in second(*rest))
        else:
            system = newton_system(*args)
            evals, evecs = torch.linalg.eigh(system[0])
            out = take_step(evals, evecs, *system[1:], *args)
        return IPState(*out, n_iter=state.n_iter + 1)


    def solve(x0, p, lb, ub, state0: Optional[IPState] = None,
              max_iter: Optional[int] = None, reslack: bool = False):
        """Run the interior-point iteration on a batch.  Returns the final
        IPState.

        ``state0`` warm-starts the full primal-dual state; with
        ``reslack=True`` the slacks and bound duals are re-centred from
        g(x0) at a warm barrier value, keeping the equality multipliers
        (after a warm-start basis shift, which breaks the slacks'
        correspondence)."""
        lb, ub = scale_rt(lb, ub, x0.dtype, x0.device)
        n_it = opt.max_iter if max_iter is None else max_iter
        if state0 is None:
            state = init_state(x0, p, lb, ub)
        elif reslack:
            mu_warm = torch.clamp(state0.mu, min=1e-4)
            state = init_state(x0, p, lb, ub, mu0=mu_warm)._replace(
                yE=state0.yE)
        else:
            # the problem data changed: stale convergence flags must not
            # freeze the new solve
            state = state0._replace(
                kkt_err=torch.full_like(state0.kkt_err, float("inf")),
                n_iter=torch.zeros_like(state0.n_iter))
        for _ in range(n_it):
            done = state.kkt_err < opt.tol
            if bool(done.all()):
                break        # every lane frozen: the rest would change none
            new = step(state, p, lb, ub)
            # freeze the converged problems
            state = IPState(*[
                torch.where(done.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
                for a, b in zip(state, new)])
        return state

    def diagnose(st: IPState, p, lb, ub):
        """The raw KKT-error components at a state, per lane, as numpy
        arrays (host debugging)."""
        x, s = st.x, st.s
        lb, ub = scale_rt(lb, ub, x.dtype, x.device)
        B = x.shape[0]
        lb, ub = lb.expand(B, m), ub.expand(B, m)
        _, eq_j, in_j, has_lb_j, has_ub_j, _ = consts(x.dtype, x.device)
        lam = torch.zeros((B, m), dtype=x.dtype, device=x.device)
        if mE:
            lam[:, eq_j] = st.yE
        lam[:, in_j] = st.yI
        _, gv, r_x, _, _ = vmap(derivatives)(x, p, lam)
        lbI, ubI = lb[:, in_j], ub[:, in_j]
        sL = torch.where(has_lb_j, torch.clamp(s - lbI, min=1e-12), 1.0)
        sU = torch.where(has_ub_j, torch.clamp(ubI - s, min=1e-12), 1.0)

        def host(a):
            return a.detach().cpu().numpy()
        return {
            "err_x": host(_max_abs(r_x)),
            "err_E": host(_max_abs(gv[:, eq_j] - lb[:, eq_j])),
            "err_I": host(_max_abs(gv[:, in_j] - s)),
            "comp": host(torch.maximum(
                _max_abs(torch.where(has_lb_j, st.zL * sL, 0.0)),
                _max_abs(torch.where(has_ub_j, st.zU * sU, 0.0)))),
            "mu": host(st.mu),
            "row_err_I": host(torch.abs(gv[:, in_j] - s)),
        }

    solve.diagnose = diagnose
    # exposed internals (the bounds scaled as in solve())
    solve.init_state = lambda x0, p, lb, ub: init_state(
        x0, p, *scale_rt(lb, ub, x0.dtype, x0.device))
    solve.step = lambda st, p, lb, ub: step(
        st, p, *scale_rt(lb, ub, st.x.dtype, st.x.device))
    solve.masks = dict(eq_rows=eq_rows, in_rows=in_rows,
                       has_lb=has_lb, has_ub=has_ub)
    return solve

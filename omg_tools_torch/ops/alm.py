"""Batched augmented-Lagrangian (PHR) NLP solver, compact-arrow mode
(counterpart of ``omg_tools_tpu.ops.alm``).

- constraints lb <= g(x,p) <= ub via the Powell-Hestenes-Rockafellar
  augmented Lagrangian: with r = g + lam/rho and P = proj(r, [lb, ub]),
      L(x) = f(x) + rho/2 * || r - P ||^2  - ||lam||^2/(2 rho)
  whose gradient is grad f + J^T y_hat, y_hat = rho * (r - P);
- inner minimization by Gauss-Newton steps on the block-arrow system
  (head Schur complement over tail blocks, ``ops.compact``), solved with
  the K2 (tail blocks) and K1 (head) kernels, then a parallel Armijo
  search along the exact quadratic merit expansion -- or, given a
  ``FusedPlan``, every inner step of an outer round in one launch of K3
  (``ops.fused_alm``);
- outer updates: lam <- y_hat; rho grows when feasibility stalls.

Every runtime tensor carries an explicit leading batch axis B (the JAX
solver is written per scenario and lifted by ``vmap``); every reduction is
per lane.  The JAX ``while_loop`` under ``vmap`` becomes a host loop that
runs while any lane is active and freezes the lanes that are done.

Not ported yet: the dense-quadratic and generic (AD per iteration) modes,
the compact mode without an arrow partition, the saddle-free ``eigh``
Hessian and ``diagnose``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, jacfwd, jvp
from torch.profiler import record_function

from .solver import BIG
from .compact import CompactWork
from .fused_alm import fused_inner
from .psd_kernels import psd_solve, psd_solve_multi

__all__ = ["ALMState", "ALMOptions", "make_alm_solver",
           "detect_quadratic_structure"]


class ALMOptions(NamedTuple):
    outer_iter: int = 20
    inner_iter: int = 16
    tol: float = 1e-3          # stationarity tolerance (scaled space)
    feas_tol: float = 1e-5     # feasibility tolerance (scaled space)
    rho_init: float = 10.0
    rho_growth: float = 5.0
    rho_max: float = 1e4
    feas_decrease: float = 0.25  # required violation decrease per outer iter
    delta: float = 1e-8        # Hessian floor
    ls_candidates: tuple = (1.0, 0.5, 0.25, 0.1, 0.04, 0.015, 6e-3, 2.5e-3,
                            1e-3, 4e-4, 1.5e-4)
    armijo: float = 1e-4
    max_step: float = 10.0     # trust cap on ||dx||_inf
    gn_delta_rel: float = 1e-6  # GN ridge relative to the penalty scale


class ALMState(NamedTuple):
    x: torch.Tensor         # (B, n)
    lam: torch.Tensor       # (B, m) multiplier estimates
    rho: torch.Tensor       # (B,) penalty parameter
    feas: torch.Tensor      # (B,) constraint violation (inf-norm, scaled)
    stat: torch.Tensor      # (B,) stationarity residual (inf-norm, scaled)
    n_iter: torch.Tensor    # (B,) int32 total inner iterations applied
    feas_raw: Optional[torch.Tensor] = None  # (B,) violation in RAW units

    @property
    def kkt_err(self):
        return torch.maximum(self.feas, self.stat)


def detect_quadratic_structure(g, n_x, p_ref, x_probe=None, tol=1e-6,
                               f=None, frozen_idx=None):
    """If g(x, p) = c(p) + A(p) x + x^T Q(p_frozen) x with Q constant over
    the parameters that vary at run time, return Q as an (m, n, n) numpy
    tensor; else None.  Validated against a direct evaluation at a random
    probe point (the same numpy probe as the JAX package's).  Host AD:
    pass float64 CPU tensors."""
    p_ref = torch.as_tensor(p_ref)
    zero = torch.zeros(n_x, dtype=p_ref.dtype)
    # Hessian wrt x at (0, p_ref): rows of Q (forward-over-forward)
    Q = jacfwd(jacfwd(g))(zero, p_ref).numpy() * 0.5
    rng = np.random.default_rng(0)
    x_probe = rng.standard_normal(n_x) if x_probe is None else x_probe
    x_probe = torch.as_tensor(x_probe, dtype=p_ref.dtype)
    noise = rng.standard_normal(p_ref.shape[0]) * 0.1
    if frozen_idx is not None and len(frozen_idx):
        noise[np.asarray(frozen_idx)] = 0.0
    p_probe = p_ref + torch.as_tensor(noise, dtype=p_ref.dtype)
    c = g(zero, p_probe)
    A_x = jvp(lambda x: g(x, p_probe), (zero,), (x_probe,))[1]
    pred = c + A_x + torch.einsum("kij,i,j->k", torch.as_tensor(Q),
                                  x_probe, x_probe)
    direct = g(x_probe, p_probe)
    err = float((pred - direct).abs().max())
    scale = float(direct.abs().max()) + 1.0
    if err > tol * scale:
        return None
    if f is not None:
        # the compact path also assumes a linear objective
        g0 = grad(f)(zero, p_probe)
        g1 = grad(f)(x_probe, p_probe)
        if float((g1 - g0).abs().max()) > tol * (
                float(g0.abs().max()) + 1.0):
            return None
    return Q


def make_alm_solver(f: Callable, g: Callable, n_x: int,
                    lb0: np.ndarray, ub0: np.ndarray,
                    options: ALMOptions = ALMOptions(),
                    row_scale: Optional[np.ndarray] = None,
                    obj_scale: float = 1.0, compact=None, fused_plan=None):
    """Build ``solve(x0, p, lb, ub, state0=None, outer_iter=None, ct=...,
    fshared=...)``
    minimizing f s.t. lb <= g <= ub over a batch: x0 (B, n), p (B, n_p),
    lb/ub (m,) in raw units and transcription row order.

    ``compact``: an :class:`ops.compact.CompactStructure` with an arrow
    partition.  Callers pass the phase-resolved tensors as ``ct`` (from
    :func:`ops.compact.resolve_phase`).  Row scaling is baked into the
    compact tensors; lb/ub are scaled and permuted into the compact row
    order here.

    ``fused_plan``: an :class:`ops.fused_alm.FusedPlan` of ``compact``.
    Callers then pass one phase's shared operands as
    ``fshared=FusedPlan.slice_phase(shared, phase)`` instead of ``ct``, and
    each outer round is one :func:`ops.fused_alm.fused_inner` call."""
    if compact is None or compact.arrow is None:
        raise NotImplementedError(
            "omg_tools_torch ports the compact-arrow ALM mode only so far")
    lb0 = np.asarray(lb0, dtype=np.float64)
    m = lb0.shape[0]
    opt = options
    row_perm = np.asarray(compact.row_perm)
    d_np = None if row_scale is None else np.asarray(row_scale,
                                                     dtype=np.float64)
    inv_d_np = None if d_np is None else 1.0 / d_np[row_perm]
    _cache = {}

    def consts(dtype, device):
        key = (dtype, device)
        if key not in _cache:
            def t(a):
                return None if a is None else torch.as_tensor(
                    a, dtype=dtype, device=device)
            _cache[key] = (t(d_np), t(inv_d_np),
                           torch.as_tensor(row_perm, device=device),
                           t(np.asarray(opt.ls_candidates)),
                           None if fused_plan is None else torch.as_tensor(
                               fused_plan.pcols, device=device))
        return _cache[key]

    def _scale_rt(lb, ub, dtype, device):
        d, _, perm, _, _ = consts(dtype, device)
        lb = torch.as_tensor(lb, dtype=dtype, device=device)
        ub = torch.as_tensor(ub, dtype=dtype, device=device)
        if d is not None:
            lb = torch.where(lb > -BIG / 2, d * lb, lb)
            ub = torch.where(ub < BIG / 2, d * ub, ub)
        return lb[perm], ub[perm]

    def multiplier_estimate(gv, lam, rho, lb, ub):
        r = gv + lam / rho[:, None]
        return rho[:, None] * (r - torch.clamp(r, lb, ub))

    def penalty_term(gv, lam, rho, lb, ub):
        # gv/lam (B, ..., m); rho (B,)
        rb = rho.reshape((-1,) + (1,) * (gv.dim() - 1))
        r = gv + lam / rb
        return 0.5 * rho.reshape((-1,) + (1,) * (gv.dim() - 2)) \
            * ((r - torch.clamp(r, lb, ub)) ** 2).sum(-1)

    def arrow_newton_step(work, Jf, y_hat, active, rho):
        """Block-arrow Newton solve: factor every tail block with K2 (the
        Schur panels D^-1 [C' | r_b] in one multi-RHS call), Schur-complement
        onto the head, solve the head system with K1, back-substitute."""
        with record_function("alm.assemble"):
            S, D, C, r_h, r_b = work.arrow_system(Jf, y_hat, active, rho)
            h = S.shape[-1]
            bm = D.shape[-1]
            diag_max = torch.maximum(
                S.diagonal(dim1=-2, dim2=-1).abs().amax(-1),
                D.diagonal(dim1=-2, dim2=-1).abs().amax((-2, -1)))
            ridge = opt.gn_delta_rel * torch.clamp(diag_max, min=1.0) \
                + opt.delta
            eye_h = torch.eye(h, dtype=S.dtype, device=S.device)
            eye_b = torch.eye(bm, dtype=S.dtype, device=S.device)
            S = S + ridge[:, None, None] * eye_h
            D = D + ridge[:, None, None, None] * eye_b
            # W = D^-1 [C' | r_b] -- one multi-RHS solve over all tail blocks
            RHS = torch.cat([C.transpose(-1, -2), r_b[..., None]], dim=-1)
        with record_function("alm.tail_solve"):
            W = psd_solve_multi(D, RHS)                   # (B, k, b, h+1)
        with record_function("alm.schur"):
            WC = W[..., :h]                               # D^-1 C'
            wr = W[..., h]                                # D^-1 r_b
            S_t = S - torch.einsum("bkhc,bkcg->bhg", C, WC)
            r_t = r_h - torch.einsum("bkhc,bkc->bh", C, wr)
        with record_function("alm.head_solve"):
            dx_h = psd_solve(S_t.contiguous(), r_t.contiguous())
        with record_function("alm.back_substitute"):
            dx_b = wr - torch.einsum("bkch,bh->bkc", WC, dx_h)
            grad_ = work.arrow_scatter(r_h, r_b)
            dx = -work.arrow_scatter(dx_h, dx_b)
        return grad_, dx

    def inner_step(work, x, lam, rho, lb, ub):
        """One Newton step per lane: block-arrow system + exact-quadratic
        Armijo search over the candidate step lengths."""
        with record_function("alm.assemble"):
            Jf = work.jacobians(x)
            gv = work.g_from_J(x, Jf)
            y_hat = multiplier_estimate(gv, lam, rho, lb, ub)
            active = (y_hat.abs() > 0.0).to(x.dtype)
        grad_, dx = arrow_newton_step(work, Jf, y_hat, active, rho)
        with record_function("alm.line_search"):
            finite = torch.isfinite(dx).all(-1, keepdim=True)
            gnorm = torch.linalg.vector_norm(grad_, dim=-1, keepdim=True)
            dx = torch.where(finite, dx, -grad_ / torch.clamp(gnorm, min=1.0))
            dx_norm = dx.abs().amax(-1)
            dx = dx * torch.clamp(
                opt.max_step / torch.clamp(dx_norm, min=1e-12),
                max=1.0)[:, None]
            slope = (grad_ * dx).sum(-1)
            cands = consts(x.dtype, x.device)[3]
            fx = work.f(x)
            m0 = fx + penalty_term(gv, lam, rho, lb, ub)
            Jd = work.Jd(Jf, dx)
            qd = work.quad_dir(dx)
            df = dx @ work.gf(x)
            a = cands[None, :, None]
            g_a = gv[:, None, :] + a * Jd[:, None, :] \
                + (a * a) * qd[:, None, :]
            mvals = fx[:, None] + cands[None, :] * df[:, None] \
                + penalty_term(g_a, lam[:, None, :], rho, lb, ub)  # (B, L)
            ok = torch.isfinite(mvals) & (
                mvals <= m0[:, None]
                + opt.armijo * cands[None, :] * slope[:, None])
            pick = torch.argmax(ok.to(torch.int32), dim=-1)  # first acceptable
            alpha = torch.where(ok.any(-1), cands[pick],
                                torch.zeros_like(cands[pick]))
            return x + alpha[:, None] * dx, grad_.abs().amax(-1)

    def solve(x0, p, lb, ub, state0: Optional[ALMState] = None,
              outer_iter: Optional[int] = None, ct=None, fshared=None):
        if fshared is not None and fused_plan is None:
            raise ValueError("fshared needs a solver built with fused_plan")
        if fshared is None and ct is None:
            raise ValueError("the compact solver needs the resolved "
                             "tensors ct (ops.compact.resolve_phase) or the "
                             "fused kernel's fshared")
        dtype, device = x0.dtype, x0.device
        B = x0.shape[0]
        lb, ub = _scale_rt(lb, ub, dtype, device)
        inv_d = consts(dtype, device)[1]
        inf = torch.full((B,), float("inf"), dtype=dtype, device=device)
        zeros_i = torch.zeros((B,), dtype=torch.int32, device=device)
        if state0 is None:
            state = ALMState(
                x=x0, lam=torch.zeros((B, m), dtype=dtype, device=device),
                rho=torch.full((B,), opt.rho_init, dtype=dtype,
                               device=device),
                feas=inf, stat=inf, n_iter=zeros_i, feas_raw=inf)
        else:
            state = state0._replace(x=x0, feas=inf, stat=inf,
                                    n_iter=zeros_i, feas_raw=inf)
        n_outer = opt.outer_iter if outer_iter is None else outer_iter
        if fshared is not None:
            work = None
            pv = p[:, consts(dtype, device)[4]]
        else:
            work = CompactWork(compact, ct)
        # dtype-aware feasibility floor: in f32 the configured tolerance
        # sits below the roundoff of the scaled constraint evaluation
        feas_tol = max(opt.feas_tol, 1000.0 * torch.finfo(dtype).eps)

        def outer_body(st):
            if work is None:
                with record_function("alm.fused_inner"):
                    x_n, gv, stat = fused_inner(
                        fused_plan, fshared, st.x, st.lam, st.rho, pv, lb,
                        ub, opt, opt.inner_iter)
            else:
                x_n = st.x
                stat = inf
                for _ in range(opt.inner_iter):
                    x_n, stat = inner_step(work, x_n, st.lam, st.rho, lb,
                                           ub)
            with record_function("alm.outer_update"):
                if work is not None:
                    gv = work.g(x_n)
                y_hat = multiplier_estimate(gv, st.lam, st.rho, lb, ub)
                viol_rows = torch.clamp(lb - gv, min=0.0) \
                    + torch.clamp(gv - ub, min=0.0)
                feas_n = viol_rows.amax(-1)
                feas_raw_n = feas_n if inv_d is None else \
                    (viol_rows * inv_d).amax(-1)
                improved = feas_n <= torch.clamp(
                    opt.feas_decrease * torch.clamp(st.feas, max=1e6),
                    min=feas_tol)
                rho_n = torch.where(improved, st.rho,
                                    torch.clamp(st.rho * opt.rho_growth,
                                                max=opt.rho_max))
                return ALMState(x=x_n, lam=y_hat, rho=rho_n, feas=feas_n,
                                stat=stat, n_iter=st.n_iter + opt.inner_iter,
                                feas_raw=feas_raw_n)

        def active_lanes(st):
            done = (st.feas < feas_tol) & (st.stat < opt.tol)
            return ~done & (st.n_iter < n_outer * opt.inner_iter)

        # the batched while_loop: run while any lane is active; lanes that
        # are done keep their state
        active = active_lanes(state)
        while bool(active.any()):
            new = outer_body(state)
            state = ALMState(*[
                torch.where(active.reshape((-1,) + (1,) * (a.dim() - 1)),
                            b, a) for a, b in zip(state, new)])
            active = active_lanes(state)
        return state

    solve.options = opt
    solve.scale_bounds = _scale_rt
    return solve

"""Batched augmented-Lagrangian (PHR) NLP solver (counterpart of
``omg_tools_tpu.ops.alm``).

- constraints lb <= g(x,p) <= ub via the Powell-Hestenes-Rockafellar
  augmented Lagrangian: with r = g + lam/rho and P = proj(r, [lb, ub]),
      L(x) = f(x) + rho/2 * || r - P ||^2  - ||lam||^2/(2 rho)
  whose gradient is grad f + J^T y_hat, y_hat = rho * (r - P);
- inner minimization by Newton steps on H = W + rho J^T D J (D the
  active-row mask) and a parallel Armijo search over candidate step
  lengths, in one of these modes:
  - generic: J, g, f, grad f and the objective's Hessian by ``torch.func``
    AD every iteration, all from one forward-over-reverse evaluation of
    (f, g) (one replay of a transcription, given ``fg``), and f and g at
    every line-search candidate from one more; the Gauss-Newton H plus
    the objective's own Hessian (``hessian="gn"``, solved with K1) or the
    saddle-free exact Newton step in the eigenbasis of H
    (``hessian="eigh"``).  On a CUDA device the Gauss-Newton mode's
    Newton step and the outer round's constraint evaluation are CUDA
    graphs, captured once a solver, batch size and dtype and replayed:
    the evaluations' thousands of small ops cost one launch each
    (``eigh`` synchronizes with the host, so that mode runs eagerly);
  - dense quadratic (``quadratic_Q``): g = c + A x + x'Q x with constant
    Q, so J and g are einsums with AD once per solve, and the line search
    is exact along the step;
  - compact (``compact``): family-compacted einsums (``ops.compact``);
    with an arrow partition the Newton system is block-arrow (head Schur
    complement over tail blocks: K2 for the blocks, K1 for the head),
    without one the dense compact Hessian goes to K1 -- or, given a
    ``FusedPlan``, every inner step of an outer round is one launch of K3
    (``ops.fused_alm``);
- outer updates: lam <- y_hat; rho grows when feasibility stalls.

Every runtime tensor carries an explicit leading batch axis B (the JAX
solver is written per scenario and lifted by ``vmap``; a single problem is
B = 1); every reduction is per lane.  The JAX ``while_loop`` under
``vmap`` becomes a host loop that runs while any lane is active (one host
check an outer round) and freezes the lanes that are done.  Every
Cholesky goes through ``psd_solve`` / ``psd_solve_multi``: the kernels on
CUDA tensors, their plain versions on CPU tensors.
"""

from __future__ import annotations

import gc
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, grad_and_value, hessian, jacfwd, jvp, vmap
from torch.profiler import record_function

from .solver import BIG
from .compact import CompactWork
from .fused_alm import fused_inner
from .psd_kernels import psd_solve, psd_solve_multi
from .spline import keep_device_constants

__all__ = ["ALMState", "ALMOptions", "make_alm_solver",
           "detect_quadratic_structure", "CapturedCall"]


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
    eig_floor_rel: float = 1e-8  # relative eigenvalue floor ('eigh')
    hessian: str = "gn"        # 'gn' (Gauss-Newton + Cholesky); anything
    #                            else: 'eigh' (saddle-free exact Newton)
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


class CapturedCall:
    """``fn(*tensors) -> tuple of tensors`` captured in a CUDA graph on
    static copies of its arguments: a call copies its arguments in and
    replays the graph, and its outputs are the graph's own buffers,
    overwritten by the next call.  One eager run on a side stream first
    makes the device constants, libraries and handles that ``fn`` needs,
    so that the capture copies nothing from the host: the host constants
    it copies are kept (:func:`ops.spline.keep_device_constants`) as long
    as the graph.  Nothing in ``fn`` may read a value back to the host.
    K1's launches in a replay are counted at the replay
    (``psd_solve.launches`` and ``by_systems``); the capture launches
    nothing.  Every capture adds one to the class attribute ``captures``.

    Python's cyclic garbage collector is off during the capture: a dead
    reference cycle that holds an older graph (a G-code window's problem
    after its roll, a finished closed loop's) would be freed there, and
    freeing a graph inside a capture invalidates the capture."""

    captures = 0

    def __init__(self, fn, args):
        CapturedCall.captures += 1
        device = args[0].device
        self.inputs = [a.clone() for a in args]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with keep_device_constants() as self.constants:
            with torch.cuda.stream(side):
                fn(*self.inputs)
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            before = psd_solve.captured
            before_by = psd_solve.captured_by_systems.copy()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(self.graph):
                    self.outputs = fn(*self.inputs)
            finally:
                if collecting:
                    gc.enable()
        self.k1_launches = psd_solve.captured - before
        self.k1_by_systems = psd_solve.captured_by_systems - before_by

    def __call__(self, *args):
        for buf, a in zip(self.inputs, args):
            buf.copy_(a)
        self.graph.replay()
        psd_solve.launches += self.k1_launches
        psd_solve.by_systems.update(self.k1_by_systems)
        return self.outputs


def make_alm_solver(f: Callable, g: Callable, n_x: int,
                    lb0: np.ndarray, ub0: np.ndarray,
                    options: ALMOptions = ALMOptions(),
                    row_scale: Optional[np.ndarray] = None,
                    obj_scale: float = 1.0,
                    quadratic_Q: Optional[np.ndarray] = None,
                    compact=None, fused_plan=None,
                    fg: Optional[Callable] = None):
    """Build ``solve(x0, p, lb, ub, state0=None, outer_iter=None, cA=None,
    Q=None, ct=None, fshared=None)`` minimizing f s.t. lb <= g <= ub over a
    batch: x0 (B, n), p (B, n_p), lb/ub (m,) in raw units and transcription
    row order.  ``f(x, p)`` and ``g(x, p)`` take one scenario's (n,) and
    (n_p,) tensors; the solver lifts them with ``torch.func.vmap``.

    ``quadratic_Q``: constant (m, n, n) tensor from
    :func:`detect_quadratic_structure`.  The inner loop then uses the
    closed quadratic form, with AD only once per solve at x = 0 -- or none,
    given ``cA = (c, A, f0, gf)`` in raw units with a leading batch axis.
    ``Q``: the scaled tensor (``solve.Q_scaled``) already on the device,
    passed in place of the solver's own copy.

    ``compact``: an :class:`ops.compact.CompactStructure`; callers then pass
    the phase-resolved tensors as ``ct`` (from
    :func:`ops.compact.resolve_phase`).  Row scaling is baked into the
    compact tensors; lb/ub are scaled and permuted into the compact row
    order here.

    ``fused_plan``: an :class:`ops.fused_alm.FusedPlan` of ``compact``.
    Callers then pass one phase's shared operands as
    ``fshared=FusedPlan.slice_phase(shared, phase)`` instead of ``ct``, and
    each outer round is one :func:`ops.fused_alm.fused_inner` call.

    Without ``compact`` or ``quadratic_Q`` the solver is generic: J, g, the
    gradient and the objective's Hessian by AD at every iteration.
    ``fg(x, p) -> (f, g)`` gives both from one evaluation
    (``Transcription.objective_and_constraints``); without it the generic
    mode calls ``f`` and ``g`` apart."""
    lb0 = np.asarray(lb0, dtype=np.float64)
    m = lb0.shape[0]
    opt = options
    row_perm = None if compact is None else np.asarray(compact.row_perm)
    d_np = None if row_scale is None else np.asarray(row_scale,
                                                     dtype=np.float64)
    inv_d_np = None
    if d_np is not None:
        inv_d_np = 1.0 / d_np if row_perm is None else 1.0 / d_np[row_perm]
    Qs_np = None
    if quadratic_Q is not None:
        Qs_np = np.asarray(quadratic_Q, dtype=np.float64)
        if d_np is not None:
            Qs_np = Qs_np * d_np[:, None, None]
        # row-major, so that the einsums read it in place
        Qs_np = np.ascontiguousarray(Qs_np)
    _cache = {}

    def consts(dtype, device):
        """(d, 1/d in the solver's row order, row_perm, candidates, fused
        pcols, Qs) on ``device``; made once per (dtype, device), as plain
        tensors even when first asked for under a torch.func transform
        (a tensor lifted into a transform must not outlive it)."""
        key = (dtype, device)
        if key not in _cache:
            def t(a):
                return None if a is None else torch.as_tensor(
                    a, dtype=dtype, device=device)
            with torch._C._DisableFuncTorch():
                _cache[key] = (
                    t(d_np), t(inv_d_np),
                    None if row_perm is None else torch.as_tensor(
                        row_perm, device=device),
                    t(np.asarray(opt.ls_candidates)),
                    None if fused_plan is None else torch.as_tensor(
                        fused_plan.pcols, device=device),
                    t(Qs_np))
        return _cache[key]

    # the scaled functions of one scenario (the JAX solver's f and g)
    fg_raw = fg if fg is not None else (
        lambda x, p, f=f, g=g: (f(x, p), g(x, p)))   # the unscaled f, g
    if d_np is not None:
        f_raw, g_raw = f, g

        def f(x, p):
            return obj_scale * f_raw(x, p)

        def g(x, p):
            return consts(x.dtype, x.device)[0] * g_raw(x, p)

        def fg(x, p):
            fv, gv = fg_raw(x, p)
            return obj_scale * fv, consts(x.dtype, x.device)[0] * gv
    else:
        fg = fg_raw

    def derivatives(x, p):
        """(f, g, grad f, J, Hess f) of one scenario from one
        forward-over-reverse evaluation of (f, g)."""
        def outer(x):
            gf, (fv, gv) = grad_and_value(fg, has_aux=True)(x, p)
            return torch.cat([gv, gf]), (fv, gv, gf)
        jac, (fv, gv, gf) = jacfwd(outer, has_aux=True)(x)
        # torch's forward mode gives a 0-dim tensor combined with a Python
        # number a float64 tangent, whatever the tensor's dtype: bring
        # the float32 derivatives back to the iterate's dtype
        jac = jac.to(x.dtype)
        return fv, gv, gf, jac[:m], jac[m:]

    grad_f = grad(f)
    jac_g = jacfwd(g)

    def lagrangian(x, p, lam):
        return f(x, p) + g(x, p) @ lam

    hess_L = hessian(lagrangian)

    def scale_bounds(lb, ub, dtype, device, permute=True):
        """Runtime bounds scaled like the rows (and, for a compact solver,
        permuted into its row order unless ``permute`` is False)."""
        d, _, perm = consts(dtype, device)[:3]
        lb = torch.as_tensor(lb, dtype=dtype, device=device)
        ub = torch.as_tensor(ub, dtype=dtype, device=device)
        if d is not None:
            lb = torch.where(lb > -BIG / 2, d * lb, lb)
            ub = torch.where(ub < BIG / 2, d * ub, ub)
        if perm is not None and permute:
            return lb[perm], ub[perm]
        return lb, ub

    def multiplier_estimate(gv, lam, rho, lb, ub):
        r = gv + lam / rho[:, None]
        return rho[:, None] * (r - torch.clamp(r, lb, ub))

    def penalty_term(gv, lam, rho, lb, ub):
        # gv/lam (B, ..., m); rho (B,)
        rb = rho.reshape((-1,) + (1,) * (gv.dim() - 1))
        r = gv + lam / rb
        return 0.5 * rho.reshape((-1,) + (1,) * (gv.dim() - 2)) \
            * ((r - torch.clamp(r, lb, ub)) ** 2).sum(-1)

    def ridged(H):
        """H plus the Gauss-Newton ridge, relative to its largest diagonal."""
        scale = torch.clamp(H.diagonal(dim1=-2, dim2=-1).abs().amax(-1),
                            min=1.0)
        eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
        return H + (opt.gn_delta_rel * scale + opt.delta)[:, None, None] * eye

    def make_evals_compact(ct):
        work = CompactWork(compact, ct)
        return dict(mode="compact", work=work, g=work.g, f=work.f)

    def make_evals(p, dtype, device, cA=None, Q=None):
        """Per-solve evaluation handles for the dense quadratic or the
        generic mode (batched over p's leading axis)."""
        B = p.shape[0]
        if Qs_np is not None:
            if cA is not None:
                c_raw, A_raw, f0_raw, gf_raw = (
                    torch.as_tensor(a, dtype=dtype, device=device)
                    for a in cA)
                if d_np is not None:
                    d = consts(dtype, device)[0]
                    cC = d * c_raw
                    A = d[:, None] * A_raw
                    f0 = obj_scale * f0_raw
                    gf = obj_scale * gf_raw
                else:
                    cC, A, f0, gf = c_raw, A_raw, f0_raw, gf_raw
            else:
                zero = torch.zeros((B, n_x), dtype=dtype, device=device)
                cC = vmap(g)(zero, p)
                A = vmap(jac_g)(zero, p)
                f0 = vmap(f)(zero, p)
                gf = vmap(grad_f)(zero, p)   # the objective is linear in x
            Qs = consts(dtype, device)[5] if Q is None else Q

            def J_eval(x):
                return A + 2.0 * torch.einsum("kij,bj->bki", Qs, x)

            def g_from_J(x, J):
                # g(x) = c + A x + x'Q x = c + 0.5 (A + J(x)) x
                return cC + 0.5 * ((A + J) @ x[:, :, None])[:, :, 0]

            return dict(mode="quadratic", quadratic=True, J=J_eval,
                        g_from_J=g_from_J,
                        g=lambda x: g_from_J(x, J_eval(x)),
                        quad_dir=lambda d_: torch.einsum(
                            "kij,bi,bj->bk", Qs, d_, d_),
                        f=lambda x: f0 + (x * gf).sum(-1),
                        gf=lambda x: gf, Qs=Qs)

        def fg_along(X):
            """(f, g) at (B, L, n) points, the L points of a lane sharing
            its parameters."""
            L = X.shape[1]
            fv, gv = vmap(fg)(X.reshape(B * L, -1),
                              p.repeat_interleave(L, dim=0))
            return fv.reshape(B, L), gv.reshape(B, L, -1)

        return dict(mode="generic", quadratic=False,
                    g=lambda x: vmap(fg)(x, p)[1],
                    derivatives=lambda x: vmap(derivatives)(x, p),
                    HL=lambda x, y: vmap(hess_L)(x, p, y),
                    fg_along=fg_along)

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

    def newton_compact(evals, x, lam, rho, lb, ub):
        """The compact modes' Newton step: (grad, dx, gv, line-search
        closure of the exact quadratic merit expansion along dx)."""
        work = evals["work"]
        with record_function("alm.assemble"):
            Jf = work.jacobians(x)
            gv = work.g_from_J(x, Jf)
            y_hat = multiplier_estimate(gv, lam, rho, lb, ub)
            active = (y_hat.abs() > 0.0).to(x.dtype)
        if compact.arrow is not None:
            grad_, dx = arrow_newton_step(work, Jf, y_hat, active, rho)
        else:
            with record_function("alm.assemble"):
                grad_ = work.grad(Jf, y_hat)
                H = ridged(work.hessian(Jf, active, rho, 0.0))
            with record_function("alm.head_solve"):
                dx = -psd_solve(H.contiguous(), grad_.contiguous())

        def expansion(dx):
            return work.Jd(Jf, dx), work.quad_dir(dx), dx @ work.gf(x)
        return grad_, dx, gv, evals["f"](x), expansion

    def newton_dense(evals, x, lam, rho, lb, ub):
        """The dense quadratic and generic modes' Newton step."""
        with record_function("alm.assemble"):
            if evals["quadratic"]:
                J = evals["J"](x)                             # (B, m, n)
                gv = evals["g_from_J"](x, J)
                gf = evals["gf"](x)
            else:
                fx, gv, gf, J, Hf = evals["derivatives"](x)
            y_hat = multiplier_estimate(gv, lam, rho, lb, ub)
            Jt = J.transpose(1, 2)
            grad_ = gf + (Jt @ y_hat[:, :, None])[:, :, 0]
            active = (y_hat.abs() > 0.0).to(x.dtype)
            Hpen = rho[:, None, None] * ((Jt * active[:, None, :]) @ J)
        if opt.hessian == "gn":
            # Gauss-Newton: penalty curvature plus the objective's own
            # Hessian, which the quadratic mode's linear objective lacks
            if not evals["quadratic"]:
                Hpen = Hpen + Hf
            with record_function("alm.head_solve"):
                dx = -psd_solve(ridged(Hpen).contiguous(), grad_.contiguous())
        else:
            with record_function("alm.eigh"):
                if evals["quadratic"]:
                    W = 2.0 * torch.einsum("kij,bk->bij", evals["Qs"], y_hat)
                else:
                    W = evals["HL"](x, y_hat)
                H = W + Hpen
                H = 0.5 * (H + H.transpose(1, 2))
                ev, vecs = torch.linalg.eigh(H)
                # saddle-free Newton in the eigenbasis: negative curvature
                # uses |lambda|; the relative floor bounds the conditioning
                floor = torch.clamp(
                    opt.eig_floor_rel * ev.abs().amax(-1), min=opt.delta)
                ev_used = torch.maximum(ev.abs(), floor[:, None])
                coef = (vecs.transpose(1, 2) @ grad_[:, :, None])[:, :, 0]
                dx = -(vecs @ (coef / ev_used)[:, :, None])[:, :, 0]
        expansion = None
        if evals["quadratic"]:
            fx = evals["f"](x)

            def expansion(dx):
                return ((J @ dx[:, :, None])[:, :, 0], evals["quad_dir"](dx),
                        (gf * dx).sum(-1))
        return grad_, dx, gv, fx, expansion

    def inner_step(evals, x, lam, rho, lb, ub):
        """One Newton step per lane and the parallel Armijo search over the
        candidate step lengths (the merit exact along dx when g is
        quadratic, evaluated at every candidate otherwise)."""
        newton = newton_compact if evals["mode"] == "compact" \
            else newton_dense
        grad_, dx, gv, fx, expansion = newton(evals, x, lam, rho, lb, ub)
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
            m0 = fx + penalty_term(gv, lam, rho, lb, ub)
            if expansion is not None:
                Jd, qd, df = expansion(dx)
                a = cands[None, :, None]
                g_a = gv[:, None, :] + a * Jd[:, None, :] \
                    + (a * a) * qd[:, None, :]
                f_a = fx[:, None] + cands[None, :] * df[:, None]
            else:
                X = x[:, None, :] + cands[None, :, None] * dx[:, None, :]
                f_a, g_a = evals["fg_along"](X)
            mvals = f_a + penalty_term(g_a, lam[:, None, :], rho, lb, ub)
            ok = torch.isfinite(mvals) & (
                mvals <= m0[:, None]
                + opt.armijo * cands[None, :] * slope[:, None])
            pick = torch.argmax(ok.to(torch.int32), dim=-1)  # first acceptable
            alpha = torch.where(ok.any(-1), cands[pick],
                                torch.zeros_like(cands[pick]))
            return x + alpha[:, None] * dx, grad_.abs().amax(-1)

    def generic_step(x, lam, rho, lb, ub, p):
        """One Newton step of the generic mode: the function that the
        Gauss-Newton mode's CUDA graph captures."""
        return inner_step(make_evals(p, x.dtype, x.device), x, lam, rho,
                          lb, ub)

    def generic_g(x, p):
        return make_evals(p, x.dtype, x.device)["g"](x)

    graphs = {}

    def captured(x, lam, rho, lb, ub, p):
        """The Gauss-Newton generic mode's step and constraint evaluation
        as CUDA graphs, one pair a batch size, dtype and device."""
        key = (x.shape[0], x.dtype, x.device)
        if key not in graphs:
            graphs[key] = (CapturedCall(generic_step, (x, lam, rho, lb, ub, p)),
                           CapturedCall(generic_g, (x, p)))
        return graphs[key]

    def solve(x0, p, lb, ub, state0: Optional[ALMState] = None,
              outer_iter: Optional[int] = None, cA=None, Q=None, ct=None,
              fshared=None):
        if fshared is not None and fused_plan is None:
            raise ValueError("fshared needs a solver built with fused_plan")
        if compact is not None and fshared is None and ct is None:
            raise ValueError("the compact solver needs the resolved "
                             "tensors ct (ops.compact.resolve_phase) or the "
                             "fused kernel's fshared")
        dtype, device = x0.dtype, x0.device
        B = x0.shape[0]
        lb, ub = scale_bounds(lb, ub, dtype, device)
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
        evals = None
        if fshared is not None:
            pv = p[:, consts(dtype, device)[4]]
        elif ct is not None:
            evals = make_evals_compact(ct)
        else:
            evals = make_evals(p, dtype, device, cA=cA, Q=Q)
        if evals is not None and evals["mode"] == "generic" \
                and opt.hessian == "gn" and device.type == "cuda":
            step_graph, g_graph = captured(x0, state.lam, state.rho, lb, ub,
                                           p)

            def step(x, lam, rho):
                return step_graph(x, lam, rho, lb, ub, p)

            def g_at(x):
                return g_graph(x, p)
        elif evals is not None:
            def step(x, lam, rho):
                return inner_step(evals, x, lam, rho, lb, ub)
            g_at = evals["g"]
        # dtype-aware feasibility floor: in f32 the configured tolerance
        # sits below the roundoff of the scaled constraint evaluation
        feas_tol = max(opt.feas_tol, 1000.0 * torch.finfo(dtype).eps)

        def outer_body(st):
            if evals is None:
                with record_function("alm.fused_inner"):
                    x_n, gv, stat = fused_inner(
                        fused_plan, fshared, st.x, st.lam, st.rho, pv, lb,
                        ub, opt, opt.inner_iter)
            else:
                x_n = st.x
                stat = inf
                for _ in range(opt.inner_iter):
                    x_n, stat = step(x_n, st.lam, st.rho)
            with record_function("alm.outer_update"):
                if evals is not None:
                    gv = g_at(x_n)
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

    def diagnose(st: ALMState, p, lb, ub):
        """Per lane: the scaled violation, the stationarity residual
        |grad f + J'y|_inf (both by AD at st.x, in the transcription's row
        order), rho and the violation of every row, as numpy arrays."""
        x = st.x
        lb, ub = scale_bounds(lb, ub, x.dtype, x.device, permute=False)
        lam = st.lam
        if row_perm is not None:
            # a compact solver's multipliers are in its permuted row order
            lam = torch.empty_like(st.lam)
            lam[:, consts(x.dtype, x.device)[2]] = st.lam
        gv = vmap(g)(x, p)
        y_hat = multiplier_estimate(gv, lam, st.rho, lb, ub)
        grad_ = vmap(grad_f)(x, p) + (vmap(jac_g)(x, p).transpose(1, 2)
                                      @ y_hat[:, :, None])[:, :, 0]
        viol = torch.clamp(lb - gv, min=0.0) + torch.clamp(gv - ub, min=0.0)
        return {"feas": viol.amax(-1).cpu().numpy(),
                "stat": grad_.abs().amax(-1).cpu().numpy(),
                "rho": st.rho.cpu().numpy(),
                "row_viol": viol.cpu().numpy()}

    solve.options = opt
    # the generic mode's Newton step, uncaptured, and its evaluations
    # (tests and timing)
    solve.generic_step = generic_step
    solve.generic_evaluations = lambda x, p: make_evals(p, x.dtype, x.device)
    solve.scale_bounds = scale_bounds
    solve.diagnose = diagnose
    # the SCALED quadratic tensor (numpy), for callers that keep one copy
    # on the device and pass it back as solve's Q argument
    solve.Q_scaled = Qs_np
    return solve

"""Spline-coefficient transforms whose shift is a run-time value
(counterpart of ``omg_tools_tpu.ops.spline_jax``).

``shiftfirstknot_T(basis, t)`` re-expresses a spline on knots whose first
degree+1 entries move to ``t``: the ADMM x-update penalizes only the
future piece of the horizon through it (``problems.admm``).  ``t`` is a
tensor (a parameter of the transcription), so the transform is built on
the host as a matrix polynomial in the shift,

    T(t) = sum_j  u^j * C[j],     u = (t - t_lo) / (t_hi - t_lo),

and its evaluation is one small contraction.  For ``shiftfirstknot_T`` the
polynomial is exact: the transform composes degree+1 Boehm knot-insertion
steps whose weights are affine in t, so its entries are polynomials of
degree <= degree+1, reproduced to machine precision by a fit through
degree+2 Chebyshev samples.

The Cox-de Boor helpers at the end take the knots themselves as a
tensor (``eval_basis_traced``, ``greville_traced``), and
``shift_spline_T_traced`` builds the free-time re-basing transform of
``Basis.shift_spline_T`` from a tensor shift with one (n, n) solve.
The free-time problem itself re-bases on the host
(``problems.point2point.FreeTPoint2point.init_step``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .basis import Basis
from .spline import _const

__all__ = ["TransformPoly", "fit_transform_poly", "eval_transform",
           "shiftfirstknot_poly", "shiftfirstknot_T", "shift_knot1_fwd",
           "shift_knot1_bwd", "eval_basis_traced", "greville_traced",
           "shift_spline_T_traced"]


class TransformPoly(NamedTuple):
    """Matrix-valued polynomial T(t) = sum_j u^j C[j], u normalized."""
    C: np.ndarray        # (order+1, n_out, n_in) monomial coeffs in u
    t_lo: float
    t_hi: float
    fit_err: float       # max abs deviation at validation points


def fit_transform_poly(make_T, t_lo: float, t_hi: float,
                       order: int) -> TransformPoly:
    """Fit T(t) (a host function returning an (n_out, n_in) matrix) by a
    degree-``order`` matrix polynomial in u = (t - t_lo)/(t_hi - t_lo),
    interpolating at order+1 Chebyshev nodes.  Exact when every entry of
    T is a polynomial of degree <= order in t."""
    k = np.arange(order + 1)
    u_nodes = 0.5 * (1.0 - np.cos(np.pi * (k + 0.5) / (order + 1)))
    t_nodes = t_lo + (t_hi - t_lo) * u_nodes
    samples = np.stack([np.asarray(make_T(float(t)), dtype=np.float64)
                        for t in t_nodes])                 # (K, n_out, n_in)
    V = np.vander(u_nodes, order + 1, increasing=True)     # (K, K)
    C = np.linalg.solve(V, samples.reshape(order + 1, -1))
    C = C.reshape(order + 1, *samples.shape[1:])
    C[np.abs(C) < 1e-12] = 0.0
    # validated strictly inside the interval: at its ends make_T can be
    # degenerate (a shift onto the first interior knot makes that knot's
    # multiplicity degree+2); the polynomial is the continuous limit there
    u_val = np.linspace(0.0, 1.0, 2 * order + 5)[1:-1]
    err = 0.0
    for u in u_val:
        t = t_lo + (t_hi - t_lo) * u
        pred = np.einsum("j,jab->ab", u ** np.arange(order + 1), C)
        err = max(err, float(np.max(np.abs(
            pred - np.asarray(make_T(float(t)), dtype=np.float64)))))
    return TransformPoly(C=C, t_lo=float(t_lo), t_hi=float(t_hi),
                         fit_err=err)


def eval_transform(tp: TransformPoly, t):
    """T(t) as an (n_out, n_in) tensor on ``t``'s device and dtype; ``t``
    is a tensor scalar (possibly batched under ``torch.func``)."""
    C = _const(tp.C, t)
    denom = tp.t_hi - tp.t_lo
    u = (t - tp.t_lo) / (denom if denom else 1.0)
    order = C.shape[0] - 1
    pows = u[..., None] ** _const(np.arange(order + 1), t)
    return torch.einsum("...j,jab->...ab", pows, C)


def shiftfirstknot_poly(basis: Basis, t_hi: float = None) -> TransformPoly:
    """Exact matrix polynomial for ``basis.shiftfirstknot_T(t)`` with
    t in [knots[0], t_hi] (by default the first interior knot: the first
    knot never passes the first interval before a shift over the knot)."""
    def compute():
        d = basis.degree
        t_lo = float(basis.knots[0])
        hi = float(basis.knots[d + 1]) if t_hi is None else float(t_hi)
        tp = fit_transform_poly(
            lambda t: basis.shiftfirstknot_T(t) if t > t_lo
            else np.eye(len(basis)), t_lo, hi, order=d + 1)
        if tp.fit_err > 1e-8:
            raise RuntimeError(
                f"shiftfirstknot_T is not polynomial on this basis "
                f"(fit_err={tp.fit_err:.2e}) -- non-equidistant head knots?")
        return tp
    return basis._memoized(("shiftfirstknot_poly", t_hi), compute)


def shiftfirstknot_T(basis: Basis, t):
    """T(t): the (n, n) first-knot shift transform at the tensor ``t``."""
    return eval_transform(shiftfirstknot_poly(basis), t)


def shift_knot1_fwd(coeffs, basis: Basis, t):
    """Coefficients of the spline re-expressed on [t, end] knots;
    ``coeffs`` is (n,) or (n, k) (several splines on the basis)."""
    return shiftfirstknot_T(basis, t) @ coeffs


def shift_knot1_bwd(coeffs, basis: Basis, t):
    """Undo a first-knot shift.  T(t) acts only on the first degree+1
    coefficients (an upper-triangular head block), so the inverse is one
    small triangular solve."""
    d = basis.degree
    T = shiftfirstknot_T(basis, t)
    head = T[:d + 1, :d + 1]
    c = torch.as_tensor(coeffs)
    c_head = c[:d + 1].reshape(d + 1, -1)
    y = torch.linalg.solve_triangular(head, c_head, upper=True)
    return torch.cat([y.reshape(c[:d + 1].shape), c[d + 1:]])


# -- Cox-de Boor with tensor knots AND points ---------------------------------

def eval_basis_traced(knots, degree: int, x):
    """Branch-free Cox-de Boor: the (len(x), n_basis) collocation matrix
    with both ``knots`` and ``x`` tensors.  Matches
    ``ops.basis.eval_basis_matrix`` for clamped bases (the first degree+1
    indicator functions closed on the left); empty spans contribute
    zero."""
    knots = torch.as_tensor(knots)
    x = torch.atleast_1d(torch.as_tensor(x, dtype=knots.dtype,
                                         device=knots.device))
    nk = knots.shape[0]
    d = int(degree)
    lo, hi = knots[:-1], knots[1:]
    xe = x[:, None]
    closed_left = torch.arange(nk - 1, device=knots.device) < d + 1
    left_ok = torch.where(closed_left[None, :], xe >= lo[None, :],
                          xe > lo[None, :])
    b = (left_ok & (xe <= hi[None, :])).to(x.dtype)     # (npts, nk-1)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for r in range(1, d + 1):
        den1 = knots[r:nk - 1] - knots[:nk - 1 - r]     # (nk-1-r,)
        den2 = knots[r + 1:nk] - knots[1:nk - r]
        w1 = torch.where(den1 > 1e-14,
                         (xe - knots[None, :nk - 1 - r])
                         / torch.where(den1 > 1e-14, den1, 1.0)[None, :],
                         zero)
        w2 = torch.where(den2 > 1e-14,
                         (knots[None, r + 1:nk] - xe)
                         / torch.where(den2 > 1e-14, den2, 1.0)[None, :],
                         zero)
        b = w1 * b[:, :nk - 1 - r] + w2 * b[:, 1:nk - r]
    return b


def greville_traced(knots, degree: int):
    """Greville abscissae of a tensor knot vector."""
    knots = torch.as_tensor(knots)
    n = knots.shape[0] - degree - 1
    if degree == 0:
        return 0.5 * (knots[:-1] + knots[1:])
    idx = (torch.arange(n, device=knots.device)[:, None] + 1
           + torch.arange(degree, device=knots.device)[None, :])
    return torch.mean(knots[idx], dim=1)


def shift_spline_T_traced(basis: Basis, t):
    """The transform of ``basis.shift_spline_T(t)`` at a tensor ``t``
    (basis-domain units): the spline piece on [t, end] re-expressed in a
    fresh equidistant clamped basis over [t, end].  Its entries are only
    piecewise smooth in t, so the target knots and Greville points (affine
    in t) and both collocation matrices are built from ``t`` and one
    (n, n) solve gives T."""
    d, n = basis.degree, len(basis)
    n_knots = n - d + 1
    k_end = float(basis.knots[-1])
    t = torch.as_tensor(t)
    interior = t + (k_end - t) * torch.linspace(0.0, 1.0, n_knots,
                                                dtype=t.dtype,
                                                device=t.device)
    knots2 = torch.cat([t.expand(d), interior,
                        torch.full((d,), k_end, dtype=t.dtype,
                                   device=t.device)])
    g = greville_traced(knots2, d)
    # nudge coincident Greville points apart (degenerate only at
    # t == k_end), then clip back into the basis domain (a point past k_end
    # would zero its collocation row)
    g = torch.cummax(g + torch.arange(n, dtype=t.dtype, device=t.device)
                     * 1e-12, dim=0).values
    g = torch.minimum(torch.maximum(g, knots2[0]), knots2[-1])
    B_t = eval_basis_traced(knots2, d, g)                    # (n, n) target
    E_s = eval_basis_traced(_const(np.array(basis.knots), t), d, g)  # source
    return torch.linalg.solve(B_t, E_s)

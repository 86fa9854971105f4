"""B-spline objects over torch tensors.

A ``BSpline`` pairs a static host-side :class:`~.basis.Basis` with a torch
coefficient tensor.  All spline algebra (sum, product, derivative, integral,
evaluation) is a contraction against constant matrices computed once by the
basis engine, so it composes with ``torch.func.jacfwd``/``grad``/``vmap``.

Counterpart of ``omg_tools_tpu.ops.spline`` (the pytree registration and
the rational/tensor-product splines are not needed by the ported path).
"""

from __future__ import annotations

import numpy as np
import torch

from .basis import Basis

__all__ = ["BSpline", "eval_basis_traced", "evalspline", "running_integral",
           "definite_integral", "sample_spline"]


def _const(mat, like):
    """Host numpy constant as a tensor matching ``like``'s dtype/device."""
    return torch.as_tensor(np.asarray(mat), dtype=like.dtype,
                           device=like.device)


def _as_tensor(v):
    return v if isinstance(v, torch.Tensor) else \
        torch.as_tensor(np.asarray(v, dtype=np.float64))


def eval_basis_traced(basis: Basis, t):
    """Cox-de Boor basis values at a tensor scalar ``t`` (possibly batched
    under ``torch.func``).  Returns a (..., len(basis)) tensor."""
    k = [float(v) for v in basis.knots]
    d = basis.degree
    t = _as_tensor(t)
    nk = len(k)
    b = []
    for i in range(nk - 1):
        if i < d + 1 and k[0] == k[i]:
            b.append(((t >= k[i]) & (t <= k[i + 1])).to(t.dtype))
        else:
            b.append(((t > k[i]) & (t <= k[i + 1])).to(t.dtype))
    for deg in range(1, d + 1):
        nb = []
        for i in range(nk - deg - 1):
            val = torch.zeros_like(t)
            denom = k[i + deg] - k[i]
            if denom != 0.0:
                val = (t - k[i]) * b[i] / denom
            denom = k[i + deg + 1] - k[i + 1]
            if denom != 0.0:
                val = val + (k[i + deg + 1] - t) * b[i + 1] / denom
            nb.append(val)
        b = nb
    return torch.stack(b, dim=-1)


class BSpline:
    """Spline with static basis and tensor coefficients (shape (..., n))."""

    def __init__(self, basis: Basis, coeffs):
        self.basis = basis
        self.coeffs = _as_tensor(coeffs)

    def __len__(self):
        return len(self.basis)

    def __repr__(self):
        return f"BSpline({self.basis!r}, coeffs shape {tuple(self.coeffs.shape)})"

    # -- evaluation --------------------------------------------------------
    def __call__(self, x):
        """Evaluate at static numpy points (returns (..., len(x))) or at a
        tensor scalar (returns (...,))."""
        if isinstance(x, torch.Tensor):
            bvals = eval_basis_traced(self.basis, x.to(
                dtype=self.coeffs.dtype, device=self.coeffs.device))
            return torch.einsum("...i,i->...", self.coeffs, bvals)
        x_arr = np.atleast_1d(np.asarray(x, dtype=np.float64))
        E = _const(self.basis.eval(x_arr), self.coeffs)   # (len(x), n)
        out = torch.einsum("ti,...i->...t", E, self.coeffs)
        if np.isscalar(x) or np.ndim(x) == 0:
            return out[..., 0]
        return out

    # -- algebra -----------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, BSpline):
            if other.basis is self.basis:
                return BSpline(self.basis, self.coeffs + other.coeffs)
            basis = self.basis + other.basis
            Ts = _const(basis.transform(self.basis), self.coeffs)
            To = _const(basis.transform(other.basis), self.coeffs)
            return BSpline(basis, torch.einsum("qi,...i->...q", Ts, self.coeffs)
                           + torch.einsum("qi,...i->...q", To, other.coeffs))
        # scalar (partition of unity): add to every coefficient
        return BSpline(self.basis, self.coeffs + other)

    __radd__ = __add__

    def __neg__(self):
        return BSpline(self.basis, -self.coeffs)

    def __sub__(self, other):
        return self + (-other if isinstance(other, BSpline) else -1 * other)

    def __rsub__(self, other):
        return (-self) + other

    def __mul__(self, other):
        if isinstance(other, BSpline):
            prod, W = self.basis.product_tensor(other.basis)
            Wt = _const(W, self.coeffs)
            coeffs = torch.einsum("qij,...i,...j->...q", Wt, self.coeffs,
                                  other.coeffs)
            return BSpline(prod, coeffs)
        return BSpline(self.basis, self.coeffs * other)

    __rmul__ = __mul__

    def __pow__(self, p: int):
        if not isinstance(p, int) or p < 1:
            raise TypeError("exponent must be a positive integer")
        out = self
        for _ in range(p - 1):
            out = out * self
        return out

    # -- calculus ----------------------------------------------------------
    def derivative(self, o: int = 1) -> "BSpline":
        if o == 0:
            return self
        Bd, P = self.basis.derivative(o)
        return BSpline(Bd, torch.einsum("qi,...i->...q",
                                        _const(P, self.coeffs), self.coeffs))

    def integral(self):
        w = _const(self.basis.integral_weights(), self.coeffs)
        return torch.einsum("...i,i->...", self.coeffs, w)

    def scale(self, factor, shift=0.0) -> "BSpline":
        return BSpline(self.basis.scale(factor, shift), self.coeffs)


def evalspline(s: BSpline, t):
    """Evaluate a spline at a scalar t (a number or a tensor scalar), on
    the coefficients' device."""
    bvals = eval_basis_traced(s.basis, _as_tensor(t).to(
        dtype=s.coeffs.dtype, device=s.coeffs.device))
    return torch.einsum("...i,...i->...", s.coeffs,
                        torch.broadcast_to(bvals, s.coeffs.shape))


def running_integral(s: BSpline) -> BSpline:
    """Antiderivative spline."""
    int_basis, L = s.basis.running_integral()
    return BSpline(int_basis, torch.einsum("qi,...i->...q",
                                           _const(L, s.coeffs), s.coeffs))


def definite_integral(s: BSpline, a, b):
    """Integral of s over [a, b]; a and b may be tensor scalars."""
    R = running_integral(s)
    return evalspline(R, b) - evalspline(R, a)


def sample_spline(basis_or_spline, coeffs_or_time, time=None):
    """Host-side dense sampling: sample_spline(spline, t) or
    sample_spline(basis, coeffs, t).  Returns a numpy array (..., len(t))."""
    if time is None:
        s, t = basis_or_spline, coeffs_or_time
        basis, coeffs = s.basis, s.coeffs.detach().cpu().numpy()
    else:
        basis, coeffs, t = basis_or_spline, np.asarray(coeffs_or_time), time
    E = basis.eval(np.asarray(t))
    return np.einsum("ti,...i->...t", E, coeffs)

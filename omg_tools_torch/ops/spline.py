"""B-spline objects over torch tensors.

A ``BSpline`` pairs a static host-side :class:`~.basis.Basis` with a torch
coefficient tensor.  All spline algebra (sum, product, derivative, integral,
evaluation) is a contraction against constant matrices computed once by the
basis engine, so it composes with ``torch.func.jacfwd``/``grad``/``vmap``.

Counterpart of ``omg_tools_tpu.ops.spline``: besides ``BSpline``, the
rational splines (``Nurbs``, from ``spline_div``), the 2-D tensor-product
spline and the quadratic-NURBS circle arcs of rotating obstacles
(``circle_arc_splines``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .basis import Basis

__all__ = ["BSpline", "Nurbs", "TensorBSpline", "spline_div",
           "circle_arc_splines", "circle_arc_coeffs", "eval_basis_traced",
           "evalspline", "running_integral", "definite_integral",
           "sample_spline"]


# While a CUDA graph is made (its warm-up run and its capture), the device
# copies of host constants are kept by content, so that the capture finds
# every constant on the device and copies nothing from the host.  The
# graph holds the store: its constants live as long as it does.
_kept = None


@contextlib.contextmanager
def keep_device_constants():
    """Keep the device copies that ``_const`` makes inside this block, one
    per content; yields the store, which the caller holds for as long as
    it uses them."""
    global _kept
    outer = _kept
    _kept = {} if outer is None else outer
    try:
        yield _kept
    finally:
        _kept = outer


def _const(mat, like, dtype=None):
    """Host constant (numpy, or a CPU tensor) as a tensor of ``like``'s
    device and dtype (or ``dtype``); off the CPU and inside
    :func:`keep_device_constants`, the kept copy."""
    dtype = like.dtype if dtype is None else dtype
    if like.device.type == "cpu" or _kept is None:
        return torch.as_tensor(np.asarray(mat), dtype=dtype,
                               device=like.device)
    a = np.ascontiguousarray(mat)
    key = (a.shape, a.dtype.str, a.tobytes(), dtype, like.device)
    t = _kept.get(key)
    if t is None:
        # a plain tensor, even when made under a torch.func transform:
        # a tensor lifted into the transform's level must not outlive it
        with torch._C._DisableFuncTorch():
            t = torch.as_tensor(a, dtype=dtype, device=like.device)
        _kept[key] = t
    return t


def _as_tensor(v):
    return v if isinstance(v, torch.Tensor) else \
        torch.as_tensor(np.asarray(v, dtype=np.float64))


def _cox_de_boor_tables(basis: Basis, convert, key):
    """The recursion's constants over all knot spans, each through
    ``convert`` and made once per ``key`` on the basis: the knots k_i and
    k_{i+1}, the left-closed mask of the first indicators (the clamped
    head), one and zero and, for each degree r = 1..d, the knots k_i and
    k_{i+r+1}, both spans (1 where a span is empty) and the masks of the
    spans that are not empty."""
    def compute():
        k = np.array(basis.knots, dtype=np.float64)
        d, nk = basis.degree, len(k)
        closed = (np.arange(nk - 1) < d + 1) & (k[:-1] == k[0])
        levels = []
        for deg in range(1, d + 1):
            i = np.arange(nk - deg - 1)
            den1 = k[i + deg] - k[i]
            den2 = k[i + deg + 1] - k[i + 1]
            levels.append(tuple(convert(a) for a in (
                k[i], k[i + deg + 1], np.where(den1 != 0.0, den1, 1.0),
                np.where(den2 != 0.0, den2, 1.0), den1 != 0.0, den2 != 0.0)))
        head = tuple(convert(a) for a in (k[:-1], k[1:], closed,
                                          np.ones(()), np.zeros(())))
        return head, levels
    return basis._memoized(key, compute)


def _cox_de_boor(t, tables, where):
    """The recursion over all knot spans at once, for a torch tensor or a
    numpy array ``t`` and tables of its type."""
    (lo, hi, closed, one, zero), levels = tables
    tt = t[..., None]
    b = where(closed, tt >= lo, tt > lo) & (tt <= hi)
    b = b * one
    for k_lo, k_hi, den1, den2, has1, has2 in levels:
        term1 = (tt - k_lo) * b[..., :-1] / den1
        term2 = (k_hi - tt) * b[..., 1:] / den2
        b = where(has1, term1, zero) + where(has2, term2, zero)
    return b


def eval_basis_traced(basis: Basis, t):
    """Cox-de Boor basis values at a tensor scalar ``t`` (possibly batched
    under ``torch.func``).  Returns a (..., len(basis)) tensor.

    Each degree is one pass over all knot spans, and each value is the
    same sequence of IEEE operations as the span-by-span recursion:
    (t - k_i) b_i / (k_{i+r} - k_i) + (k_{i+r+1} - t) b_{i+1} /
    (k_{i+r+1} - k_{i+1}), a term left out where its span is empty.  The
    tables live on the basis, one set per dtype and device."""
    t = _as_tensor(t)
    dtype, device = t.dtype, t.device

    def convert(a):
        # a plain tensor, even when first made under a torch.func
        # transform: the basis keeps it beyond the transform
        with torch._C._DisableFuncTorch():
            return torch.as_tensor(
                a, dtype=torch.bool if a.dtype == bool else dtype,
                device=device)
    tables = _cox_de_boor_tables(basis, convert,
                                 ("cox_de_boor", dtype, device))
    return _cox_de_boor(t, tables, torch.where)


_NUMPY_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _basis_at(s, t):
    """The basis values of spline ``s`` at ``t`` on its coefficients'
    device and dtype.  A host number is evaluated on the host in that
    dtype (the same IEEE operations) and its values taken as a constant."""
    if isinstance(t, torch.Tensor):
        return eval_basis_traced(s.basis, t.to(dtype=s.coeffs.dtype,
                                               device=s.coeffs.device))
    dt = _NUMPY_DTYPE[s.coeffs.dtype]
    tables = _cox_de_boor_tables(
        s.basis, lambda a: a if a.dtype == bool else a.astype(dt),
        ("cox_de_boor", dt))
    host = np.asarray(t, dtype=np.float64).astype(dt)
    return _const(_cox_de_boor(host, tables, np.where), s.coeffs)


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
            return torch.einsum("...i,i->...", self.coeffs,
                                _basis_at(self, x))
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

    def insert_knots(self, knots) -> "BSpline":
        T, basis = self.basis.knot_insertion_T(knots)
        return BSpline(basis, torch.einsum("qi,...i->...q",
                                           _const(T, self.coeffs),
                                           self.coeffs))

    def scale(self, factor, shift=0.0) -> "BSpline":
        return BSpline(self.basis.scale(factor, shift), self.coeffs)

    def crop(self, a: float, b: float) -> "BSpline":
        T, sub = self.basis.interval_T(a, b)
        return BSpline(sub, torch.einsum("qi,...i->...q",
                                         _const(T, self.coeffs), self.coeffs))

    def __truediv__(self, other):
        if isinstance(other, BSpline):
            return spline_div(self, other)
        return BSpline(self.basis, self.coeffs / other)


class Nurbs:
    """Rational spline: numerator/denominator coefficient pairs on one
    basis, produced by BSpline division; evaluation divides pointwise and
    products keep the rational form."""

    def __init__(self, basis, coeffs, weights):
        self.basis = basis
        self.coeffs = _as_tensor(coeffs)
        self.weights = _as_tensor(weights)

    def numerator(self) -> BSpline:
        return BSpline(self.basis, self.coeffs * self.weights)

    def denominator(self) -> BSpline:
        return BSpline(self.basis, self.weights)

    def __call__(self, x):
        return self.numerator()(x) / self.denominator()(x)

    def __mul__(self, other):
        if isinstance(other, Nurbs):
            num = self.numerator() * other.numerator()
            den = self.denominator() * other.denominator()
            return Nurbs(num.basis, num.coeffs / den.coeffs, den.coeffs)
        if isinstance(other, BSpline):
            num = self.numerator() * other
            den = self.denominator() * BSpline(
                other.basis, torch.ones(len(other.basis),
                                        dtype=self.coeffs.dtype,
                                        device=self.coeffs.device))
            return Nurbs(num.basis, num.coeffs / den.coeffs, den.coeffs)
        return Nurbs(self.basis, self.coeffs * other, self.weights)

    __rmul__ = __mul__


def spline_div(num: BSpline, den: BSpline) -> Nurbs:
    """BSpline division: a NURBS on the union basis."""
    basis = num.basis + den.basis
    n = torch.einsum("qi,...i->...q", _const(basis.transform(num.basis),
                                              num.coeffs), num.coeffs)
    w = torch.einsum("qi,...i->...q", _const(basis.transform(den.basis),
                                              den.coeffs), den.coeffs)
    return Nurbs(basis, n / w, w)


class TensorBSpline:
    """2-D tensor-product spline: a coefficient grid
    ``(len(basis_u), len(basis_v))``, evaluated as two small matmuls."""

    def __init__(self, bases, coeffs):
        self.basis = list(bases)
        if len(self.basis) != 2:
            raise ValueError("TensorBSpline supports 2 dimensions")
        self.coeffs = _as_tensor(coeffs)

    def __call__(self, u, v):
        Eu = _const(self.basis[0].eval(np.atleast_1d(u)), self.coeffs)
        Ev = _const(self.basis[1].eval(np.atleast_1d(v)), self.coeffs)
        out = torch.einsum("ui,vj,...ij->...uv", Eu, Ev, self.coeffs)
        if np.ndim(u) == 0 and np.ndim(v) == 0:
            return out[..., 0, 0]
        return out

    def __add__(self, other):
        if isinstance(other, TensorBSpline):
            if other.basis[0] is self.basis[0] \
                    and other.basis[1] is self.basis[1]:
                return TensorBSpline(self.basis, self.coeffs + other.coeffs)
            bu = self.basis[0] + other.basis[0]
            bv = self.basis[1] + other.basis[1]
            out = torch.zeros((len(bu), len(bv)), dtype=self.coeffs.dtype,
                              device=self.coeffs.device)
            for s in (self, other):
                Tu = _const(bu.transform(s.basis[0]), s.coeffs)
                Tv = _const(bv.transform(s.basis[1]), s.coeffs)
                out = out + torch.einsum("ui,vj,ij->uv", Tu, Tv, s.coeffs)
            return TensorBSpline([bu, bv], out)
        return TensorBSpline(self.basis, self.coeffs + other)

    __radd__ = __add__

    def __mul__(self, other):
        if isinstance(other, TensorBSpline):
            pu, Wu = self.basis[0].product_tensor(other.basis[0])
            pv, Wv = self.basis[1].product_tensor(other.basis[1])
            coeffs = torch.einsum(
                "qik,rjl,ij,kl->qr", _const(Wu, self.coeffs),
                _const(Wv, self.coeffs), self.coeffs, other.coeffs)
            return TensorBSpline([pu, pv], coeffs)
        return TensorBSpline(self.basis, self.coeffs * other)

    __rmul__ = __mul__

    def derivative(self, o, axis):
        Bd, P = self.basis[axis].derivative(o)
        P = _const(P, self.coeffs)
        if axis == 0:
            return TensorBSpline([Bd, self.basis[1]],
                                 torch.einsum("qi,ij->qj", P, self.coeffs))
        return TensorBSpline([self.basis[0], Bd],
                             torch.einsum("qj,ij->iq", P, self.coeffs))


def circle_arc_splines(sweep: float):
    """Quadratic-NURBS arc: (cos_num, sin_num, w) BSplines on [0, 1]
    covering a rotation of ``sweep`` radians from angle 0, such that
    cos(sweep u) = cos_num(u) / w(u) and sin likewise."""
    basis, *cfs = circle_arc_coeffs(sweep)
    return tuple(BSpline(basis, c) for c in cfs)


def circle_arc_coeffs(sweep: float):
    """The basis and the numpy coefficients (cos_num, sin_num, w) of
    :func:`circle_arc_splines`.  The arc is built from quarter-circle
    segments, as many as cover the sweep, and cropped to [0, 1]."""
    if sweep <= 0:
        raise ValueError("sweep must be positive")
    quarter = 0.5 * np.pi
    n_q = int(np.ceil(sweep / quarter))
    # a basis over n_q quarters in u' in [0, n_q * quarter / sweep]
    u_ends = np.array([(k + 1) * quarter / sweep for k in range(n_q)])
    knots = np.r_[np.zeros(3),
                  np.repeat(u_ends[:-1], 2) if n_q > 1 else np.array([]),
                  np.full(3, u_ends[-1])]
    basis = Basis(knots, 2)
    c = np.sqrt(2.0) / 2.0
    cos_pat = np.array([1, c, 0, -c, -1, -c, 0, c])
    sin_pat = np.array([0, c, 1, c, 0, -c, -1, -c])
    w_pat = np.array([1, c, 1, c, 1, c, 1, c])
    n = len(basis)
    cos_cfs = np.array([cos_pat[k % 8] for k in range(n)])
    sin_cfs = np.array([sin_pat[k % 8] for k in range(n)])
    w_cfs = np.array([w_pat[k % 8] for k in range(n)])
    if u_ends[-1] > 1.0 + 1e-12:
        T, basis = basis.interval_T(0.0, 1.0)
        cos_cfs, sin_cfs, w_cfs = T @ cos_cfs, T @ sin_cfs, T @ w_cfs
    return basis, cos_cfs, sin_cfs, w_cfs


def evalspline(s: BSpline, t):
    """Evaluate a spline at a scalar t (a number or a tensor scalar), on
    the coefficients' device."""
    bvals = _basis_at(s, t)
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

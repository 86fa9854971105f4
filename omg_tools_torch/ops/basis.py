"""B-spline basis engine (host side).

All basis-level computations happen on the host in float64 numpy, once, at
problem-construction ("trace") time.  Every runtime spline operation then
reduces to a dense matmul / einsum with one of the constant matrices produced
here, which is what makes the device compute path pure linear algebra.
A copy of ``omg_tools_tpu.ops.basis``: the port imports nothing of the JAX
package.

Mirrors the capabilities of the reference spline engine
(omgtools' basics/spline.py and spline_extra.py) but with a
different mechanism: instead of per-operation recurrences, one universal tool
is used for every basis change -- a Greville-point collocation solve.  For any
target basis whose spline space contains the source expression, the transform
matrix is ``solve(B_target(greville), expr(greville))``, which is exact.

Conventions (match the reference so parity tests line up):
- Bases are clamped by default on [0, 1]:  knots = [0]*d ++ linspace(0,1,n+1)
  ++ [1]*d   (reference: vehicles/vehicle.py:80-87).
- Basis functions are left-continuous at interior knots; the first degree+1
  indicator functions are closed at the left boundary
  (reference: basics/spline.py:131-136).
"""

from __future__ import annotations

import functools
import numpy as np
import scipy.linalg as sla

__all__ = [
    "Basis", "clamped_basis", "clamped_knots", "eval_basis_matrix",
]

_EPS_ZERO = 1e-10  # entries below this are snapped to exact zero


def clamped_knots(n_intervals: int, degree: int) -> np.ndarray:
    """Default knot vector on [0, 1] with ``n_intervals`` equal intervals."""
    return np.r_[np.zeros(degree), np.linspace(0.0, 1.0, n_intervals + 1),
                 np.ones(degree)]


def eval_basis_matrix(knots: np.ndarray, degree: int, x: np.ndarray) -> np.ndarray:
    """Cox-de Boor evaluation.  Returns dense (len(x), n_basis) matrix."""
    knots = np.asarray(knots, dtype=np.float64)
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    nk = len(knots)
    # degree-0: indicator functions, left-closed only at the domain start
    b = np.empty((nk - 1, len(x)))
    for i in range(nk - 1):
        if i < degree + 1 and knots[0] == knots[i]:
            b[i] = (x >= knots[i]) & (x <= knots[i + 1])
        else:
            b[i] = (x > knots[i]) & (x <= knots[i + 1])
    b = b.astype(np.float64)
    for d in range(1, degree + 1):
        b_next = np.zeros((nk - d - 1, len(x)))
        for i in range(nk - d - 1):
            denom = knots[i + d] - knots[i]
            if denom != 0.0:
                b_next[i] = (x - knots[i]) * b[i] / denom
            denom = knots[i + d + 1] - knots[i + 1]
            if denom != 0.0:
                b_next[i] += (knots[i + d + 1] - x) * b[i + 1] / denom
        b = b_next
    return b.T.copy()


class Basis:
    """Immutable, cached B-spline basis.

    Instances are interned: ``Basis(knots, degree)`` with equal arguments
    returns the same object, so all derived matrices (cached with lru_cache on
    methods) are computed exactly once per basis -- the analog of the
    reference's @cached_class/@memoize machinery (spline.py:39-83).
    """

    _cache: dict = {}

    def __new__(cls, knots, degree: int):
        knots = np.asarray(knots, dtype=np.float64)
        key = (cls, int(degree), knots.tobytes())
        inst = cls._cache.get(key)
        if inst is None:
            inst = super().__new__(cls)
            inst.knots = knots
            inst.knots.setflags(write=False)
            inst.degree = int(degree)
            inst._memo = {}
            cls._cache[key] = inst
        return inst

    # -- basic structure ---------------------------------------------------
    def __len__(self) -> int:
        return len(self.knots) - self.degree - 1

    def __repr__(self):
        return f"Basis(n={len(self)}, degree={self.degree}, [{self.knots[0]},{self.knots[-1]}])"

    def __reduce__(self):  # pickling support keeps interning
        return (Basis, (np.array(self.knots), self.degree))

    @property
    def domain(self):
        return (float(self.knots[0]), float(self.knots[-1]))

    def _memoized(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    # -- evaluation --------------------------------------------------------
    def eval(self, x) -> np.ndarray:
        """Dense (len(x), len(self)) collocation matrix at points x."""
        return eval_basis_matrix(self.knots, self.degree, x)

    __call__ = eval

    def greville(self) -> np.ndarray:
        """Greville abscissae (reference: spline.py:196-199)."""
        def compute():
            d = self.degree
            if d == 0:
                return 0.5 * (self.knots[:-1] + self.knots[1:])
            return np.array([self.knots[k + 1:k + d + 1].mean()
                             for k in range(len(self))])
        return self._memoized("greville", compute)

    def _colloc_lu(self):
        """LU factorization of the basis evaluated at its Greville points,
        or None when that collocation matrix is numerically singular (high
        interior knot multiplicities from repeated spline products make
        some Greville rows coincide/degenerate)."""
        def compute():
            import warnings
            g = self.greville().copy()
            # nudge coincident greville points (can occur at knots of full
            # multiplicity) so the collocation matrix stays invertible
            for i in range(1, len(g)):
                if g[i] <= g[i - 1]:
                    g[i] = np.nextafter(g[i - 1], np.inf)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", sla.LinAlgWarning)
                lu = sla.lu_factor(self.eval(g))
            diag = np.abs(np.diag(lu[0]))
            if diag.min() <= 1e-12 * max(diag.max(), 1.0):
                return None, g   # singular pivot: collocation unusable
            return lu, g
        return self._memoized("colloc_lu", compute)

    def solve_collocation(self, rhs_fn) -> np.ndarray:
        """Solve B(greville) @ C = rhs_fn(greville) for C (the universal
        basis-change mechanism).  Exact whenever the function sampled by
        ``rhs_fn`` lies in this basis' spline space.

        High interior knot multiplicities (>= degree, produced by repeated
        spline products) can make the Greville collocation singular; then a
        dense-grid least-squares fit is used instead (still exact for
        in-space functions)."""
        lu, g = self._colloc_lu()
        if lu is not None:
            with np.errstate(all="ignore"):
                T = sla.lu_solve(lu, rhs_fn(g))
            if np.all(np.isfinite(T)):
                T[np.abs(T) < _EPS_ZERO] = 0.0
                return T
        # fallback: oversampled least squares (avoid knots: open intervals)
        lo, hi = self.domain
        grid = []
        uniq = np.unique(self.knots)
        for a, b in zip(uniq[:-1], uniq[1:]):
            grid.append(np.linspace(a, b, self.degree + 3)[1:-1])
        grid = np.concatenate(grid + [np.array([lo, hi])])
        grid = np.sort(grid)
        B = self.eval(grid)
        T, *_ = np.linalg.lstsq(B, np.asarray(rhs_fn(grid)), rcond=None)
        T[np.abs(T) < _EPS_ZERO] = 0.0
        return T

    # -- basis arithmetic (reference: spline.py:138-179) -------------------
    def _combine(self, other: "Basis", degree: int) -> "Basis":
        """Union knot vector such that both spline spaces (at the given
        degree) embed: multiplicity rule from reference spline.py:138-148."""
        breaks = np.union1d(self.knots, other.knots)
        knots = []
        for b in breaks:
            m_self = int(np.sum(self.knots == b))
            m_other = int(np.sum(other.knots == b))
            mult = max(m_self + degree - self.degree if m_self else -10**9,
                       m_other + degree - other.degree if m_other else -10**9)
            knots.extend([b] * mult)
        return Basis(np.array(knots), degree)

    def __add__(self, other):
        if isinstance(other, Basis):
            return self._combine(other, max(self.degree, other.degree))
        return self

    __radd__ = __add__
    __sub__ = __add__

    def __mul__(self, other):
        if isinstance(other, Basis):
            return self._combine(other, self.degree + other.degree)
        return self

    __rmul__ = __mul__

    def __pow__(self, p: int):
        return self._combine(self, p * self.degree)

    def scale(self, factor, shift=0.0) -> "Basis":
        return Basis(self.knots * factor + shift, self.degree)

    def insert_knots(self, new_knots) -> "Basis":
        unique = np.setdiff1d(np.asarray(new_knots, dtype=np.float64), self.knots)
        return Basis(np.sort(np.append(self.knots, unique)), self.degree)

    # -- transforms --------------------------------------------------------
    def transform(self, source: "Basis") -> np.ndarray:
        """T with self_basis(x) @ T == source_basis(x): re-express a spline of
        ``source`` in this (richer) basis.  (reference: spline.py:283-306)"""
        def compute():
            return self.solve_collocation(lambda g: source.eval(g))
        return self._memoized(("transform", id(source)), compute)

    def derivative(self, o: int = 1):
        """Return (derivative_basis, P) with d^o s/dx^o = (P @ coeffs) in the
        derivative basis (de Boor eq. (16); reference spline.py:236-260)."""
        def compute():
            d = self.degree
            B = Basis(self.knots[o:len(self.knots) - o], d - o)
            P = np.eye(len(self))
            knots = self.knots
            n = len(self)
            for i in range(o):
                knots = knots[1:-1]
                delta = knots[d - i:] - knots[:-(d - i)]
                T = np.zeros((n - 1 - i, n - i))
                j = np.arange(n - 1 - i)
                T[j, j] = -1.0 / delta
                T[j, j + 1] = 1.0 / delta
                P = (d - i) * (T @ P)
            return B, P
        return self._memoized(("derivative", o), compute)

    def product_tensor(self, other: "Basis"):
        """Return (product_basis, W) with
        ``coeffs_prod = einsum('qij,i,j->q', W, c_self, c_other)`` giving the
        exact product spline.  (reference: spline.py:419-436 via pairs+transform)"""
        def compute():
            prod = self * other

            def rhs(g):
                E1 = self.eval(g)            # (npts, n1)
                E2 = other.eval(g)           # (npts, n2)
                return (E1[:, :, None] * E2[:, None, :]).reshape(len(g), -1)

            W = prod.solve_collocation(rhs)
            return prod, W.reshape(len(prod), len(self), len(other))
        return self._memoized(("product", id(other)), compute)

    # -- integrals ---------------------------------------------------------
    def integral_weights(self) -> np.ndarray:
        """w such that integral over the support = w @ coeffs
        (de Boor X.33; reference spline.py:477-487)."""
        def compute():
            k, d = self.knots, self.degree
            return (k[d + 1:] - k[:-(d + 1)]) / (d + 1)
        return self._memoized("int_weights", compute)

    def running_integral(self):
        """Return (int_basis, L) with antiderivative coeffs = L @ coeffs
        (reference: spline_extra.py:58-76)."""
        def compute():
            k, d = self.knots, self.degree
            int_basis = Basis(np.r_[k[0], k, k[-1]], d + 1)
            n = len(self)
            w = (k[d + 1:d + 1 + n] - k[:n]) / (d + 1)
            L = np.zeros((n + 1, n))
            L[1:, :] = np.tril(np.ones((n, n))) * w[None, :]
            return int_basis, L
        return self._memoized("running_integral", compute)

    # -- receding-horizon transforms ---------------------------------------
    def extrapolation_rows(self, x: np.ndarray) -> np.ndarray:
        """Evaluation matrix rows valid also for x beyond the domain end:
        points past knots[-1] use the Taylor (polynomial) extension of the
        last spline segment.  Rows are linear in the coefficients."""
        t_end = self.knots[-1]
        x = np.atleast_1d(np.asarray(x, dtype=np.float64))
        inside = x <= t_end
        rows = np.zeros((len(x), len(self)))
        if inside.any():
            rows[inside] = self.eval(x[inside])
        out = ~inside
        if out.any():
            # polynomial extension of the last knot interval: fit each basis
            # function's restriction to the last segment exactly (degree-d
            # polynomial through d+1 local samples) and evaluate beyond.
            # Robust for any interior multiplicity (global derivative
            # matrices would divide by zero-width knot spans on C^0 bases).
            d = self.degree
            seg_lo = self.knots[self.knots < t_end].max()
            pts = np.linspace(seg_lo, t_end, d + 1)
            # sample strictly inside to stay on the last polynomial piece
            pts = seg_lo + (pts - seg_lo) * (1 - 1e-9) + 1e-12
            V = np.vander(pts - seg_lo, d + 1, increasing=True)
            C = np.linalg.solve(V, self.eval(pts))       # (d+1, n)
            Vx = np.vander(x[out] - seg_lo, d + 1, increasing=True)
            rows[out] = Vx @ C
        return rows

    def shiftoverknot_T(self) -> np.ndarray:
        """Transform advancing the horizon by one knot interval: the new
        spline s2 (in this same basis) satisfies s2(t) = s(t + delta) for
        t <= t_end - delta and extends the last polynomial piece beyond,
        where delta = knots[degree+1] - knots[0].
        (reference: spline_extra.py:165-191 -- built there by recurrences;
        here by one collocation solve, exact for equidistant interior knots.)"""
        def compute():
            delta = self.knots[self.degree + 1] - self.knots[0]
            T = self.solve_collocation(
                lambda g: self.extrapolation_rows(g + delta))
            return T
        return self._memoized("shiftoverknot", compute)

    def shiftfirstknot_T(self, t_shift: float) -> np.ndarray:
        """Transform T(t) re-expressing the spline on knots whose first
        degree+1 entries move to ``t_shift`` -- i.e. crop the past
        [knots[0], t_shift) so only the future part of the horizon remains
        represented.  (reference: spline_extra.py:220-255)

        Numeric (host) version; the JAX package's traced/parameterized
        version (ops/spline_jax.shiftfirstknot_T) is not ported yet.
        """
        knots2 = np.array(self.knots)
        knots2[:self.degree + 1] = t_shift
        target = Basis(knots2, self.degree)
        # rows: evaluate source basis at target's greville points (all inside
        # [t_shift, end] so the source spline is evaluated on valid domain)
        return target.solve_collocation(lambda g: self.eval(g))

    def shift_spline_T(self, t_shift: float) -> np.ndarray:
        """Extract the spline piece on [t_shift, end] and re-express it in a
        fresh equidistant clamped basis on the same [t_shift, end] domain --
        approximate, knot positions change (reference: spline_extra.py:88-99)."""
        n_knots = len(self) - self.degree + 1
        k = self.knots
        knots2 = np.r_[t_shift * np.ones(self.degree),
                       np.linspace(t_shift, k[-1], n_knots),
                       k[-1] * np.ones(self.degree)]
        target = Basis(knots2, self.degree)
        return target.solve_collocation(lambda g: self.eval(g))

    def knot_insertion_T(self, knots_to_insert):
        """(T, new_basis): exact re-expression after knot insertion
        (reference: spline_extra.py:258-280)."""
        knots = np.sort(np.r_[self.knots,
                              np.asarray(knots_to_insert, dtype=np.float64)])
        new_basis = Basis(knots, self.degree)
        return new_basis.transform(self), new_basis

    def interval_T(self, a: float, b: float):
        """(T, sub_basis): exact restriction of the spline to [a, b], in a
        clamped basis on [a, b] keeping interior knots/multiplicities
        (reference: spline_extra.py:283-305)."""
        d = self.degree
        interior = self.knots[(self.knots > a) & (self.knots < b)]
        sub = Basis(np.r_[[a] * (d + 1), interior, [b] * (d + 1)], d)
        T = sub.solve_collocation(lambda g: self.eval(g))
        return T, sub


def clamped_basis(n_intervals: int, degree: int) -> Basis:
    return Basis(clamped_knots(n_intervals, degree), degree)

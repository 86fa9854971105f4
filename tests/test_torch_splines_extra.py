"""The port's rational, tensor-product and circle-arc splines, the knot
insertion and cropping of a BSpline, and the Cox-de Boor helpers with
tensor knots (omg_tools_torch.ops.spline, .spline_jax) held to the JAX
package's on the same seeded inputs, in float64 on the CPU, to 1e-12
relative (tests/test_splines.py, tests/test_gui_tools.py and
tests/test_spline_jax.py:67-90 test the JAX functions the same way)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_tools_tpu.ops import spline as JS
from omg_tools_tpu.ops import spline_jax as JSJ
from omg_tools_tpu.ops.basis import clamped_basis as j_clamped_basis
from omg_tools_torch.ops import spline as PS
from omg_tools_torch.ops import spline_jax as PSJ
from omg_tools_torch.ops.basis import clamped_basis
from torch_bench_configs import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.fast

RTOL = 1e-12


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(1.0, np.abs(want).max()))


def _pair(n_int, degree, seed, shape=()):
    """A port spline and a JAX spline on one basis with seeded
    coefficients."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal(shape + (len(clamped_basis(n_int, degree)),))
    return (PS.BSpline(clamped_basis(n_int, degree), torch.as_tensor(c)),
            JS.BSpline(j_clamped_basis(n_int, degree), jnp.asarray(c)))


@pytest.mark.parametrize("knots", [[0.25, 0.25, 0.6], [0.5], [0.1, 0.9]])
def test_insert_knots_matches_jax(knots):
    p, j = _pair(6, 3, 0, (2,))
    a, b = p.insert_knots(knots), j.insert_knots(knots)
    np.testing.assert_array_equal(a.basis.knots, b.basis.knots)
    _close(a.coeffs, b.coeffs)
    x = np.linspace(0, 1, 37)
    _close(a(x), j(x))


@pytest.mark.parametrize("ab", [(0.2, 0.7), (0.0, 0.5), (0.33, 1.0)])
def test_crop_matches_jax(ab):
    p, j = _pair(10, 3, 1)
    a, b = p.crop(*ab), j.crop(*ab)
    np.testing.assert_array_equal(a.basis.knots, b.basis.knots)
    _close(a.coeffs, b.coeffs)
    x = np.linspace(*ab, 29)
    _close(a(x), j(x))


def test_nurbs_division_product_and_eval_match_jax():
    num_p, num_j = _pair(4, 3, 2)
    rng = np.random.default_rng(3)
    w = 2.0 + rng.uniform(size=len(clamped_basis(5, 2)))
    den_p = PS.BSpline(clamped_basis(5, 2), torch.as_tensor(w))
    den_j = JS.BSpline(j_clamped_basis(5, 2), jnp.asarray(w))
    rp, rj = num_p / den_p, num_j / den_j
    assert isinstance(rp, PS.Nurbs) and isinstance(rj, JS.Nurbs)
    np.testing.assert_array_equal(rp.basis.knots, rj.basis.knots)
    _close(rp.coeffs, rj.coeffs)
    _close(rp.weights, rj.weights)
    x = np.linspace(0, 1, 41)
    _close(rp(x), rj(x))
    # NURBS x NURBS, NURBS x BSpline, NURBS x scalar
    for other_p, other_j in ((rp, rj), (den_p, den_j), (1.7, 1.7)):
        a, b = rp * other_p, rj * other_j
        _close(a.coeffs, b.coeffs)
        _close(a.weights, b.weights)
        _close(a(x), b(x))
    _close((num_p / 4.0).coeffs, (num_j / 4.0).coeffs)
    _close(PS.spline_div(num_p, den_p).coeffs,
           JS.spline_div(num_j, den_j).coeffs)


def test_tensor_bspline_matches_jax():
    rng = np.random.default_rng(4)
    bases_p = [clamped_basis(3, 2), clamped_basis(4, 3)]
    bases_j = [j_clamped_basis(3, 2), j_clamped_basis(4, 3)]
    shape = (len(bases_p[0]), len(bases_p[1]))
    C1, C2 = rng.standard_normal((2,) + shape)
    C3 = rng.standard_normal((len(clamped_basis(5, 2)),
                              len(clamped_basis(2, 1))))
    p1, p2 = (PS.TensorBSpline(bases_p, torch.as_tensor(c)) for c in (C1, C2))
    j1, j2 = (JS.TensorBSpline(bases_j, jnp.asarray(c)) for c in (C1, C2))
    p3 = PS.TensorBSpline([clamped_basis(5, 2), clamped_basis(2, 1)],
                          torch.as_tensor(C3))
    j3 = JS.TensorBSpline([j_clamped_basis(5, 2), j_clamped_basis(2, 1)],
                          jnp.asarray(C3))
    u, v = np.linspace(0, 1, 7), np.linspace(0, 1, 9)
    _close(p1(u, v), j1(u, v))
    _close(p1(0.3, 0.8), j1(0.3, 0.8))
    for a, b in ((p1 * p2, j1 * j2), (p1 + p2, j1 + j2), (p1 + p3, j1 + j3),
                 (p1 * p3, j1 * j3), (2.5 * p1, 2.5 * j1),
                 (p1 + 1.0, j1 + 1.0),
                 (p1.derivative(1, 0), j1.derivative(1, 0)),
                 (p3.derivative(1, 1), j3.derivative(1, 1))):
        _close(a.coeffs, b.coeffs)
        _close(a(u, v), b(u, v))


@pytest.mark.parametrize("sweep", [0.5, 0.7, np.pi, np.pi / 6 * 10, 5.5,
                                   2 * np.pi, 8.0])
def test_circle_arc_splines_match_jax(sweep):
    """Arcs over less and more than a quarter, half and whole turn; the
    revolving door sweeps pi/6 x 10 s ~ 5.24 rad (four quarters, cropped
    to [0, 1])."""
    u = np.linspace(0, 1, 101)
    arcs_p = PS.circle_arc_splines(sweep)
    arcs_j = JS.circle_arc_splines(sweep)
    for a, b in zip(arcs_p, arcs_j):
        np.testing.assert_array_equal(a.basis.knots, b.basis.knots)
        _close(a.coeffs, b.coeffs)
        _close(a(u), b(u))
    cn, sn, w = (PS.sample_spline(s, u) for s in arcs_p)
    np.testing.assert_allclose((cn / w) ** 2 + (sn / w) ** 2, 1.0, atol=1e-12)
    with pytest.raises(ValueError):
        PS.circle_arc_splines(0.0)


@pytest.mark.parametrize("n_int,degree", [(10, 3), (7, 2), (5, 5), (6, 1)])
def test_eval_basis_traced_matches_jax(n_int, degree):
    knots = np.array(clamped_basis(n_int, degree).knots)
    xs = np.r_[np.linspace(0, 1, 73), knots[degree:-degree]]
    got = PSJ.eval_basis_traced(torch.as_tensor(knots), degree,
                                torch.as_tensor(xs))
    want = JSJ.eval_basis_traced(jnp.asarray(knots), degree, jnp.asarray(xs))
    _close(got, want)
    np.testing.assert_allclose(got.numpy(), clamped_basis(n_int, degree)
                               .eval(xs), atol=1e-12)


@pytest.mark.parametrize("n_int,degree", [(9, 3), (4, 0), (6, 2)])
def test_greville_traced_matches_jax(n_int, degree):
    knots = np.array(clamped_basis(n_int, degree).knots)
    _close(PSJ.greville_traced(torch.as_tensor(knots), degree),
           JSJ.greville_traced(jnp.asarray(knots), degree))


@pytest.mark.parametrize("degree", [2, 3])
def test_shift_spline_T_traced_matches_jax(degree):
    """At tensor shifts, against the JAX function and the host transform
    (tests/test_spline_jax.py:84-90's points and tolerance); also under
    torch.func.vmap over the shift."""
    basis, jbasis = clamped_basis(10, degree), j_clamped_basis(10, degree)
    ts = (0.01, 0.12, 0.33, 0.49, 0.999)
    for t in ts:
        got = PSJ.shift_spline_T_traced(
            basis, torch.tensor(t, dtype=torch.float64))
        want = JSJ.shift_spline_T_traced(jbasis, jnp.asarray(t))
        _close(got, want)
        np.testing.assert_allclose(got.numpy(), basis.shift_spline_T(t),
                                   atol=1e-8)
    batched = torch.func.vmap(lambda t: PSJ.shift_spline_T_traced(basis, t))(
        torch.tensor(ts, dtype=torch.float64))
    want = jax.vmap(lambda t: JSJ.shift_spline_T_traced(jbasis, t))(
        jnp.asarray(ts))
    _close(batched, want)

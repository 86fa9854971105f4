"""The port's rendezvous (``problems/rendezvous.py``) held to the JAX
package in float64 on the CPU.

Two scenes, built by both packages on the same cut x-update budget (one
outer round of 6 inner iterations):

- tests/test_distributed.py:75 (three Holonomic vehicles meeting in an
  8 m room, rho 0.5): ``initialize`` with 3 dual updates (a cold
  x-update, then warm ones);
- examples/platform_landing.py (two Quadrotors and a Holonomic1D
  platform: two vehicle-type groups, one template each, rho 3.0):
  ``initialize`` with one dual update.

Both start from the straight-line guesses plus the same seeded 1e-2
noise: from the guesses themselves the x-update is degenerate (rows on
their bounds), and the JAX package's own first x-update moves by 0.39-0.94
under a 1e-15 relative move of its start (from the noisy start the two
packages agree to 2.5e-12; measured on a CPU).

Tolerances.  Evaluations of the templates agree to 1e-12 (relative to
their largest value); the consensus iterates (X, Z, L) and the residual
sequences to 1e-8, the ADMM tests' bound in ``tests/test_torch_fleet.py``.
The JAX package compiles a solver program for each cold and warm
x-update of a vehicle-type group (~25-60 s each on a CPU), so the
landing scene runs one update: four programs, the meeting's cold
and warm x-updates and the landing's two groups.  (Cold x-updates after
the first do not do: they start from the previous solution, whose rows
sit on their bounds, and the two packages part by ~1e-6.)

The JAX package is imported by fixtures, so that the ``gpu`` test runs
where JAX is not installed:

    python -m pytest tests/test_torch_rendezvous.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

import omg_tools_torch as T
from omg_tools_torch.ops import psd_kernels as pk

BUDGET = {"outer_iter": 1, "inner_iter": 6}
UPDATES = {"meeting": 3, "landing": 1}
NOISE = 1e-2
TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These eager solves are small: torch's intra-op threads only spin
    beside the other test processes.  One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def J():
    """The JAX package (float64)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    return pytest.importorskip("omg_tools_tpu")


def _meeting(m, **options):
    """tests/test_distributed.py:75's rendezvous."""
    from importlib import import_module
    shapes = import_module(m.__name__ + ".environment.shapes")
    N = 3
    vehicles = [m.Holonomic() for _ in range(N)]
    fleet = m.Fleet(vehicles)
    configuration = shapes.RegularPolyhedron(0.2, N, np.pi / 4).vertices.T
    fleet.set_configuration(configuration.tolist())
    fleet.set_initial_conditions([[-3.0, 1.0], [0.0, -3.0], [3.0, 2.0]])
    for veh in vehicles:
        veh.set_terminal_conditions([0.0, 0.0])
    env = m.Environment(room={"shape": m.Square(8.0)})
    problem = m.RendezVous(fleet, env, options={
        "horizon_time": 10, "rho": 0.5, "verbose": 0,
        "solver_options": BUDGET, **options})
    problem.init()
    return problem


def _landing(m, **options):
    """examples/platform_landing.py's scene."""
    quadrotors = [m.Quadrotor(0.2) for _ in range(2)]
    fleet = m.Fleet(quadrotors + [m.Holonomic1D()])
    fleet.set_configuration([[0.25], [-0.25], [0.0]])
    fleet.set_initial_conditions([[1.5, 3.0], [-2.0, 2.0], [1.0]])
    fleet.set_terminal_conditions([[0.0, 0.1], [0.0, 0.1], [0.0]])
    env = m.Environment(room={"shape": m.Square(5.0), "position": [0., 2.]})
    env.add_obstacle(m.Obstacle({"position": [1.0, 1.5]},
                                shape=m.Rectangle(width=1.0, height=0.2)))
    problem = m.RendezVous(fleet, env, options={
        "horizon_time": 5.0, "rho": 3.0, "verbose": 0,
        "solver_options": BUDGET, **options})
    problem.init()
    return problem


SCENES = {"meeting": _meeting, "landing": _landing}


def _noisy_start(problem, seed=0):
    """The groups' guesses plus a seeded NOISE, the consensus state reset
    from them."""
    rng = np.random.default_rng(seed)
    for group in problem.groups:
        group.X = group.X + NOISE * rng.standard_normal(group.X.shape)
    problem._reset_dual_state()


def _close(a, b, tol, what):
    err = float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
    assert err <= tol, f"{what}: {err} > {tol}"


@pytest.fixture(scope="module")
def pairs(J):
    """{scene: (JAX problem, port problem)}, built once for the file."""
    return {name: (build(J, init_iter=UPDATES[name]),
                   build(T, device="cpu", init_iter=UPDATES[name]))
            for name, build in SCENES.items()}


@pytest.fixture(scope="module")
def initialized(pairs):
    """The pairs after ``initialize(0.0)``: UPDATES[scene] dual updates
    from the same noisy start."""
    for pair in pairs.values():
        for problem in pair:
            _noisy_start(problem)
            problem.initialize(0.0)
    return pairs


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_templates_match_jax(J, pairs, scene):
    """The groups' templates: layout, shared selector, offsets, parameter
    packing and the transcription's f and g at a random point."""
    import jax.numpy as jnp
    pj, pt = pairs[scene]
    assert len(pt.groups) == len(pj.groups) == (2 if scene == "landing"
                                                else 1)
    assert pt.n_sh == pj.n_sh and pt.n_slots == pj.n_slots
    rng = np.random.default_rng(0)
    for gj, gt in zip(pj.groups, pt.groups):
        assert gt.indices == gj.indices
        tj, tt = gj.template.transcription, gt.template.transcription
        assert (tt.n_x, tt.n_g, tt.n_p) == (tj.n_x, tj.n_g, tj.n_p)
        np.testing.assert_array_equal(gt.S_idx, gj.S_idx)
        np.testing.assert_array_equal(gt.x_shift, gj.x_shift)
        np.testing.assert_array_equal(gt.X, gj.X)
        np.testing.assert_array_equal(pt._pack_params(gt, 0.3),
                                      pj._pack_params(gj, 0.3))
        x = gj.X[0] + 0.1 * rng.standard_normal(tj.n_x)
        p = pj._pack_params(gj, 0.0)[0] + 0.01 * rng.standard_normal(tj.n_p)
        fj = float(tj.objective(jnp.asarray(x), jnp.asarray(p)))
        gvj = np.asarray(tj.constraints(jnp.asarray(x), jnp.asarray(p)))
        ft, gvt = tt.objective_and_constraints(torch.as_tensor(x),
                                               torch.as_tensor(p))
        assert abs(float(ft) - fj) <= 1e-12 * abs(fj)
        _close(gvt.numpy(), gvj, 1e-12 * np.max(np.abs(gvj)), "g")
    np.testing.assert_array_equal(pt.A_z, pj.A_z)
    np.testing.assert_array_equal(pt._shared_shift(), pj._shared_shift())
    assert pt._shared_transform(0.3) is pj._shared_transform(0.3) is None
    for i in range(pt.N):
        np.testing.assert_array_equal(pt._rel_offsets(i), pj._rel_offsets(i))
        np.testing.assert_array_equal(pt._slot_edges(i), pj._slot_edges(i))
    np.testing.assert_array_equal(pt.Z, pj.Z)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_initialize_matches_jax(initialized, scene):
    """The host dual updates: every group's X, the consensus Z and L and
    the residual sequence."""
    pj, pt = initialized[scene]
    assert len(pt.residuals) == len(pj.residuals) == UPDATES[scene]
    _close(np.asarray(pt.residuals), np.asarray(pj.residuals), TOL,
           "residuals")
    for gj, gt in zip(pj.groups, pt.groups):
        _close(gt.X, gj.X, TOL, "X")
        assert gt.alm_state.x.dtype == torch.float64
    _close(pt.Z, pj.Z, TOL, "Z")
    _close(pt.L, pj.L, TOL, "L")
    for i in range(pt.N):
        _close(pt._s_of_vehicle(i), pj._s_of_vehicle(i), TOL, f"s {i}")
    assert pt.stop_criterium(0.0, 0.1) == pj.stop_criterium(0.0, 0.1)


def test_meeting_consensus_converges(initialized):
    """tests/test_distributed.py:90-92's criterion on the port, here after
    3 updates on the cut budget: the primal residual falls below half its
    first value."""
    pt = initialized["meeting"][1]
    assert pt.residuals[-1][0] < 0.5 * pt.residuals[0][0]


def test_export_returns_the_rendezvous_exporter(initialized):
    pt = initialized["meeting"][1]
    exporter = pt.export()
    assert isinstance(exporter, T.ExportRendezVous)
    assert type(exporter).__name__ == "ExportRendezVous"  # the JAX name
    assert not pt.device_loop_capable and pt._runner is None


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_cuda_dual_updates_match_cpu(cuda_device, scene):
    """Two host dual updates with the x-updates on the card (K1 in every
    Newton step) against the same updates on the CPU, float64."""
    out = {}
    for device in ("cpu", cuda_device):
        problem = SCENES[scene](T, device=device)
        _noisy_start(problem)
        before = pk.psd_solve.launches
        for _ in range(2):
            problem.dual_update(0.0)
        out[str(device)] = (problem, pk.psd_solve.launches - before)
    (pc, kc), (pg, kg) = out["cpu"], out["cuda"]
    assert kc == 0 and kg > 0
    for gc, gg in zip(pc.groups, pg.groups):
        assert gg.alm_state.x.is_cuda
        _close(gg.X, gc.X, TOL, "X")
    _close(pg.Z, pc.Z, TOL, "Z")
    _close(np.asarray(pg.residuals), np.asarray(pc.residuals), TOL,
           "residuals")

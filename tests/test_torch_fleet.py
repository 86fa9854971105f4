"""The port's fleet path held to the JAX package, in float64 on the CPU:
the future-piece transforms (``ops/spline_jax.py``), ``Fleet``, the
consensus-ADMM template and its host dual updates, and ``FleetRunner``'s
iterations, rollout and Nesterov step; and the generic ALM mode's joint
evaluation against the per-op AD it replaced.

The scene is bench.py's formation_holonomic (four Holonomic vehicles on a
0.2 m square, a 0.4 m circle, rho 0.5), built by both packages with the
same cut x-update budget (2 outer rounds of 4 inner iterations), so that
the cold solves stay cheap.  The JAX package's ``jit`` compiles take most
of this file's time (~30 s a program).

Tolerances.  Evaluations agree to 1e-12 (relative where stated); the ADMM
iterates to 1e-8.  A rollout period that crosses a knot amplifies rounding:
there the multipliers are dropped and the x-update starts from the
shifted splines, and the JAX package's own states move by up to ~2e-4 m
when its carry moves by 1e-15 (relative).  So the periods before the knot
are held to 1e-8 and the knot's period to that sensitivity, measured here.

The JAX package is imported by fixtures, so that the ``gpu`` tests run
where JAX is not installed:

    python -m pytest tests/test_torch_fleet.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch
from torch.func import grad, hessian, jacfwd, vmap

import omg_tools_torch as T
from omg_tools_torch.environment.shapes import RegularPolyhedron
from omg_tools_torch.ops import psd_kernels as pk
from omg_tools_torch.ops import spline_jax as tsj
from omg_tools_torch.ops.basis import clamped_basis
from omg_tools_torch.parallel import FleetRunner
from omg_tools_torch.tools.parity import build_p2p_holonomic

N = 4
BUDGET = {"outer_iter": 2, "inner_iter": 4}
TOL = 1e-8
UPDATE_TIME = 0.5          # two periods a knot interval: spk + 1 = 3


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


def _formation(m, shapes, **options):
    vehicles = [m.Holonomic() for _ in range(N)]
    fleet = m.Fleet(vehicles)
    configuration = shapes.RegularPolyhedron(0.2, N, np.pi / 4).vertices.T
    fleet.set_configuration(configuration.tolist())
    fleet.set_initial_conditions(
        (np.array([-1.5, -1.5]) + configuration).tolist())
    fleet.set_terminal_conditions(
        (np.array([2.0, 2.0]) + configuration).tolist())
    env = m.Environment(room={"shape": m.Square(5.0)})
    env.add_obstacle(m.Obstacle({"position": [1.5, 0.5]},
                                shape=m.Circle(0.4)))
    problem = m.FormationPoint2point(
        fleet, env, options={"horizon_time": 10, "verbose": 0, "rho": 0.5,
                             "device_loop": False, "solver_options": BUDGET,
                             **options})
    problem.init()
    return problem


def _jax_formation(J):
    from omg_tools_tpu.environment import shapes
    return _formation(J, shapes)


def _torch_formation():
    from omg_tools_torch.environment import shapes
    return _formation(T, shapes, device="cpu")


@pytest.fixture(scope="module")
def formations(J):
    """(JAX problem, port problem): read, never stepped."""
    return _jax_formation(J), _torch_formation()


@pytest.fixture(scope="module")
def runners(J, formations):
    """Both packages' float64 FleetRunners and their cold states."""
    import jax.numpy as jnp
    from omg_tools_tpu.parallel.fleet_runner import FleetRunner as JRunner
    pj, pt = formations
    rj = JRunner(pj, dtype=jnp.float64, update_time=UPDATE_TIME)
    rt = FleetRunner(pt, dtype=torch.float64, update_time=UPDATE_TIME,
                     device="cpu")
    return rj, rt, rj.make_state(0.0), rt.make_state(0.0)


def _close(a, b, tol, what):
    err = float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
    assert err <= tol, f"{what}: {err} > {tol}"


# -- ops/spline_jax.py ------------------------------------------------------

@pytest.mark.parametrize("t", [0.0, 0.013, 0.05, 0.0731, 0.0999])
def test_future_piece_transforms_match_jax(J, t):
    import jax.numpy as jnp
    from omg_tools_tpu.ops import spline_jax as jsj
    from omg_tools_tpu.ops.basis import clamped_basis as j_clamped
    bt, bj = clamped_basis(10, 3), j_clamped(10, 3)
    c = np.random.default_rng(1).standard_normal((len(bt), 2))
    tt = torch.tensor(t, dtype=torch.float64)
    _close(tsj.shiftfirstknot_T(bt, tt).numpy(),
           np.asarray(jsj.shiftfirstknot_T(bj, jnp.asarray(t))), 1e-12, "T")
    fwd = tsj.shift_knot1_fwd(torch.as_tensor(c), bt, tt)
    _close(fwd.numpy(), np.asarray(jsj.shift_knot1_fwd(
        jnp.asarray(c), bj, jnp.asarray(t))), 1e-12, "fwd")
    back = tsj.shift_knot1_bwd(fwd, bt, tt)
    _close(back.numpy(), np.asarray(jsj.shift_knot1_bwd(
        jnp.asarray(fwd.numpy()), bj, jnp.asarray(t))), 1e-12, "bwd")


# -- models/fleet.py ----------------------------------------------------------

@pytest.mark.parametrize("graph", ["circular", "full"])
def test_fleet_graph_matches_jax(J, graph):
    conf = RegularPolyhedron(0.2, N, np.pi / 4).vertices.T.tolist()
    fleets = []
    for m in (J, T):
        vehicles = [m.Holonomic() for _ in range(N)]
        fleet = m.Fleet(vehicles, interconnection=graph)
        fleet.set_configuration(conf)
        fleets.append(fleet)
    fj, ft = fleets
    for vj, vt in zip(fj.vehicles, ft.vehicles):
        assert [fj.vehicles.index(n) for n in fj.get_neighbors(vj)] == \
            [ft.vehicles.index(n) for n in ft.get_neighbors(vt)]
        np.testing.assert_array_equal(vt.rel_pos_c, vj.rel_pos_c)
        rj, rt = fj.get_rel_config(vj), ft.get_rel_config(vt)
        for nj, nt in zip(fj.get_neighbors(vj), ft.get_neighbors(vt)):
            np.testing.assert_array_equal(rt[nt], rj[nj])


# -- the consensus-ADMM template ---------------------------------------------

def test_template_layout_and_transforms_match_jax(J, formations, runners):
    import jax.numpy as jnp
    pj, pt = formations
    tj, tt = pj.template.transcription, pt.template.transcription
    assert (tt.n_x, tt.n_g, tt.n_p) == (tj.n_x, tj.n_g, tj.n_p) \
        == (85, 299, 123)
    assert pt.n_sh == pj.n_sh == 26 and pt.template._structure == "generic"
    rng = np.random.default_rng(0)
    x = rng.standard_normal(tj.n_x)
    p = pj._pack_params(pj.groups[0], 0.0)[0] \
        + 0.01 * rng.standard_normal(tj.n_p)
    fj = float(tj.objective(jnp.asarray(x), jnp.asarray(p)))
    gj = np.asarray(tj.constraints(jnp.asarray(x), jnp.asarray(p)))
    ft, gt = tt.objective_and_constraints(torch.as_tensor(x),
                                          torch.as_tensor(p))
    assert abs(float(ft) - fj) <= 1e-12 * abs(fj)
    _close(gt.numpy(), gj, 1e-12 * np.max(np.abs(gj)), "g")
    for gj_, gt_ in zip(pj.groups, pt.groups):
        np.testing.assert_array_equal(gt_.S_idx, gj_.S_idx)
        np.testing.assert_array_equal(gt_.x_shift, gj_.x_shift)
        np.testing.assert_array_equal(
            pt._pack_params(gt_, 0.3), pj._pack_params(gj_, 0.3))
    np.testing.assert_array_equal(pt.A_z, pj.A_z)
    np.testing.assert_array_equal(pt._shared_shift(), pj._shared_shift())
    for i in range(N):
        np.testing.assert_array_equal(pt._slot_edges(i), pj._slot_edges(i))
        np.testing.assert_array_equal(pt._rel_offsets(i), pj._rel_offsets(i))
    rj, rt = runners[:2]
    assert rt.spk == rj.spk == 2
    for name in ("TfT", "TfinvT", "projT", "sh_shiftT"):
        _close(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
               1e-12, name)


def test_host_dual_updates_match_jax(J):
    """Two host (numpy-consensus) dual updates from fresh problems."""
    pj, pt = _jax_formation(J), _torch_formation()
    for k in range(2):
        rj, rt = pj.dual_update(0.0), pt.dual_update(0.0)
        _close(rt, rj, TOL, f"residuals {k}")
        _close(pt.groups[0].X, pj.groups[0].X, TOL, f"X {k}")
        _close(pt.Z, pj.Z, TOL, f"Z {k}")
        _close(pt.L, pj.L, TOL, f"L {k}")


# -- parallel/fleet_runner.py -------------------------------------------------

def _carry_close(cj, ct, what):
    for xj, xt in zip(cj.X, ct.X):
        _close(xt.numpy(), np.asarray(xj), TOL, f"{what} X")
    _close(ct.Z.numpy(), np.asarray(cj.Z), TOL, f"{what} Z")
    _close(ct.L.numpy(), np.asarray(cj.L), TOL, f"{what} L")
    for sj, st in zip(cj.st, ct.st):
        _close(st.lam.numpy(), np.asarray(sj.lam), TOL, f"{what} lam")
        _close(st.rho.numpy(), np.asarray(sj.rho), 0.0, f"{what} rho")


@pytest.fixture(scope="module")
def iterated(J, runners):
    """Both runners' carries after iterate_fn(2) from their cold states."""
    import jax
    rj, rt, cj, ct = runners
    _carry_close(cj, ct, "cold state")
    return jax.jit(rj.iterate_fn(2))(cj), rt.iterate_fn(2)(ct)


def test_fleet_runner_iterations_match_jax(iterated):
    (cj, (prj, duj)), (ct, (prt, dut)) = iterated
    _carry_close(cj, ct, "iterate_fn(2)")
    _close(prt.numpy(), np.asarray(prj), TOL, "pri")
    _close(dut.numpy(), np.asarray(duj), TOL, "dua")


def test_fleet_rollout_across_a_knot_matches_jax(J, runners, iterated):
    """rollout_fn over spk + 1 periods: the last crosses a knot."""
    import jax
    import jax.numpy as jnp
    rj, rt = runners[:2]
    (cj, _), (ct, _) = iterated
    n = rt.spk + 1
    roll = jax.jit(rj.rollout_fn(n))
    _, oj = roll(cj)
    _, ot = rt.rollout_fn(n)(ct)
    sj, st = np.asarray(oj["states"]), ot["states"].numpy()
    assert st.shape == sj.shape == (N, n, 2)
    k = rt.spk              # the knot's period
    _close(st[:, :k], sj[:, :k], TOL, "states before the knot")
    for key in ("pri", "dua"):
        _close(ot[key].numpy()[:k], np.asarray(oj[key])[:k], TOL, key)
    # the JAX package's own spread at the knot, over three 1e-15 moves
    sens = {"states": 0.0, "pri": 0.0, "dua": 0.0}
    for seed in range(3):
        rng = np.random.default_rng(seed)
        moved = cj._replace(X=tuple(
            x * (1.0 + 1e-15 * jnp.asarray(rng.standard_normal(x.shape)))
            for x in cj.X))
        _, om = roll(moved)
        sens["states"] = max(sens["states"], float(np.max(np.abs(
            np.asarray(om["states"])[:, k] - sj[:, k]))))
        for key in ("pri", "dua"):
            sens[key] = max(sens[key], float(abs(
                np.asarray(om[key])[k] - np.asarray(oj[key])[k])))
    assert 0.0 < sens["states"] < 1e-3, sens
    _close(st[:, k], sj[:, k], max(TOL, 4.0 * sens["states"]),
           "states at the knot")
    for key in ("pri", "dua"):
        _close(ot[key].numpy()[k], np.asarray(oj[key])[k],
               max(TOL, 4.0 * sens[key]), f"{key} at the knot")


def test_device_accelerate_matches_host():
    """The branch-free Nesterov step of FleetRunner equals the host
    ADMMProblem._accelerate over a converging and restarting sequence
    (tests/test_fleet_runner.py:56 for the JAX package)."""
    pt = _torch_formation()
    runner = FleetRunner(pt, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(3)
    shZ, shL = pt.Z.shape, pt.L.shape
    pt.nesterov = True
    pt.nesterov_reset = True
    pt.eta = runner.eta
    pt._alpha = 1.0
    pt._c_res_p = None
    Z0 = rng.standard_normal(shZ)
    L0 = rng.standard_normal(shL)
    pt._Z_p, pt._L_p = Z0.copy(), L0.copy()
    acc = runner._accel_init(torch.as_tensor(Z0), torch.as_tensor(L0))
    for k in range(8):
        Zk = rng.standard_normal(shZ)
        Lk = rng.standard_normal(shL)
        pri = float(abs(rng.standard_normal())) * (0.5 ** k)
        dua = float(abs(rng.standard_normal())) * (0.5 ** k)
        if k == 5:
            pri, dua = 10.0, 10.0          # force a restart
        pt.Z, pt.L = Zk.copy(), Lk.copy()
        pt._accelerate(runner.rho * pri * pri + dua * dua)
        Zd, Ld, acc = runner._accelerate(
            torch.as_tensor(Zk), torch.as_tensor(Lk), acc,
            torch.tensor(pri, dtype=torch.float64),
            torch.tensor(dua, dtype=torch.float64))
        _close(Zd.numpy(), pt.Z, 1e-12, f"Z {k}")
        _close(Ld.numpy(), pt.L, 1e-12, f"L {k}")


def test_fleet_needs_cuda_and_a_mesh_of_its_device(monkeypatch, formations):
    """No device means CUDA; the mesh functions need a mesh
    (``omg_tools_tpu/parallel/fleet_runner.py:408-409``), and a mesh of
    the runner's device type; the exporter is the JAX package's."""
    import types
    pt = formations[1]
    with pytest.raises(ValueError, match="cuda mesh for a runner on cpu"):
        FleetRunner(pt, device="cpu",
                    mesh=types.SimpleNamespace(device_type="cuda"))
    runner = FleetRunner(pt, device="cpu")
    with pytest.raises(ValueError, match="construct the FleetRunner with a "
                       "mesh"):
        runner.mesh_iterate_fn(2)
    exporter = pt.export()
    assert isinstance(exporter, T.ExportFormation)
    assert type(exporter).__name__ == "ExportFormation"   # the JAX name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetRunner(pt)
    from omg_tools_torch.environment import shapes
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _formation(T, shapes)


# -- the generic ALM mode's joint evaluation ------------------------------------

@pytest.fixture(scope="module")
def bench_scene():
    """bench.py's p2p_holonomic scene (generic mode) and a scaled-space
    state with a Newton direction to its line-search candidates."""
    problem = build_p2p_holonomic(
        solver_options={"outer_iter": 1, "inner_iter": 1},
        options={"device": "cpu"})
    tr = problem.transcription
    rng = np.random.default_rng(5)
    B = 2
    x = torch.as_tensor(tr.initial_guess() + 0.05 * rng.standard_normal(
        (B, tr.n_x)))
    p = torch.as_tensor(np.tile(problem.pack_parameters(0.0), (B, 1)))
    lam = torch.as_tensor(rng.standard_normal((B, tr.n_g)))
    rho = torch.tensor([10.0, 50.0], dtype=torch.float64)
    dx = torch.as_tensor(0.1 * rng.standard_normal((B, tr.n_x)))
    return problem, x, p, lam, rho, dx


def test_generic_evaluation_matches_per_op_ad(bench_scene):
    """One forward-over-reverse replay gives what the separate per-op
    evaluations gave (f, g, grad f, J, Hess f), and the joint replay at
    the line-search candidates the same merits, to 1e-12 relative."""
    problem, x, p, lam, rho, dx = bench_scene
    tr = problem.transcription
    solver = problem._solver
    d = torch.as_tensor(problem._row_scale)
    s = problem._obj_scale

    def f(x_, p_):
        return s * tr.objective(x_, p_)

    def g(x_, p_):
        return d * tr.constraints(x_, p_)
    ev = solver.generic_evaluations(x, p)
    got = ev["derivatives"](x)
    want = (vmap(f)(x, p), vmap(g)(x, p), vmap(grad(f))(x, p),
            vmap(jacfwd(g))(x, p), vmap(hessian(f))(x, p))
    for name, a, b in zip(("f", "g", "grad f", "J", "Hess f"), got, want):
        scale = float(b.abs().max())
        _close(a.numpy(), b.numpy(), 1e-12 * scale, name)
    cands = torch.as_tensor(solver.options.ls_candidates,
                            dtype=torch.float64)
    L = cands.shape[0]
    X = x[:, None, :] + cands[None, :, None] * dx[:, None, :]
    lb, ub = solver.scale_bounds(tr.lb, tr.ub, torch.float64,
                                 torch.device("cpu"))

    def merit(fa, ga):
        r = ga + lam[:, None, :] / rho[:, None, None]
        return fa + 0.5 * rho[:, None] * (
            (r - torch.clamp(r, lb, ub)) ** 2).sum(-1)
    f_a, g_a = ev["fg_along"](X)
    Xf, Pf = X.reshape(-1, tr.n_x), p.repeat_interleave(L, dim=0)
    want_m = merit(vmap(f)(Xf, Pf).reshape(-1, L),
                   vmap(g)(Xf, Pf).reshape(-1, L, tr.n_g))
    _close(merit(f_a, g_a).numpy(), want_m.numpy(),
           1e-12 * float(want_m.abs().max()), "merits")


# -- on the card -------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.float64, 1e-10)])
def test_cuda_k1_at_the_formation_shape(cuda_device, dtype, tol):
    """K1 at the formation x-update's shape (4 systems of 85 rows: the
    ``block`` variant) against its plain version."""
    rng = np.random.default_rng(7)
    A = rng.standard_normal((4, 85, 85))
    H = torch.as_tensor(A @ A.transpose(0, 2, 1) / 85 + np.eye(85),
                        dtype=dtype, device=cuda_device)
    g = torch.as_tensor(rng.standard_normal((4, 85)), dtype=dtype,
                        device=cuda_device)
    assert pk.variant(85, 1, dtype) == "block"
    before = pk.psd_solve.launches
    got = pk.psd_solve(H, g)
    want = pk.psd_solve_plain(H, g)
    torch.cuda.synchronize()
    assert pk.psd_solve.launches == before + 1
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_captured_newton_step_equals_eager(cuda_device, dtype):
    """The generic mode's Newton step replayed from its CUDA graph equals
    the eager step bit for bit, and each replay counts its K1 launch."""
    from omg_tools_torch.ops.alm import CapturedCall
    pt = _torch_formation()
    tr = pt.template.transcription
    solver = pt.template._solver
    dev = dict(dtype=dtype, device=cuda_device)
    x = torch.as_tensor(np.tile(tr.initial_guess(), (N, 1)), **dev)
    p = torch.as_tensor(pt._pack_params(pt.groups[0], 0.0), **dev)
    lam = torch.zeros((N, tr.n_g), **dev)
    rho = torch.full((N,), 10.0, **dev)
    lb, ub = solver.scale_bounds(tr.lb, tr.ub, dtype, cuda_device)
    args = (x, lam, rho, lb, ub, p)
    for _ in range(3):
        eager = solver.generic_step(*args)
        graphed = CapturedCall(solver.generic_step, args)
        before = pk.psd_solve.launches
        replayed = graphed(*args)
        torch.cuda.synchronize()
        assert pk.psd_solve.launches == before + graphed.k1_launches == \
            before + 1
        for a, b in zip(eager, replayed):
            assert torch.equal(a, b)
        args = (eager[0].clone(),) + args[1:]


@pytest.mark.gpu
@pytest.mark.parametrize("hessian", ["gn", "eigh"])
def test_cuda_generic_solve_matches_cpu(cuda_device, hessian):
    """A generic-mode solve of the formation template on the card against
    the same solve on the CPU, in float64 at the cut budget, from the
    initial guess plus a seeded 1e-2 (the straight-line guess puts rows on
    their bounds, where the CPU's own Gauss-Newton solve moves by 6e-2
    under a 1e-15 move of the start; from the moved start, by 5e-14).  The
    Gauss-Newton mode replays its CUDA graphs, a K1 launch a Newton step
    (and one more in the capture's eager warm-up), and is held to 1e-8.  The ``eigh`` mode, whose eigensolver synchronizes
    with the host, runs eagerly and launches no K1; its saddle-free step
    moves by up to 1e-7 under a 1e-15 move of this start, and its solve by
    up to O(1), so here it is held to run and stay finite
    (``tests/test_torch_alm_cuda.py`` holds it to the CPU on small NLPs)."""
    from omg_tools_torch.ops.alm import ALMOptions, make_alm_solver
    pt = _torch_formation()
    tmpl = pt.template
    tr = tmpl.transcription
    solver = make_alm_solver(
        tr.objective, tr.constraints, tr.n_x, tr.lb, tr.ub,
        ALMOptions(hessian=hessian, **BUDGET), row_scale=tmpl._row_scale,
        obj_scale=tmpl._obj_scale, fg=tr.objective_and_constraints)
    x0 = np.tile(tr.initial_guess(), (N, 1))
    x0 = x0 + 1e-2 * np.random.default_rng(1).standard_normal(x0.shape)
    p = pt._pack_params(pt.groups[0], 0.0)
    out, steps = {}, {}
    for device in (torch.device("cpu"), cuda_device):
        before = pk.psd_solve.launches
        st = solver(torch.as_tensor(x0, device=device),
                    torch.as_tensor(p, device=device), tr.lb, tr.ub)
        out[device.type] = st.x.cpu().numpy()
        steps[device.type] = int(st.n_iter.max())
        launched = pk.psd_solve.launches - before
    # one K1 launch a Newton step in the Gauss-Newton mode, and one in
    # the warm-up of its first solve's capture; none in eigh's
    assert launched == (steps["cuda"] + 1 if hessian == "gn" else 0)
    assert steps["cuda"] == steps["cpu"] > 0
    assert np.isfinite(out["cuda"]).all()
    if hessian == "gn":
        _close(out["cuda"], out["cpu"], TOL, "Gauss-Newton solve")

"""G-code machining in the port held to the JAX package in float64 on the
CPU: the G-code blocks and reader (``gui/gcode_block.py``,
``gui/gcode_reader.py``), the segments (``blocks_to_segments``,
``split_ring_segments``) and the three guesses of
``problems/gcodeproblem.py``, the Tool's transcription in a
``GCodeProblem``, a cut-budget solve, the host steps of the closed loop
(``init_step``, ``store``, ``simulate``) and ``GCodeSchedulerProblem``'s
window roll.

Programs: the nine ``.nc`` files of examples/GCode_examples, read where
they lie, each with its example's Tool (tolerance, options, knots).
Windows: tests/test_vehicles.py::test_tool_gcode_segment's (a zero-length
rapid, then a 4 mm straight: ``straight``) and the window of
gcodeproblem_slot_multi.py after its two rolls (a straight tube and a
ring under the machining limit: ``ring``).

Tolerances: the blocks, segments, layouts, bounds and parameters equal;
the guesses (bang-bang jerk, ring centerline, motion time), f, g and J at
the guess and at a seeded perturbation, the host steps and the window
roll's hand-down guess and first iterate to 1e-12 relative.  The solve,
on a cut budget (1 outer x 8 inner iterations) from the closed loop's
start plus a seeded 1e-2 (the start itself is degenerate: a 1e-15 move
of it moves the JAX package's solve by ~1), is held to 4x the largest
move of the JAX package's own solve over 5 draws of a 1e-15 relative
perturbation of that start (tests/test_torch_free_time.py's rule), or
1e-10 where rounding alone separates them.

Time: the JAX package compiles one solver here (~30 s) and builds four
window problems (~5 s each); the window roll runs no solve (the local
problems' ``solve`` is replaced by a recorder while the scheduler rolls).
"""

import contextlib
import glob
import os

import numpy as np
import pytest
import torch

import omg_tools_torch as T
from omg_tools_torch.ops.alm import make_alm_solver
from omg_tools_torch.problems import gcodeproblem as tg
from torch_bench_configs import _layout_rows, one_torch_thread  # noqa: F401
from test_torch_multiframe import cut_budget
import chip_smoke

RTOL = 1e-12
CUT = {"outer_iter": 1, "inner_iter": 8}
START_NOISE = 1e-2
DRAWS = 5
PERTURB = 1e-15
SPREAD_FACTOR = 4.0
ROUNDING_FLOOR = 1e-10

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GCODE_DIR = os.path.join(ROOT, "examples", "GCode_examples")
PROGRAMS = sorted(os.path.basename(p)
                  for p in glob.glob(os.path.join(GCODE_DIR, "*.nc")))
# each program's Tool, as its example makes it: (Tool arguments, knots)
TOOLS = {"anchor.nc": ({"tolerance": 0.6, "tol_small": 0.15,
                        "options": {"variable_tolerance": True}}, 6),
         "multi_z.nc": ({"tolerance": 0.4}, 5),
         "racetrack.nc": ({"tolerance": 0.5}, 5),
         "rounded_slot.nc": ({"tolerance": 0.25}, 5),
         "rsq5.nc": ({"tolerance": 0.4,
                      "options": {"vel_limit": "machining"}}, 5),
         "slot_multi.nc": ({"tolerance": 0.3}, 5),
         "stair.nc": ({"tolerance": 0.3}, 5),
         "star.nc": ({"tolerance": 0.4}, 5),
         "star_octa.nc": ({"tolerance": 0.35}, 5)}
_BUILT = {}


@pytest.fixture(scope="module")
def J():
    """The JAX package (float64)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    return pytest.importorskip("omg_tools_tpu")


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def _blocks(m, program):
    reader = m.GCodeReader()
    reader.load_file(os.path.join(GCODE_DIR, program))
    return reader, reader.parse()


def _tool(m, program, start):
    args, knots = TOOLS[program]
    tool = m.Tool(**args)
    tool.define_knots(knot_intervals=knots)
    tool.set_initial_conditions(start)
    return tool


def _segments(m, program):
    _, blocks = _blocks(m, program)
    tool = _tool(m, program, blocks[0].start)
    mod = tg if m is T else m.problems.gcodeproblem
    return tool, mod.split_ring_segments(
        mod.blocks_to_segments(blocks, tool.tolerance),
        tolerance=tool.tolerance)


# -- the reader, the blocks and the segments ----------------------------------

@pytest.mark.parametrize("program", PROGRAMS)
def test_reader_and_blocks_match_jax(J, program):
    """The command lines (comments dropped), the parsed blocks (modal
    G-state, arcs' centres and radii, lengths, samples), the connections
    and the mm -> m conversion."""
    (tr, tb), (jr, jb) = _blocks(T, program), _blocks(J, program)
    assert tr.commands == jr.commands and len(tb) == len(jb) > 0
    for a, b in zip(tb, jb):
        assert (a.type, a.number, a.start, a.end, a.F, a.S) == \
            (b.type, b.number, b.start, b.end, b.F, b.S)
        assert a.length() == b.length()
        np.testing.assert_array_equal(a.sample(), b.sample())
        assert a.get_coordinates() == b.get_coordinates()
        if a.type in ("G02", "G03"):
            assert (a.center, a.radius, a.angles()) == \
                (b.center, b.radius, b.angles())
    assert tr.get_connections() == jr.get_connections()
    tm = T.GCodeReader().get_gcode(os.path.join(GCODE_DIR, program))
    jm = J.GCodeReader().get_gcode(os.path.join(GCODE_DIR, program))
    for a, b in zip(tm, jm):
        assert (a.start, a.end, getattr(a, "center", None),
                getattr(a, "radius", None)) == \
            (b.start, b.end, getattr(b, "center", None),
             getattr(b, "radius", None))
    assert {type(b).__name__ for b in tb} <= {"G00", "G01", "G02", "G03"}


def _shape_fields(shape):
    if type(shape).__name__ == "Ring":
        return ("Ring", shape.radius_in, shape.radius_out, shape.start,
                shape.end, shape.direction)
    return (type(shape).__name__, shape.width, shape.height,
            shape.orientation)


@pytest.mark.parametrize("program", PROGRAMS)
def test_segments_match_jax(J, program):
    """``blocks_to_segments`` (tubes around straights, annuli around
    arcs; a zero-length block's orientation 0) and
    ``split_ring_segments`` (arcs beyond pi/2 cut into parts)."""
    (_, ts), (_, js) = _segments(T, program), _segments(J, program)
    assert len(ts) == len(js) > 0
    for a, b in zip(ts, js):
        assert _shape_fields(a["shape"]) == _shape_fields(b["shape"])
        assert (a["pose"], a["start"], a["end"], a["number"]) == \
            (b["pose"], b["start"], b["end"], b["number"])


@pytest.mark.parametrize("program", PROGRAMS)
def test_guesses_match_jax(J, program):
    """Every segment's first iterate: the bang-bang jerk guess (straight)
    or the ring centerline fit (arc), and the motion-time guesses with
    and without those coefficients, to 1e-12."""
    (tt, ts), (jt, js) = _segments(T, program), _segments(J, program)
    jg = J.problems.gcodeproblem
    for a, b in zip(ts, js):
        ring = type(a["shape"]).__name__ == "Ring"
        guess_t = (tg.ring_guess if ring else tg.bangbang_jerk_guess)(tt, a)
        guess_j = (jg.ring_guess if ring else jg.bangbang_jerk_guess)(jt, b)
        _close(guess_t, guess_j)
        _close(tg.motion_time_guess(tt, a, coeff_guess=guess_t),
               jg.motion_time_guess(jt, b, coeff_guess=guess_j))
        _close(tg.motion_time_guess(tt, a), jg.motion_time_guess(jt, b))


# -- windows --------------------------------------------------------------

def _straight_window(m, options):
    """tests/test_vehicles.py::test_tool_gcode_segment's problem."""
    reader = m.GCodeReader()
    blocks = reader.parse(["G00 X0 Y0 Z0", "G01 X4 Y0 Z0"])
    tool = m.Tool(tolerance=0.2)
    tool.define_knots(knot_intervals=5)
    tool.set_initial_conditions(blocks[0].start)
    tool.set_terminal_conditions(blocks[-1].end)
    mod = tg if m is T else m.problems.gcodeproblem
    segments = mod.split_ring_segments(
        mod.blocks_to_segments(blocks, tool.tolerance),
        tolerance=tool.tolerance)
    rooms = [dict(s) for s in segments]
    for room in rooms:
        room.setdefault("position", room["pose"][:2])
    problem = m.GCodeProblem(tool, m.Environment(room=rooms), len(rooms),
                             {"verbose": 0, **options})
    problem.init()
    return problem


@contextlib.contextmanager
def recorded_local_solves(*packages):
    """Within the block, a GCodeProblem's ``solve`` records its first
    iterate instead of solving: the scheduler rolls its window as it
    would before a solve."""
    saved, calls = [], []
    for m in packages:
        cls = m.problems.gcodeproblem.GCodeProblem

        def record(self, current_time, update_time):
            calls.append((self, np.array(self._x_result, np.float64)))
            self.solver_stats = {"iterations": 0}
            self.update_times, self.iteration = [], 0
        saved.append((cls, cls.__dict__.get("solve")))
        cls.solve = record
    try:
        yield calls
    finally:
        for cls, orig in saved:
            if orig is None:
                del cls.solve
            else:
                cls.solve = orig


def _rolled(m, options):
    """gcodeproblem_slot_multi.py's scheduler after two solves at the
    start: its first two blocks have zero length, so the window rolls in
    each (the tool stays where both end).  Returns the scheduler, the
    roll records (window_start, hand-down, first iterate) and the
    windows' guesses as built."""
    problem = chip_smoke.build_scene(m, "gcode_slot_multi", options)
    problem.init()
    rolls = []
    orig = problem._handdown_guess

    def handdown():
        out = orig()
        rolls.append([(np.array(c), t) for c, t in out])
        return out
    problem._handdown_guess = handdown
    with recorded_local_solves(m) as calls:
        problem.initialize(0.0)
        for _ in range(2):
            problem.solve(0.0, chip_smoke.GCODE_SIMULATOR["update_time"])
    return problem, rolls, calls


def _pair(J, window):
    if window not in _BUILT:
        out = []
        with cut_budget(J, T, budget=CUT):
            for m, options in ((J, {}), (T, {"device": "cpu"})):
                out.append(_straight_window(m, options) if window ==
                           "straight" else _rolled(m, options))
        _BUILT[window] = tuple(out)
    return _BUILT[window]


def _window_problems(J, window):
    jp, tp = _pair(J, window)
    if window == "straight":
        return jp, tp
    return jp[0].local_problem, tp[0].local_problem


def test_window_roll_matches_jax(J):
    """slot_multi's first two updates roll the window twice before any
    solve (segment 0 and 1 end where the tool stands): the same window
    index, windows built, hand-down guesses (segment k+1's coefficients
    and motion time) and the new windows' first iterates."""
    (js, jrolls, jcalls), (ts, trolls, tcalls) = _pair(J, "ring")
    assert ts.window_start == js.window_start == 2
    assert ts.cnt_windows == js.cnt_windows == 3
    assert len(ts.segments_all) == len(js.segments_all) == 22
    assert len(trolls) == len(jrolls) == 2
    for a, b in zip(trolls, jrolls):
        assert len(a) == len(b) == 1
        _close(a[0][0], b[0][0])
        assert a[0][1] == pytest.approx(b[0][1], rel=RTOL)
    assert len(tcalls) == len(jcalls) == 2
    for (tp, tx), (jp, jx) in zip(tcalls, jcalls):
        _close(tx, jx)
        assert tp.n_segments == jp.n_segments == 2
    # the new window's segment 0 starts from the hand-down guess
    tr = tcalls[-1][0].transcription
    sl, _ = tr.var_slice(ts.tool, "splines_seg0")
    _close(tcalls[-1][1][sl], trolls[-1][0][0].reshape(-1))
    assert [type(s["shape"]).__name__ for s in
            ts.segments_all[ts.window_start:ts.window_start + 2]] == \
        ["Rectangle", "Ring"]
    assert not ts.stop_criterium(0.0, 0.02)


@pytest.mark.parametrize("window", ["straight", "ring"])
def test_transcription_matches_jax(J, window):
    """The window problem's layout, parameters, guess and bounds; f, g
    and J at the guess and at a seeded perturbation; the row scales."""
    import jax
    import jax.numpy as jnp
    jp, tp = _window_problems(J, window)
    a, b = jp.transcription, tp.transcription
    assert (a.n_x, a.n_p, a.n_g) == (b.n_x, b.n_p, b.n_g)
    assert b.n_x == 50
    for table in ("variables", "parameters"):
        assert _layout_rows(a.layout, table) == \
            _layout_rows(b.layout, table), table
    assert [(c.offset, c.rows) for c in a.layout.constraints] == \
        [(c.offset, c.rows) for c in b.layout.constraints]
    _close(tp._x_result, jp._x_result)
    P = jp.pack_parameters(0.0)
    _close(tp.pack_parameters(0.0), P)
    for u, v in zip(a.bounds(0.0), b.bounds(0.0)):
        np.testing.assert_array_equal(v, u)
    rng = np.random.default_rng(0)
    x_init = np.array(tp._x_result)
    jac_j = jax.jit(jax.jacfwd(a.constraints))
    for x in (x_init, x_init + 0.1 * rng.standard_normal(a.n_x)):
        xj, pj = jnp.asarray(x), jnp.asarray(P)
        xt, pt = torch.as_tensor(x), torch.as_tensor(P)
        _close(b.constraints(xt, pt), a.constraints(xj, pj))
        _close(b.objective(xt, pt), a.objective(xj, pj))
        _close(torch.func.jacfwd(b.constraints)(xt, pt), jac_j(xj, pj))
    np.testing.assert_allclose(tp._row_scale, jp._row_scale, rtol=1e-10)
    assert tp._structure == "generic"


def _start(problem):
    """The solve's inputs as the closed loop makes them at time 0."""
    tool = problem.vehicles[0]
    problem.initialize(0.0)
    tool.predict(0.0, 0.1, 0.01, enforce_states=True)
    problem.reinitialize()
    lb, ub = problem.transcription.bounds(0.0)
    return (np.array(problem._x_result, np.float64),
            problem.pack_parameters(0.0), np.asarray(lb), np.asarray(ub))


def test_cut_budget_solve_matches_jax(J):
    """test_tool_gcode_segment's cold solve on the cut budget, from the
    same start (plus the seeded noise), against the JAX package's own
    spread."""
    import jax
    import jax.numpy as jnp
    from omg_tools_tpu.ops.alm import ALMOptions as JALMOptions
    from omg_tools_tpu.ops.alm import make_alm_solver as j_make_alm_solver
    jp, tp = _pair(J, "straight")
    x0, P, lb, ub = _start(tp)
    jx0, jP, *_ = _start(jp)
    np.testing.assert_array_equal(P, jP)
    _close(x0, jx0)
    x0 = x0 + START_NOISE * np.random.default_rng(2).standard_normal(x0.shape)
    a, b = jp.transcription, tp.transcription
    js = jax.jit(j_make_alm_solver(
        a.objective, a.constraints, a.n_x, a.lb, a.ub, JALMOptions(**CUT),
        row_scale=jp._row_scale, obj_scale=jp._obj_scale))

    def solve_j(x):
        st = js(jnp.asarray(x), jnp.asarray(P), jnp.asarray(lb),
                jnp.asarray(ub))
        return np.asarray(st.x), float(st.feas)
    want, feas = solve_j(x0)
    rng = np.random.default_rng(3)
    spread = max(float(np.abs(solve_j(
        x0 * (1 + PERTURB * rng.standard_normal(x0.shape)))[0]
        - want).max()) for _ in range(DRAWS))
    ts = make_alm_solver(b.objective, b.constraints, b.n_x, b.lb, b.ub,
                         T.ALMOptions(**CUT), row_scale=tp._row_scale,
                         obj_scale=tp._obj_scale,
                         fg=b.objective_and_constraints)
    st = ts(torch.as_tensor(x0)[None], torch.as_tensor(P)[None], lb, ub)
    err = float(np.abs(st.x[0].numpy() - want).max())
    tol = max(SPREAD_FACTOR * spread, ROUNDING_FLOOR)
    print("straight window cut solve: port vs JAX", err, "spread", spread,
          "feas", feas)
    assert np.isfinite(st.x.numpy()).all()
    assert err <= tol, (err, spread)
    assert float(st.feas[0]) == pytest.approx(feas, rel=1e-6, abs=tol)


@pytest.mark.parametrize("elapsed", [0.0, 0.02])
def test_host_steps_match_jax(J, elapsed):
    """From one seeded iterate of the straight window: ``init_step``
    (segment 0 re-based on what is left of it, T0 moved by hand; nothing
    at the start), the stored trajectories over both segments, one
    simulated period of the plant, the objective and the stop test."""
    jp, tp = _pair(J, "straight")
    rng = np.random.default_rng(4)
    x = np.array(tp._x_result) + 0.01 * rng.standard_normal(
        tp.transcription.n_x)
    for problem in (jp, tp):
        problem._x_result = x.copy()
        problem.set_variables(np.array([2.5]), problem, "T0")
        problem.set_variables(np.array([3.0]), problem, "T1")
        problem.start_time = 0.0
        problem.init_step(elapsed, 0.02)
        problem.store(elapsed, 0.02, 0.002)
        problem.simulate(elapsed, 0.02, 0.002)
    _close(tp._x_result, jp._x_result)
    assert tp.segment_times() == pytest.approx(jp.segment_times(), rel=RTOL)
    if elapsed:
        assert tp.segment_times()[0] == pytest.approx(2.5 - 0.02)
    vj, vt = jp.vehicles[0], tp.vehicles[0]
    for key in ("state", "input", "pose"):
        _close(vt.trajectories[key], vj.trajectories[key])
        _close(vt.signals[key], vj.signals[key])
    assert tp.compute_objective() == pytest.approx(jp.compute_objective())
    assert tp.stop_criterium(elapsed, 0.02) == \
        jp.stop_criterium(elapsed, 0.02)


def test_rollout_recipe_dispatch_matches_jax(J):
    """``make_rollout_model`` picks a recipe by the vehicle's parameter
    names: a Tool's (state0, input0, dinput0, poseT) select the Holonomic
    recipe in both packages (the JAX package does not raise for it; no
    batched runner takes a GCodeProblem in either package)."""
    from types import SimpleNamespace
    import jax.numpy as jnp
    from omg_tools_tpu.problems.rollout_models import \
        make_rollout_model as j_make
    from omg_tools_torch.problems.rollout_models import make_rollout_model
    jp, tp = _pair(J, "straight")

    def runner(problem, dtype):
        return SimpleNamespace(
            vehicle=problem.vehicles[0], tr=problem.transcription,
            steps_per_knot=20, update_time=0.02, horizon=5.0, dtype=dtype,
            device="cpu")
    assert type(make_rollout_model(runner(tp, torch.float64))).__name__ \
        == type(j_make(runner(jp, jnp.float64))).__name__ \
        == "HolonomicRollout"

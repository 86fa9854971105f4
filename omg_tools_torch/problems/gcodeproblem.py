"""G-code machining problems (counterpart of
``omg_tools_tpu.problems.gcodeproblem``, after omgtools
problems/gcodeproblem.py and gcodeschedulerproblem.py):

- GCodeProblem: a MultiFrame-style free-time NLP where each "room" is a
  G-code segment (rectangular tolerance tube for G00/G01, ring annulus for
  G02/G03) and the vehicle is a Tool; C^(degree-1) continuity at joints,
  head/tail coefficient skipping on border segments.
- GCodeSchedulerProblem: rolls a window of n_segments over the block list
  and builds a new local GCodeProblem as segments complete (as the JAX
  package does, it keeps no cache of window problems: on the card each new
  window problem captures its own CUDA graphs at its first solve).  The
  local problems take the scheduler's ``device`` and ``dtype`` options.

The guesses (bang-bang jerk, ring centerline, motion time) are host numpy
on the port's spline engine.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .problem import Problem
from ..modeling.opti import BIG
from ..ops.spline import (BSpline, evalspline, running_integral,
                          sample_spline)
from ..environment.environment import Environment
from ..environment.shapes import Rectangle, Ring
from ..gui.gcode_block import G00, G01, G02, G03

__all__ = ["GCodeProblem", "GCodeSchedulerProblem", "blocks_to_segments",
           "split_ring_segments", "bangbang_jerk_guess", "ring_guess",
           "motion_time_guess"]


def split_ring_segments(segments, max_angle=np.pi / 2, tolerance=None):
    """Split arc segments spanning more than ``max_angle`` into sub-arcs
    (omgtools gcodeschedulerproblem.py:506 ``split_ring_segment`` -- large
    arcs make the tolerance tube strongly non-convex and the NLP
    ill-conditioned)."""
    out = []
    for seg in segments:
        shape = seg["shape"]
        if not isinstance(shape, Ring):
            out.append(seg)
            continue
        start_a, end_a = shape.start, shape.end
        if shape.direction == "CW" and end_a > start_a:
            end_a -= 2 * np.pi
        if shape.direction == "CCW" and end_a < start_a:
            end_a += 2 * np.pi
        span = end_a - start_a
        n_parts = max(1, int(np.ceil(abs(span) / max_angle)))
        if n_parts == 1:
            out.append(seg)
            continue
        center = np.asarray(seg["pose"][:2], dtype=np.float64)
        radius = 0.5 * (shape.radius_in + shape.radius_out)
        z0 = seg["start"][2] if len(seg["start"]) > 2 else 0.0
        z1 = seg["end"][2] if len(seg["end"]) > 2 else 0.0
        angles = start_a + span * np.linspace(0.0, 1.0, n_parts + 1)
        for k in range(n_parts):
            a0, a1 = angles[k], angles[k + 1]
            p0 = center + radius * np.array([np.cos(a0), np.sin(a0)])
            p1 = center + radius * np.array([np.cos(a1), np.sin(a1)])
            zk0 = z0 + (z1 - z0) * k / n_parts
            zk1 = z0 + (z1 - z0) * (k + 1) / n_parts
            out.append({
                "shape": Ring(radius_in=shape.radius_in,
                              radius_out=shape.radius_out,
                              start=a0, end=a1, direction=shape.direction),
                "pose": list(seg["pose"]),
                "start": [float(p0[0]), float(p0[1]), float(zk0)],
                "end": [float(p1[0]), float(p1[1]), float(zk1)],
                "number": seg["number"]})
    return out


def blocks_to_segments(blocks, tolerance):
    """Tolerance tubes around G-code blocks (omgtools
    gcodeschedulerproblem.py:230-505, straight/arc cases)."""
    segments = []
    for b in blocks:
        start, end = np.asarray(b.start), np.asarray(b.end)
        if isinstance(b, (G02, G03)):
            segments.append({
                "shape": Ring(radius_in=b.radius - tolerance,
                              radius_out=b.radius + tolerance,
                              start=np.arctan2(start[1] - b.center[1],
                                               start[0] - b.center[0]),
                              end=np.arctan2(end[1] - b.center[1],
                                             end[0] - b.center[0]),
                              direction="CW" if isinstance(b, G02) else "CCW"),
                "pose": list(b.center), "start": list(start),
                "end": list(end), "number": b.number})
        else:
            vec = end[:2] - start[:2]
            length = float(np.linalg.norm(vec))
            orientation = float(np.arctan2(vec[1], vec[0])) if length > 1e-12 \
                else 0.0
            mid = 0.5 * (start + end)
            segments.append({
                "shape": Rectangle(width=length + 2 * tolerance,
                                   height=2 * tolerance,
                                   orientation=orientation),
                "pose": [float(mid[0]), float(mid[1]), float(mid[2])],
                "start": list(start), "end": list(end), "number": b.number})
    return segments


def bangbang_jerk_guess(tool, segment):
    """Jerk bang-bang initial guess for a straight segment (omgtools
    gcodeschedulerproblem.py:877 ``get_init_guess_bangbang_jerk``): a
    zero-mean +-j_lim square-wave jerk coefficient pattern on the 3rd-
    derivative basis is integrated three times to a rest-to-rest position
    profile, then scaled from segment start to end per axis."""
    basis = tool.basis
    jbasis, _ = basis.derivative(3)
    n_coeffs = len(jbasis)
    j_lim = tool.jxmax if tool.jxmax != 0.0 else tool.jzmax
    multiple, rest = divmod(n_coeffs, 4)
    m = multiple
    if rest == 0:
        pattern = np.r_[np.ones(m), -np.ones(2 * m), np.ones(m)]
    elif rest == 1:
        pattern = np.r_[np.ones(m), -np.ones(m), [0.0], -np.ones(m),
                        np.ones(m)]
    elif rest == 2:
        pattern = np.r_[np.ones(m), [0.0], -np.ones(2 * m), [0.0],
                        np.ones(m)]
    else:
        pattern = np.r_[np.ones(m), [0.0], -np.ones(m), [0.0], -np.ones(m),
                        [0.0], np.ones(m)]
    jerk = BSpline(jbasis, j_lim * pattern)
    pos = running_integral(running_integral(running_integral(jerk)))
    guess = np.asarray(pos.coeffs, dtype=np.float64)
    if len(guess) != len(basis):
        # non-clamped corner case: fall back to a straight line
        guess = np.linspace(0.0, 1.0, len(basis))
    end = max(float(guess[-1]), 1e-12)
    start = np.asarray(segment["start"], dtype=np.float64)
    stop = np.asarray(segment["end"], dtype=np.float64)
    init = np.zeros((len(basis), 3))
    for axis in range(2):
        init[:, axis] = guess / end * (stop[axis] - start[axis]) + start[axis]
        init[:3, axis] = start[axis]       # rest-to-rest clamping
        init[-3:, axis] = stop[axis]
    z0 = start[2] if len(start) > 2 else 0.0
    z1 = stop[2] if len(stop) > 2 else 0.0
    init[:, 2] = np.linspace(z0, z1, len(basis))
    return init


def ring_guess(tool, segment):
    """Initial guess for an arc segment: the ring centerline sampled along
    the arc, fit by Greville collocation, with rest-to-rest clamping (the
    deterministic analog of omgtools' dedicated guess NLP,
    gcodeschedulerproblem.py:1010)."""
    basis = tool.basis
    shape = segment["shape"]
    center = np.asarray(segment["pose"][:2], dtype=np.float64)
    radius = 0.5 * (shape.radius_in + shape.radius_out)
    a0, a1 = shape.start, shape.end
    if shape.direction == "CW" and a1 > a0:
        a1 -= 2 * np.pi
    if shape.direction == "CCW" and a1 < a0:
        a1 += 2 * np.pi

    def midline(g):
        ang = a0 + (a1 - a0) * np.asarray(g)
        return np.stack([center[0] + radius * np.cos(ang),
                         center[1] + radius * np.sin(ang)], axis=1)

    coeffs = basis.solve_collocation(midline)          # (n, 2)
    init = np.zeros((len(basis), 3))
    init[:, :2] = coeffs
    start = np.asarray(segment["start"], dtype=np.float64)
    stop = np.asarray(segment["end"], dtype=np.float64)
    init[0, :2] = start[:2]
    init[-1, :2] = stop[:2]
    z0 = start[2] if len(start) > 2 else 0.0
    z1 = stop[2] if len(stop) > 2 else 0.0
    init[:, 2] = np.linspace(z0, z1, len(basis))
    return init


def motion_time_guess(tool, segment, coeff_guess=None):
    """Per-segment motion-time estimate (omgtools
    gcodeschedulerproblem.py:1133 ``get_init_guess_motion_time``).

    With spline coefficients given: the smallest T such that the scaled
    velocity/acceleration/jerk profiles respect the tool limits (closed
    form from sampled derivative maxima -- omgtools solves the same
    scaling relations).  Without: the 7-phase jerk-limited S-curve timing
    over the segment length."""
    j_lim = tool.jxmax if tool.jxmax != 0.0 else tool.jzmax
    a_lim = tool.axmax if tool.axmax != 0.0 else tool.azmax
    v_lim = tool.vxmax if tool.vxmax != 0.0 else tool.vzmax
    if coeff_guess is not None:
        basis = tool.basis
        grid = np.linspace(0.0, 1.0, 100)
        T_req = 0.0
        cols = [0, 1] if tool.vxmax != 0.0 else [2]
        for axis in cols:
            s = BSpline(basis, np.asarray(coeff_guess)[:, axis])
            vel = np.max(np.abs(np.asarray(
                sample_spline(s.derivative(), grid))))
            acc = np.max(np.abs(np.asarray(
                sample_spline(s.derivative(2), grid))))
            jrk = np.max(np.abs(np.asarray(
                sample_spline(s.derivative(3), grid))))
            T_req = max(T_req, vel / max(v_lim, 1e-9),
                        np.sqrt(acc / max(a_lim, 1e-9)),
                        (jrk / max(j_lim, 1e-9)) ** (1.0 / 3.0))
        return 1.05 * max(T_req, 1e-2)
    shape = segment["shape"]
    if isinstance(shape, Ring):
        radius = 0.5 * (shape.radius_in + shape.radius_out)
        a0, a1 = shape.start, shape.end
        if shape.direction == "CW" and a1 > a0:
            a1 -= 2 * np.pi
        if shape.direction == "CCW" and a1 < a0:
            a1 += 2 * np.pi
        distance = radius * abs(a1 - a0)
    else:
        distance = float(np.linalg.norm(
            np.asarray(segment["end"]) - np.asarray(segment["start"])))
    # 7-phase S-curve: T1 limited by reaching a_lim, v_lim or the distance
    T1 = min(a_lim / j_lim, np.sqrt(v_lim / j_lim),
             (32.0 * distance / j_lim) ** (1.0 / 3.0) / 4.0)
    v1 = j_lim * T1 ** 2                   # velocity after phases 1-3
    d_acc = 2.0 * j_lim * T1 ** 3          # distance over phases 1-3 + 6-8
    d_cruise = max(distance - d_acc, 0.0)
    T_cruise = d_cruise / max(v1, 1e-9)
    return 1.05 * max(4.0 * T1 + T_cruise, 1e-2)


class GCodeProblem(Problem):

    def __init__(self, fleet, environment, n_segments, options=None):
        Problem.__init__(self, fleet, environment, options,
                         label="gcodeproblem")
        self.n_segments = n_segments
        self.init_time = None
        self.start_time = 0.0
        self.objective = 0.0

    def set_default_options(self):
        Problem.set_default_options(self)
        self.options["no_term_con_der"] = False

    def construct(self):
        tool = self.vehicles[0]
        self.t = self.define_parameter("t")[0]
        self.motion_times = [
            self.define_variable(f"T{k}", value=10.0)[0]
            for k in range(self.n_segments)]
        for child in self.children:
            child.problem_t = self.t
            child.problem_T = self.motion_times[0]
        self.define_objective(sum(self.motion_times))
        for T in self.motion_times:
            self.define_constraint(-T, -BIG, 0.0)
        tool.init()
        total_splines = tool.define_splines(n_seg=self.n_segments)
        for idx in range(self.n_segments):
            if idx == 0 and self.n_segments > 1:
                skip = (1, 0)
            elif idx == self.n_segments - 1 and self.n_segments > 1:
                skip = (0, 1)
            else:
                skip = ()
            tool.define_trajectory_constraints(
                total_splines[idx], self.motion_times[idx], skip=skip)
            tool.define_collision_constraints(
                self.environment.room[idx], total_splines[idx],
                self.motion_times[idx])
        self.define_init_constraints()
        self.define_terminal_constraints()
        self.define_connection_constraints()

    def define_init_constraints(self):
        tool = self.vehicles[0]
        init_con = tool.get_initial_constraints(tool.splines[0],
                                                self.motion_times[0])
        for spline, condition in init_con:
            self.define_constraint(
                evalspline(spline, self.t / self.motion_times[0])
                - condition, 0.0, 0.0)

    def define_terminal_constraints(self):
        tool = self.vehicles[0]
        term_con, term_con_der = tool.get_terminal_constraints(
            tool.splines[-1], horizon_time=self.motion_times[-1])
        if self.options.get("no_term_con_der", False):
            term_con_der = []
        for spline, condition in term_con + term_con_der:
            self.define_constraint(
                evalspline(spline, np.asarray(1.0)) - condition, 0.0, 0.0)

    def define_connection_constraints(self):
        tool = self.vehicles[0]
        degree = tool.degree
        for j in range(self.n_segments - 1):
            for s1, s2 in zip(tool.splines[j], tool.splines[j + 1]):
                for d in range(degree):
                    v1 = evalspline(s1.derivative(d), np.asarray(1.0))
                    v2 = evalspline(s2.derivative(d), np.asarray(0.0))
                    self.define_constraint(
                        v1 * self.motion_times[j + 1] ** d
                        - v2 * self.motion_times[j] ** d, 0.0, 0.0)

    def set_parameters(self, current_time):
        parameters = {self: {}}
        parameters[self]["t"] = 0.0 if self.init_time is None \
            else self.init_time
        return parameters

    def time_parameter(self, current_time):
        return 0.0 if self.init_time is None else float(self.init_time)

    # -- lifecycle ---------------------------------------------------------
    def initialize(self, current_time):
        self.start_time = current_time

    def segment_times(self):
        return [float(self.get_variables(self, f"T{k}")[0])
                for k in range(self.n_segments)]

    def reinitialize(self, father=None, handdown=None):
        """Per-segment initial guesses: bang-bang jerk profile for straight
        tubes, centerline fit for arcs, with the S-curve / scaling-based
        motion-time estimates (omgtools gcodeschedulerproblem.py:877,
        :1010, :1133).  ``handdown``: (coeffs, T) pairs carried over from a
        rolled window (segment k+1 -> k)."""
        tool = self.vehicles[0]
        tr = self.transcription
        for k in range(self.n_segments):
            seg = self.environment.room[k]
            if handdown is not None and k < len(handdown):
                init, T_guess = handdown[k]
            else:
                if isinstance(seg["shape"], Ring):
                    init = ring_guess(tool, seg)
                else:
                    init = bangbang_jerk_guess(tool, seg)
                T_guess = motion_time_guess(tool, seg, coeff_guess=init)
            sl, _ = tr.var_slice(tool, f"splines_seg{k}")
            self._x_result[sl] = np.asarray(init).reshape(-1)
            slT, _ = tr.var_slice(self, f"T{k}")
            self._x_result[slT] = max(float(T_guess), 0.1)
        self._ip_state = None

    def store(self, current_time, update_time, sample_time):
        segment_times = self.segment_times()
        horizon_time = sum(segment_times)
        rel = 0.0 if self.init_time is None else self.init_time
        if horizon_time < sample_time:
            return
        tool = self.vehicles[0]
        n_samp = int(round((horizon_time - rel) / sample_time, 6)) + 1
        time_axis = np.linspace(rel, rel + (n_samp - 1) * sample_time, n_samp)
        segments = [self.get_variables(tool, f"splines_seg{k}")
                    for k in range(tool.n_seg)]
        tool.store(current_time, sample_time, segments, segment_times,
                   time_axis)

    def init_step(self, current_time, update_time):
        if (current_time - self.start_time) > 0:
            T = sum(self.segment_times())
            target_time = T if T < 2 * update_time else T - update_time
            M = self.transcription.spline_shift_matrix(
                lambda basis: basis.shift_spline_T(update_time / target_time),
                block_filter=lambda blk: "seg0" in blk.name)
            self.transform_primal_splines(M)
            T0 = float(self.get_variables(self, "T0")[0])
            self.set_variables(np.array([max(T0 - update_time, 1e-3)]),
                               self, "T0")

    def simulate(self, current_time, simulation_time, sample_time):
        horizon_time = sum(self.segment_times())
        if horizon_time < sample_time:
            return
        simulation_time = min(simulation_time, horizon_time)
        self.objective = current_time + simulation_time - self.start_time
        Problem.simulate(self, current_time, simulation_time, sample_time)

    def stop_criterium(self, current_time, update_time):
        if sum(self.segment_times()) < update_time:
            return True
        return all(v.check_terminal_conditions() for v in self.vehicles)

    def compute_objective(self):
        return self.objective

    def final(self):
        if self.options["verbose"] >= 1:
            print("\nMachining done!")


class GCodeSchedulerProblem(Problem):
    """Rolling window of n_segments local GCodeProblems over the block list
    (omgtools gcodeschedulerproblem.py:38+)."""

    def __init__(self, tool, gcode_blocks, options=None, n_segments=2,
                 **kwargs):
        environment = Environment(room=[{"shape": Rectangle(1.0, 1.0)}])
        Problem.__init__(self, tool, environment, options,
                         label="gcodeschedulerproblem")
        self.tool = self.vehicles[0]
        self.blocks = list(gcode_blocks)
        self.n_segments = min(n_segments, len(self.blocks))
        self.segments_all = split_ring_segments(
            blocks_to_segments(self.blocks, self.tool.tolerance),
            tolerance=self.tool.tolerance)
        self.window_start = 0
        self.cnt_windows = 0

    def init(self):
        self._make_window_problem()

    def _make_window_problem(self, handdown=None):
        segs = self.segments_all[self.window_start:
                                 self.window_start + self.n_segments]
        rooms = [dict(s) for s in segs]
        for room in rooms:
            room.setdefault("position", room["pose"][:2])
            room.setdefault("draw", True)
        local_env = Environment(room=rooms)
        self.tool.set_terminal_conditions(list(segs[-1]["end"]))
        options = {"verbose": 0, "device": self.options["device"],
                   "dtype": self.options["dtype"]}
        self.local_problem = GCodeProblem(self.tool, local_env, len(segs),
                                          options)
        self.local_problem.init()
        self.local_problem.reinitialize(handdown=handdown)
        self.cnt_windows += 1

    def _segment_done(self):
        seg0 = self.segments_all[self.window_start]
        pos = self.tool.prediction["state"][:3]
        return np.linalg.norm(np.asarray(pos) - np.asarray(seg0["end"])) \
            < max(self.tool.tolerance, 1e-3)

    # -- lifecycle ---------------------------------------------------------
    def initialize(self, current_time):
        self.start_time = current_time
        self.local_problem.initialize(current_time)

    def reinitialize(self, father=None):
        self.local_problem.reinitialize()

    def predict(self, *args, **kwargs):
        self.local_problem.predict(*args, **kwargs)

    def _handdown_guess(self):
        """Window roll: segment k+1 of the solved problem becomes the
        segment-k guess of the next window (the analog of omgtools'
        combined-segment re-projection, gcodeschedulerproblem.py:985)."""
        problem = self.local_problem
        times = problem.segment_times()
        out = []
        for k in range(1, problem.n_segments):
            coeffs = problem.get_variables(self.tool, f"splines_seg{k}")
            out.append((np.asarray(coeffs), times[k]))
        return out or None

    def solve(self, current_time, update_time):
        if self._segment_done() and \
                self.window_start + self.n_segments < len(self.segments_all):
            handdown = self._handdown_guess()
            self.window_start += 1
            self._make_window_problem(handdown=handdown)
            self.local_problem.initialize(current_time)
        self.local_problem.solve(current_time, update_time)
        self.solver_stats = self.local_problem.solver_stats
        self.update_times = self.local_problem.update_times
        self.iteration = self.local_problem.iteration

    def store(self, *args):
        self.local_problem.store(*args)

    def simulate(self, *args):
        self.local_problem.simulate(*args)

    def stop_criterium(self, current_time, update_time):
        last = self.window_start + self.n_segments >= len(self.segments_all)
        return last and self.local_problem.stop_criterium(current_time,
                                                          update_time)

    def compute_objective(self):
        return self.local_problem.compute_objective()

    def final(self):
        if self.options["verbose"] >= 1:
            print("\nMachining done! windows:", self.cnt_windows)

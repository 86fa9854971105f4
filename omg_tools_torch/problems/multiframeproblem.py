"""Multi-frame motion problem: one spline segment per room/frame with free
per-segment motion times (counterpart of
``omg_tools_tpu.problems.multiframeproblem``, after omgtools
problems/multiframeproblem.py): objective sum(T_k) + jerk regularization,
initial constraints on segment 0, terminal constraints on the last segment,
C^(degree-1) continuity at the joints with time scaling
s1^(d)(1) T_{j+1}^d = s2^(d)(0) T_j^d, per-update shift of the first
segment only, subgoal-based initial guesses at the room-overlap centers.
"""

from __future__ import annotations

import numpy as np

from .problem import Problem
from ..modeling.opti import BIG
from ..ops.spline import evalspline, definite_integral
from ..utils.geometry import overlap_region

__all__ = ["MultiFrameProblem"]


class MultiFrameProblem(Problem):

    def __init__(self, fleet, environment, n_frames, options=None):
        Problem.__init__(self, fleet, environment, options,
                         label="multiframeproblem")
        self.n_frames = n_frames
        if self.n_frames > len(self.environment.room):
            raise RuntimeError("more frames than rooms provided")
        self.init_time = None
        self.start_time = 0.0
        self.objective = 0.0

    def set_default_options(self):
        Problem.set_default_options(self)
        self.options["inter_vehicle_avoidance"] = False
        self.options["no_term_con_der"] = False
        self.options["horizon_time"] = 10.0

    # -- modeling ----------------------------------------------------------
    def construct(self):
        self.t = self.define_parameter("t")[0]
        self.motion_times = [
            self.define_variable(f"T{frame}", value=10.0)[0]
            for frame in range(self.n_frames)]
        for child in self.children:
            child.problem_t = self.t
            child.problem_T = self.motion_times[0]
        for T in self.motion_times:
            self.define_constraint(-T, -BIG, 0.0)
        Problem.construct(self)
        for vehicle in self.vehicles:
            vehicle.init()
            total_splines = vehicle.define_splines(n_seg=self.n_frames)
            for frame in range(self.n_frames):
                vehicle.define_trajectory_constraints(
                    total_splines[frame], self.motion_times[frame])
            self.environment.define_collision_constraints(
                vehicle, total_splines, list(self.motion_times))
        if len(self.vehicles) > 1 and self.options["inter_vehicle_avoidance"]:
            self.environment.define_intervehicle_collision_constraints(
                self.vehicles, list(self.motion_times))
        self.define_init_constraints()
        self.define_terminal_constraints()
        self.define_connection_constraints()
        obj = sum(self.motion_times)
        if self.n_frames > 1:
            # jerk regularization against nervous multi-segment solutions
            for vehicle in self.vehicles:
                for frame in range(self.n_frames):
                    for s in vehicle.splines[frame]:
                        dds = s.derivative(3)
                        obj = obj + definite_integral(
                            (0.01 * dds) * (0.01 * dds), 0.0, 1.0)
        self.define_objective(obj)

    def define_init_constraints(self):
        for vehicle in self.vehicles:
            init_con = vehicle.get_initial_constraints(
                vehicle.splines[0], self.motion_times[0])
            for spline, condition in init_con:
                self.define_constraint(
                    evalspline(spline, self.t / self.motion_times[0])
                    - condition, 0.0, 0.0)

    def define_terminal_constraints(self):
        for vehicle in self.vehicles:
            term_con, term_con_der = vehicle.get_terminal_constraints(
                vehicle.splines[-1], horizon_time=self.motion_times[-1])
            if self.options.get("no_term_con_der", False):
                term_con_der = []
            for spline, condition in term_con + term_con_der:
                self.define_constraint(
                    evalspline(spline, np.asarray(1.0)) - condition, 0.0, 0.0)

    def define_connection_constraints(self):
        """C^(degree-1) continuity at segment joints with time scaling
        (omgtools multiframeproblem.py:113-124)."""
        for j in range(self.n_frames - 1):
            for vehicle in self.vehicles:
                for s1, s2 in zip(vehicle.splines[j], vehicle.splines[j + 1]):
                    for d in range(s1.basis.degree):
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

    # -- deployment --------------------------------------------------------
    def reinitialize(self, father=None):
        for vehicle in self.vehicles:
            subgoals = []
            for k in range(self.n_frames - 1):
                room1 = self.environment.room[k]
                room2 = self.environment.room[k + 1]
                ov = overlap_region(
                    room1["position"][:2], room1["shape"].width,
                    room1["shape"].height,
                    room2["position"][:2], room2["shape"].width,
                    room2["shape"].height)
                subgoals.append(ov[0] if ov is not None else
                                0.5 * (np.asarray(room1["position"][:2])
                                       + np.asarray(room2["position"][:2])))
            init = vehicle.get_init_spline_value(subgoals=subgoals) \
                if self.n_frames > 1 else vehicle.get_init_spline_value()
            tr = self.transcription
            for k in range(self.n_frames):
                sl, shape = tr.var_slice(vehicle, f"splines_seg{k}")
                self._x_result[sl] = np.asarray(init[k]).reshape(-1)
        self._ip_state = None

    def segment_times(self):
        return [float(self.get_variables(self, f"T{k}")[0])
                for k in range(self.n_frames)]

    def store(self, current_time, update_time, sample_time):
        segment_times = self.segment_times()
        horizon_time = sum(segment_times)
        rel_current_time = 0.0 if self.init_time is None else self.init_time
        if horizon_time < sample_time:
            return
        for vehicle in self.vehicles:
            n_samp = int(round(
                (horizon_time - rel_current_time) / sample_time, 6)) + 1
            time_axis = np.linspace(
                rel_current_time,
                rel_current_time + (n_samp - 1) * sample_time, n_samp)
            segments = [self.get_variables(vehicle, f"splines_seg{k}")
                        for k in range(vehicle.n_seg)]
            vehicle.store(current_time, sample_time, segments, segment_times,
                          time_axis)

    def init_step(self, current_time, update_time):
        if (current_time - self.start_time) > 0:
            T = sum(self.segment_times())
            if T < 2 * update_time:
                update_time = T - update_time
                target_time = T
            else:
                target_time = T - update_time
            M = self.transcription.spline_shift_matrix(
                lambda basis: basis.shift_spline_T(update_time / target_time),
                block_filter=lambda blk: "seg0" in blk.name)
            self.transform_primal_splines(M)
            T0 = float(self.get_variables(self, "T0")[0])
            self.set_variables(np.array([T0 - update_time]), self, "T0")

    def simulate(self, current_time, simulation_time, sample_time):
        horizon_time = sum(self.segment_times())
        rel_current_time = 0.0 if self.init_time is None else self.init_time
        if horizon_time < sample_time:
            return
        simulation_time = min(simulation_time, horizon_time,
                              horizon_time - rel_current_time)
        self.objective = current_time + simulation_time - self.start_time
        Problem.simulate(self, current_time, simulation_time, sample_time)

    def stop_criterium(self, current_time, update_time):
        if sum(self.segment_times()) < update_time:
            return True
        return all(v.check_terminal_conditions() for v in self.vehicles)

    def initialize(self, current_time):
        self.start_time = current_time

    def set_init_time(self, time):
        self.init_time = time

    def reset_init_time(self):
        self.init_time = None

    def compute_objective(self):
        return self.objective

    def final(self):
        self.reset_init_time()
        if self.options["verbose"] >= 1:
            print("\nWe reached our target!")
            print("%-18s %6g" % ("Objective:", self.compute_objective()))
            if self.update_times:
                print("%-18s %6g ms" % ("Max update time:",
                                        max(self.update_times) * 1000.0))
                print("%-18s %6g ms" % (
                    "Av update time:",
                    sum(self.update_times) * 1000.0 / len(self.update_times)))

"""Point-to-point motion problems (counterpart of
``omg_tools_tpu.problems.point2point``), with the closed loop's host
methods (trajectory storage, plant simulation, objective bookkeeping):

- FixedTPoint2point: horizon_time parameter, soft-L1 terminal constraint
  via slack splines g_k with objective integral(g, t0, 1), hard terminal
  derivative constraints at tau = 1, warm-start shift over knot passage;
- FreeTPoint2point: the motion time T is a decision variable with
  objective T, hard terminal constraints, and every update re-bases the
  splines on the remaining piece of the motion (``Basis.shift_spline_T``);
- FreeEndPoint2point: a subset of the terminal conditions become
  variables conT (the base of rendezvous problems).
"""

from __future__ import annotations

import numpy as np

from .problem import Problem
from ..modeling.opti import BIG
from ..ops.spline import BSpline, evalspline, definite_integral

__all__ = ["Point2point", "Point2pointProblem", "FixedTPoint2point",
           "FreeTPoint2point", "FreeEndPoint2point"]


class Point2point:
    """Factory selecting the fixed-T or the free-T problem."""

    def __new__(cls, fleet, environment, options=None, freeT=False):
        if freeT:
            return FreeTPoint2point(fleet, environment, options)
        return FixedTPoint2point(fleet, environment, options)


class Point2pointProblem(Problem):

    def __init__(self, fleet, environment, options):
        Problem.__init__(self, fleet, environment, options, label="p2p")
        self.init_time = None
        self.start_time = 0.0

    def set_default_options(self):
        Problem.set_default_options(self)
        self.options["inter_vehicle_avoidance"] = False

    def construct(self):
        self.T = self.define_parameter("T", value=self.horizon_value())[0]
        self.t = self.define_parameter("t")[0]
        self.t0 = self.t / self.T
        for child in self.children:
            child.problem_t = self.t
            child.problem_T = self.T
        Problem.construct(self)
        for vehicle in self.vehicles:
            vehicle.init()
            splines = vehicle.define_splines(n_seg=1)
            vehicle.define_trajectory_constraints(splines[0], self.T)
            self.environment.define_collision_constraints(vehicle, splines,
                                                          self.T)
        if len(self.vehicles) > 1 and self.options["inter_vehicle_avoidance"]:
            self.environment.define_intervehicle_collision_constraints(
                self.vehicles, self.T)

    def define_init_constraints(self):
        for vehicle in self.vehicles:
            init_con = vehicle.get_initial_constraints(vehicle.splines[0],
                                                       self.T)
            for spline, condition in init_con:
                self.define_constraint(
                    evalspline(spline, self.t0) - condition, 0.0, 0.0)

    def horizon_value(self):
        return 10.0

    # -- lifecycle ---------------------------------------------------------
    def initialize(self, current_time):
        self.start_time = current_time

    def set_init_time(self, time):
        self.init_time = time

    def reset_init_time(self):
        self.init_time = None

    def stop_criterium(self, current_time, update_time):
        return all(v.check_terminal_conditions() for v in self.vehicles)

    def final(self):
        self.reset_init_time()
        obj = self.compute_objective()
        if self.options["verbose"] >= 1:
            print("\nWe reached our target!")
            print("%-18s %6g" % ("Objective:", obj))
            if self.update_times:
                print("%-18s %6g ms" % ("Max update time:",
                                        max(self.update_times) * 1000.0))
                print("%-18s %6g ms" % (
                    "Av update time:",
                    sum(self.update_times) * 1000.0 / len(self.update_times)))

    def export(self, options=None):
        """The embedded C++ runtime's exporter of this problem: call its
        ``run()`` to write it (float64, on the CPU)."""
        from ..export.export_p2p import ExportP2P
        if not hasattr(self, "father"):
            self.init()
        return ExportP2P(self, options or {})


class FixedTPoint2point(Point2pointProblem):

    def __init__(self, fleet, environment, options):
        Point2pointProblem.__init__(self, fleet, environment, options)
        self.objective = 0.0
        if self.vehicles[0].knot_intervals is None:
            raise ValueError("fixed-T problems need constant knot intervals")
        self.knot_time = (int(self.options["horizon_time"] * 1000.0)
                          / self.vehicles[0].knot_intervals) / 1000.0

    def set_default_options(self):
        Point2pointProblem.set_default_options(self)
        self.options["horizon_time"] = 10.0
        self.options["hard_term_con"] = False
        self.options["no_term_con_der"] = False

    def horizon_value(self):
        return self.options["horizon_time"]

    def construct(self):
        Point2pointProblem.construct(self)
        self.define_init_constraints()
        self.define_terminal_constraints()

    def define_terminal_constraints(self):
        """Soft-L1 terminal targets: for each target spline s with goal y*,
        a slack spline g bounds |s - y*| coefficient-wise and its integral
        over the remaining horizon is the cost.  Terminal derivative targets
        are hard equalities at the horizon end."""
        slack_cost = 0.0
        self.term_con_len = []
        self._term_g_bases = []
        for vehicle in self.vehicles:
            targets, der_targets = vehicle.get_terminal_constraints(
                vehicle.splines[0])
            if self.options["no_term_con_der"]:
                der_targets = []
            self.term_con_len.append(len(targets))
            self._term_g_bases.append([s.basis for s, _ in targets])
            for k, (s, goal) in enumerate(targets):
                g = self.define_spline_variable(f"g{k}", 1, basis=s.basis)[0]
                slack_cost = slack_cost + definite_integral(g, self.t0, 1.0)
                self.define_constraint(s - goal - g, -BIG, 0.0)
                self.define_constraint(goal - s - g, -BIG, 0.0)
                if self.options["hard_term_con"]:
                    self.define_constraint(s(np.array(1.0)) - goal, 0.0, 0.0)
            for s, goal in der_targets:
                self.define_constraint(
                    evalspline(s, np.asarray(1.0)) - goal, 0.0, 0.0)
        self.define_objective(slack_cost)

    def set_parameters(self, current_time):
        parameters = {self: {}}
        if self.init_time is None:
            parameters[self]["t"] = np.round(current_time, 6) % self.knot_time
        else:
            parameters[self]["t"] = self.init_time
        parameters[self]["T"] = self.options["horizon_time"]
        return parameters

    def time_parameter(self, current_time):
        if self.init_time is None:
            return float(np.round(current_time, 6) % self.knot_time)
        return float(self.init_time)

    # -- warm-start shift over knot passage -------------------------------
    def _knot_index(self, t):
        return int(np.round(t / self.knot_time, 6))

    def init_step(self, current_time, update_time):
        if not hasattr(self, "current_time_prev"):
            self.current_time_prev = 0.0
        # entering a new knot interval: re-express the warm start in the
        # one-knot-advanced basis so the previous solution seeds the new
        # horizon (shiftoverknot transform, precomputed per basis)
        if self._knot_index(current_time) \
                > self._knot_index(self.current_time_prev):
            self.transform_primal_splines(self._primal_transform)
        self.current_time_prev = current_time

    def init_primal_transform(self, basis):
        return basis.shiftoverknot_T()

    def initialize(self, current_time):
        Point2pointProblem.initialize(self, current_time)
        self.current_time_prev = current_time

    # -- deployment --------------------------------------------------------
    def store(self, current_time, update_time, sample_time):
        horizon_time = self.options["horizon_time"]
        if self.init_time is None:
            rel_current_time = np.round(current_time - self.start_time, 6) \
                % self.knot_time
        else:
            rel_current_time = self.init_time
        for vehicle in self.vehicles:
            n_samp = int(round(
                (horizon_time - rel_current_time) / sample_time, 6)) + 1
            time_axis = np.linspace(
                rel_current_time,
                rel_current_time + (n_samp - 1) * sample_time, n_samp)
            segments = [self.get_variables(vehicle, f"splines_seg{k}")
                        for k in range(vehicle.n_seg)]
            vehicle.store(current_time, sample_time, segments, horizon_time,
                          time_axis)

    def simulate(self, current_time, simulation_time, sample_time):
        horizon_time = self.options["horizon_time"]
        if self.init_time is None:
            rel_current_time = np.round(current_time - self.start_time, 6) \
                % self.knot_time
        else:
            rel_current_time = self.init_time
        if horizon_time - rel_current_time < simulation_time:
            simulation_time = horizon_time - rel_current_time
        self.compute_partial_objective(current_time, simulation_time)
        Problem.simulate(self, current_time, simulation_time, sample_time)

    def compute_partial_objective(self, current_time, update_time):
        rel_current_time = np.round(current_time - self.start_time, 6) \
            % self.knot_time
        horizon_time = self.options["horizon_time"]
        t0 = rel_current_time / horizon_time
        t1 = t0 + update_time / horizon_time
        part = 0.0
        for v, vehicle in enumerate(self.vehicles):
            for k in range(self.term_con_len[v]):
                g_cfs = self.get_variables(self, f"g{k}")[:, 0]
                g = BSpline(self._term_g_bases[v][k], g_cfs)
                part += horizon_time * float(definite_integral(
                    g, float(t0), float(t1)))
        self.objective += part

    def compute_objective(self):
        if self.objective == 0.0:
            obj = 0.0
            for v, vehicle in enumerate(self.vehicles):
                for k in range(self.term_con_len[v]):
                    g_cfs = self.get_variables(self, f"g{k}")[:, 0]
                    g = BSpline(self._term_g_bases[v][k], g_cfs)
                    obj += self.options["horizon_time"] * float(g.integral())
            return obj
        return self.objective


class FreeTPoint2point(Point2pointProblem):

    def __init__(self, fleet, environment, options):
        Point2pointProblem.__init__(self, fleet, environment, options)
        self.objective = 0.0

    def construct(self):
        # T is a variable; the other children still see it as problem_T
        self.T = self.define_variable("T", value=self.horizon_value())[0]
        self.t = self.define_parameter("t")[0]
        self.t0 = self.t / self.T
        for child in self.children:
            child.problem_t = self.t
            child.problem_T = self.T
        Problem.construct(self)
        for vehicle in self.vehicles:
            vehicle.init()
            splines = vehicle.define_splines(n_seg=1)
            vehicle.define_trajectory_constraints(splines[0], self.T)
            self.environment.define_collision_constraints(vehicle, splines,
                                                          self.T)
        if len(self.vehicles) > 1 and self.options["inter_vehicle_avoidance"]:
            self.environment.define_intervehicle_collision_constraints(
                self.vehicles, self.T)
        self.define_objective(self.T)
        self.define_constraint(-self.T, -BIG, 0.0)
        self.define_init_constraints()
        self.define_terminal_constraints()

    def define_terminal_constraints(self):
        for vehicle in self.vehicles:
            term_con, term_con_der = vehicle.get_terminal_constraints(
                vehicle.splines[0])
            if self.options.get("no_term_con_der", False):
                term_con_der = []
            for spline, condition in term_con + term_con_der:
                self.define_constraint(
                    evalspline(spline, np.asarray(1.0)) - condition,
                    0.0, 0.0)

    def set_parameters(self, current_time):
        parameters = {self: {}}
        parameters[self]["t"] = 0.0 if self.init_time is None \
            else self.init_time
        return parameters

    def time_parameter(self, current_time):
        return 0.0 if self.init_time is None else float(self.init_time)

    def init_step(self, current_time, update_time):
        if (current_time - self.start_time) > 0:
            T = float(self.get_variables(self, "T")[0])
            if T < 2 * update_time:
                update_time = T - update_time
                target_time = T
            else:
                target_time = T - update_time
            # re-express the remaining spline piece in a fresh equidistant
            # basis, and the motion time as what is left of it
            M = self.transcription.spline_shift_matrix(
                lambda basis: basis.shift_spline_T(update_time / target_time))
            self.transform_primal_splines(M)
            self.set_variables(np.array([target_time]), self, "T")

    def store(self, current_time, update_time, sample_time):
        horizon_time = float(self.get_variables(self, "T")[0])
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
            vehicle.store(current_time, sample_time, segments, horizon_time,
                          time_axis)

    def simulate(self, current_time, simulation_time, sample_time):
        horizon_time = float(self.get_variables(self, "T")[0])
        rel_current_time = 0.0 if self.init_time is None else self.init_time
        if horizon_time < sample_time:
            return
        simulation_time = min(simulation_time, horizon_time,
                              horizon_time - rel_current_time)
        self.compute_partial_objective(
            current_time + simulation_time - self.start_time)
        Problem.simulate(self, current_time, simulation_time, sample_time)

    def stop_criterium(self, current_time, update_time):
        if float(self.get_variables(self, "T")[0]) < update_time:
            return True
        return Point2pointProblem.stop_criterium(self, current_time,
                                                 update_time)

    def compute_partial_objective(self, current_time):
        self.objective = current_time

    def compute_objective(self):
        return self.objective


class FreeEndPoint2point(FixedTPoint2point):
    """A fixed-T problem whose terminal conditions ``free_ind`` (per
    vehicle; all of them by default) are variables conT{l}, reached in the
    soft-L1 sense."""

    def __init__(self, fleet, environment, options, free_ind=None):
        FixedTPoint2point.__init__(self, fleet, environment, options)
        self.free_ind = free_ind

    def construct(self):
        if self.free_ind is None:
            # every terminal condition free, counted when they are made
            self.free_ind = {vehicle: None for vehicle in self.vehicles}
        FixedTPoint2point.construct(self)

    def define_terminal_constraints(self):
        objective = 0.0
        self.term_con_len = []
        self._term_g_bases = []
        for l, vehicle in enumerate(self.vehicles):
            term_con, term_con_der = vehicle.get_terminal_constraints(
                vehicle.splines[0])
            if self.free_ind.get(vehicle) is None:
                self.free_ind[vehicle] = list(range(len(term_con)))
            free = self.free_ind[vehicle]
            conditions = self.define_variable(f"conT{l}", len(free))
            cnt = 0
            self.term_con_len.append(len(term_con))
            self._term_g_bases.append([c[0].basis for c in term_con])
            for k, (spline, condition) in enumerate(term_con):
                if k in free:
                    condition = conditions[cnt]
                    cnt += 1
                g = self.define_spline_variable(
                    f"g{k}", 1, basis=spline.basis)[0]
                objective = objective + definite_integral(g, self.t0, 1.0)
                self.define_constraint(spline - condition - g, -BIG, 0.0)
                self.define_constraint(-spline + condition - g, -BIG, 0.0)
            for spline, condition in term_con_der:
                self.define_constraint(
                    evalspline(spline, np.asarray(1.0)) - condition,
                    0.0, 0.0)
        self.define_objective(objective)

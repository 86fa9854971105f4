"""Holonomic vehicle with orientation via tangent-half-angle spline
(counterpart of ``omg_tools_tpu.models.holonomicorient``; omgtools
vehicles/holonomicorient.py): splines x, y, tg_ha = tan(theta/2);
rotation-rate bounds as polynomial constraints in tg_ha; optional L1/L2
regularization on dtg_ha."""

from __future__ import annotations

import numpy as np

from .base import Vehicle
from ..environment.shapes import Rectangle
from ..modeling.opti import BIG
from ..ops.spline import definite_integral, sample_spline

__all__ = ["HolonomicOrient"]


class HolonomicOrient(Vehicle):

    def __init__(self, shapes=None, options=None, bounds=None):
        bounds = bounds or {}
        Vehicle.__init__(
            self, n_spl=3, degree=3,
            shapes=shapes if shapes is not None
            else Rectangle(width=0.2, height=0.4),
            options=options)
        self.vmin = bounds.get("vmin", -0.5)
        self.vmax = bounds.get("vmax", 0.5)
        self.amin = bounds.get("amin", -1.0)
        self.amax = bounds.get("amax", 1.0)
        self.wmin = bounds.get("wmin", -np.pi / 6.0)
        self.wmax = bounds.get("wmax", np.pi / 6.0)

    def set_default_options(self):
        Vehicle.set_default_options(self)
        self.options["syslimit"] = "norm_inf"
        self.options["reg_type"] = None
        self.options["reg_weight"] = 0.0

    def define_trajectory_constraints(self, splines, horizon_time):
        x, y, tg_ha = splines
        dx, dy, dtg_ha = x.derivative(), y.derivative(), tg_ha.derivative()
        ddx, ddy = x.derivative(2), y.derivative(2)
        T = horizon_time
        if self.options["syslimit"] == "norm_2":
            self.define_constraint(dx * dx + dy * dy
                                   - (T ** 2) * self.vmax ** 2, -BIG, 0.0)
            self.define_constraint(ddx * ddx + ddy * ddy
                                   - (T ** 4) * self.amax ** 2, -BIG, 0.0)
        else:
            self.define_constraint(-dx + T * self.vmin, -BIG, 0.0)
            self.define_constraint(-dy + T * self.vmin, -BIG, 0.0)
            self.define_constraint(dx - T * self.vmax, -BIG, 0.0)
            self.define_constraint(dy - T * self.vmax, -BIG, 0.0)
            self.define_constraint(-ddx + (T ** 2) * self.amin, -BIG, 0.0)
            self.define_constraint(-ddy + (T ** 2) * self.amin, -BIG, 0.0)
            self.define_constraint(ddx - (T ** 2) * self.amax, -BIG, 0.0)
            self.define_constraint(ddy - (T ** 2) * self.amax, -BIG, 0.0)
        # rotation-rate bounds: dtheta = 2 dtg_ha / (1 + tg_ha^2)
        self.define_constraint(2 * dtg_ha - (1 + tg_ha ** 2) * T * self.wmax,
                               -BIG, 0.0)
        self.define_constraint(-2 * dtg_ha + (1 + tg_ha ** 2) * T * self.wmin,
                               -BIG, 0.0)
        if self.options["reg_type"] == "norm_1" and \
                self.options["reg_weight"] != 0.0:
            g_reg = self.define_spline_variable(
                "g_reg", 1, basis=dtg_ha.basis)[0]
            obj = definite_integral(g_reg, self.problem_t / T, 1.0)
            self.define_constraint(dtg_ha - g_reg, -BIG, 0.0)
            self.define_constraint(-dtg_ha - g_reg, -BIG, 0.0)
            self.define_objective(self.options["reg_weight"] * obj)
        elif self.options["reg_type"] == "norm_2" and \
                self.options["reg_weight"] != 0.0:
            obj = definite_integral(dtg_ha * dtg_ha, self.problem_t / T, 1.0)
            self.define_objective(self.options["reg_weight"] * obj)

    def get_initial_constraints(self, splines, horizon_time):
        pos0 = self.define_parameter("pos0", 2)
        tg_ha0 = self.define_parameter("tg_ha0", 1)
        vel0 = self.define_parameter("vel0", 2)
        dtg_ha0 = self.define_parameter("dtg_ha0", 1)
        x, y, tg_ha = splines
        T = horizon_time
        return [(x, pos0[0]), (y, pos0[1]), (tg_ha, tg_ha0[0]),
                (x.derivative(), T * vel0[0]), (y.derivative(), T * vel0[1]),
                (tg_ha.derivative(), T * dtg_ha0[0])]

    def get_terminal_constraints(self, splines, horizon_time=None):
        posT = self.define_parameter("posT", 2)
        tg_haT = self.define_parameter("tg_haT", 1)
        x, y, tg_ha = splines
        term_con = [(x, posT[0]), (y, posT[1]), (tg_ha, tg_haT[0])]
        term_con_der = []
        for d in range(1, self.degree + 1):
            term_con_der.extend([(x.derivative(d), 0.0),
                                 (y.derivative(d), 0.0),
                                 (tg_ha.derivative(d), 0.0)])
        return [term_con, term_con_der]

    def set_initial_conditions(self, state, input=None):
        input = np.zeros(3) if input is None else np.asarray(input)
        self.prediction["state"] = np.asarray(state, dtype=np.float64)
        self.prediction["input"] = np.asarray(input, dtype=np.float64)

    def set_terminal_conditions(self, pose):
        self.poseT = np.asarray(pose, dtype=np.float64)

    def get_init_spline_value(self):
        n = len(self.basis)
        pos0 = self.prediction["state"]
        init = np.zeros((n, 3))
        init[:, 0] = np.linspace(pos0[0], self.poseT[0], n)
        init[:, 1] = np.linspace(pos0[1], self.poseT[1], n)
        init[:, 2] = np.linspace(np.tan(pos0[2] / 2.0),
                                 np.tan(self.poseT[2] / 2.0), n)
        return [init]

    def check_terminal_conditions(self):
        tol = self.options["stop_tol"]
        return (np.linalg.norm(self.signals["state"][:2, -1] - self.poseT[:2])
                <= tol and
                np.linalg.norm(self.signals["input"][:, -1]) <= tol)

    def set_parameters(self, current_time):
        parameters = Vehicle.set_parameters(self, current_time)
        st = self.prediction["state"]
        inp = self.prediction["input"]
        tg_ha0 = np.tan(st[2] / 2.0)
        parameters[self]["pos0"] = st[:2]
        parameters[self]["tg_ha0"] = [tg_ha0]
        parameters[self]["vel0"] = inp[:2]
        parameters[self]["dtg_ha0"] = [0.5 * inp[2] * (1 + tg_ha0 ** 2)]
        parameters[self]["posT"] = self.poseT[:2]
        parameters[self]["tg_haT"] = [np.tan(self.poseT[2] / 2.0)]
        return parameters

    def define_collision_constraints(self, hyperplanes, room, splines,
                                     horizon_time):
        x, y, tg_ha = splines
        self.define_collision_constraints_2d(hyperplanes, room, [x, y],
                                             horizon_time, tg_ha=tg_ha)

    def splines2signals(self, splines, time):
        x, y, tg_ha = splines
        dx, dy, dtg_ha = x.derivative(), y.derivative(), tg_ha.derivative()
        x_s = sample_spline(x, time)
        y_s = sample_spline(y, time)
        tg_s = sample_spline(tg_ha, time)
        dtg_s = sample_spline(dtg_ha, time)
        theta = 2 * np.arctan2(tg_s, 1.0)
        dtheta = 2 * dtg_s / (1 + tg_s ** 2)
        return {
            "state": np.vstack([x_s, y_s, theta]),
            "input": np.vstack([sample_spline(dx, time),
                                sample_spline(dy, time), dtheta]),
        }

    def state2pose(self, state):
        return np.asarray(state)

    def ode(self, state, input):
        return np.asarray(input, dtype=np.float64)

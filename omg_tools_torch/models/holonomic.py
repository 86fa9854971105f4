"""Holonomic (2D double-integrator) vehicle (counterpart of
``omg_tools_tpu.models.holonomic``).

Decision splines: x, y (degree 3).  Velocity/acceleration limits either
per-axis (norm_inf) or quadratic (norm_2), imposed on derivative-spline
coefficients scaled by the horizon time.
"""

from __future__ import annotations

import numpy as np

from .base import Vehicle
from ..environment.shapes import Circle
from ..modeling.opti import BIG
from ..ops.spline import sample_spline

__all__ = ["Holonomic"]


class Holonomic(Vehicle):

    def __init__(self, shapes=None, options=None, bounds=None):
        bounds = bounds or {}
        Vehicle.__init__(self, n_spl=2, degree=3,
                         shapes=shapes if shapes is not None else Circle(0.1),
                         options=options)
        if self.options["syslimit"] == "norm_inf":
            self.vxmin = bounds.get("vxmin", bounds.get("vmin", -0.5))
            self.vymin = bounds.get("vymin", bounds.get("vmin", -0.5))
            self.vxmax = bounds.get("vxmax", bounds.get("vmax", 0.5))
            self.vymax = bounds.get("vymax", bounds.get("vmax", 0.5))
            self.axmin = bounds.get("axmin", bounds.get("amin", -1.0))
            self.aymin = bounds.get("aymin", bounds.get("amin", -1.0))
            self.axmax = bounds.get("axmax", bounds.get("amax", 1.0))
            self.aymax = bounds.get("aymax", bounds.get("amax", 1.0))
        elif self.options["syslimit"] == "norm_2":
            self.vmax = bounds.get("vmax", 0.5)
            self.amax = bounds.get("amax", 1.0)
        else:
            raise ValueError("syslimit must be norm_inf or norm_2")

    def set_default_options(self):
        Vehicle.set_default_options(self)
        self.options["syslimit"] = "norm_inf"

    # -- constraint hooks --------------------------------------------------
    def define_trajectory_constraints(self, splines, horizon_time):
        x, y = splines
        dx, dy = x.derivative(), y.derivative()
        ddx, ddy = x.derivative(2), y.derivative(2)
        T = horizon_time
        if self.options["syslimit"] == "norm_2":
            self.define_constraint(dx * dx + dy * dy - (T ** 2) * self.vmax ** 2,
                                   -BIG, 0.0)
            self.define_constraint(
                ddx * ddx + ddy * ddy - (T ** 4) * self.amax ** 2, -BIG, 0.0)
        else:
            self.define_constraint(-dx + T * self.vxmin, -BIG, 0.0)
            self.define_constraint(-dy + T * self.vymin, -BIG, 0.0)
            self.define_constraint(dx - T * self.vxmax, -BIG, 0.0)
            self.define_constraint(dy - T * self.vymax, -BIG, 0.0)
            self.define_constraint(-ddx + (T ** 2) * self.axmin, -BIG, 0.0)
            self.define_constraint(-ddy + (T ** 2) * self.aymin, -BIG, 0.0)
            self.define_constraint(ddx - (T ** 2) * self.axmax, -BIG, 0.0)
            self.define_constraint(ddy - (T ** 2) * self.aymax, -BIG, 0.0)

    def get_initial_constraints(self, splines, horizon_time):
        state0 = self.define_parameter("state0", 2)
        input0 = self.define_parameter("input0", 2)
        x, y = splines
        dx, dy = x.derivative(), y.derivative()
        return [(x, state0[0]), (y, state0[1]),
                (dx, horizon_time * input0[0]), (dy, horizon_time * input0[1])]

    def get_terminal_constraints(self, splines, horizon_time=None):
        position = self.define_parameter("poseT", 2)
        x, y = splines
        term_con = [(x, position[0]), (y, position[1])]
        term_con_der = []
        for d in range(1, self.degree + 1):
            term_con_der.extend([(x.derivative(d), 0.0),
                                 (y.derivative(d), 0.0)])
        return [term_con, term_con_der]

    def define_collision_constraints(self, hyperplanes, room, splines,
                                     horizon_time):
        x, y = splines[0], splines[1]
        self.define_collision_constraints_2d(hyperplanes, room, [x, y],
                                             horizon_time)

    # -- conditions --------------------------------------------------------
    def set_initial_conditions(self, state, input=None):
        input = np.zeros(2) if input is None else np.asarray(input)
        self.prediction["state"] = np.asarray(state, dtype=np.float64)
        self.prediction["input"] = np.asarray(input, dtype=np.float64)
        self.prediction["dinput"] = np.zeros(2)

    def set_terminal_conditions(self, position):
        self.poseT = np.asarray(position, dtype=np.float64)

    def get_init_spline_value(self, subgoals=None):
        pos0 = self.prediction["state"]
        posT = self.poseT
        n = len(self.basis)
        if getattr(self, "n_seg", 1) == 1:
            init = np.stack([np.linspace(pos0[k], posT[k], n)
                             for k in range(2)], axis=1)
            return [init]
        if subgoals is None:
            raise AttributeError("multi-segment initial guess needs subgoals")
        pts = [pos0] + list(subgoals) + [posT]
        return [np.stack([np.linspace(pts[l][k], pts[l + 1][k], n)
                          for k in range(2)], axis=1)
                for l in range(len(pts) - 1)]

    def check_terminal_conditions(self):
        tol = self.options["stop_tol"]
        return (np.linalg.norm(self.signals["state"][:, -1] - self.poseT)
                <= tol and
                np.linalg.norm(self.signals["input"][:, -1]) <= tol)

    def set_parameters(self, current_time):
        parameters = Vehicle.set_parameters(self, current_time)
        parameters[self]["state0"] = self.prediction["state"]
        parameters[self]["input0"] = self.prediction["input"]
        parameters[self]["poseT"] = self.poseT
        return parameters

    # -- signals -----------------------------------------------------------
    def splines2signals(self, splines, time):
        x, y = splines
        dx, dy = x.derivative(), y.derivative()
        ddx, ddy = x.derivative(2), y.derivative(2)
        state = np.vstack([sample_spline(s, time) for s in (x, y)])
        inp = np.vstack([sample_spline(s, time) for s in (dx, dy)])
        return {
            "state": state, "input": inp,
            "v_tot": np.sqrt(inp[0] ** 2 + inp[1] ** 2),
            "dinput": np.vstack([sample_spline(s, time) for s in (ddx, ddy)]),
        }

    def state2pose(self, state):
        return np.r_[np.asarray(state), 0.0]

    def ode(self, state, input):
        return np.asarray(input, dtype=np.float64)

"""Planar quadrotor (counterpart of ``omg_tools_tpu.models.quadrotor``;
omgtools vehicles/quadrotor.py): position splines x, y of degree 4; thrust
u1 and tilt rate u2 recovered from 2nd/3rd derivatives; input bounds as
polynomial constraints on derivative splines."""

from __future__ import annotations

import numpy as np

from .base import Vehicle
from ..environment.shapes import Circle
from ..modeling.opti import BIG
from ..ops.spline import sample_spline

__all__ = ["Quadrotor"]


class Quadrotor(Vehicle):

    def __init__(self, radius=0.2, options=None, bounds=None):
        bounds = bounds or {}
        Vehicle.__init__(self, n_spl=2, degree=4, shapes=Circle(radius),
                         options=options)
        self.radius = radius
        self.u1min = bounds.get("u1min", 2.0)
        self.u1max = bounds.get("u1max", 15.0)
        self.u2min = bounds.get("u2min", -8.0)
        self.u2max = bounds.get("u2max", 8.0)
        self.g = 9.81

    def set_default_options(self):
        Vehicle.set_default_options(self)
        self.options["stop_tol"] = 1.0e-2

    def define_trajectory_constraints(self, splines, horizon_time):
        x, y = splines
        ddx, ddy = x.derivative(2), y.derivative(2)
        dddx, dddy = x.derivative(3), y.derivative(3)
        T = horizon_time
        g_tf = self.g * (T ** 2)
        # thrust: u1^2 = ddx^2 + (ddy + g)^2 in [u1min^2, u1max^2]
        self.define_constraint(
            -(ddx * ddx + (ddy + g_tf) * (ddy + g_tf))
            + (T ** 4) * self.u1min ** 2, -BIG, 0.0)
        self.define_constraint(
            (ddx * ddx + (ddy + g_tf) * (ddy + g_tf))
            - (T ** 4) * self.u1max ** 2, -BIG, 0.0)
        # tilt rate: u2 = (dddx (ddy+g) - ddx dddy) / u1^2 in [u2min, u2max]
        self.define_constraint(
            -(dddx * (ddy + g_tf) - ddx * dddy)
            + (ddx * ddx + (ddy + g_tf) * (ddy + g_tf)) * (T * self.u2min),
            -BIG, 0.0)
        self.define_constraint(
            (dddx * (ddy + g_tf) - ddx * dddy)
            - (ddx * ddx + (ddy + g_tf) * (ddy + g_tf)) * (T * self.u2max),
            -BIG, 0.0)

    def get_initial_constraints(self, splines, horizon_time):
        spl0 = self.define_parameter("spl0", 2)
        dspl0 = self.define_parameter("dspl0", 2)
        ddspl0 = self.define_parameter("ddspl0", 2)
        x, y = splines
        T = horizon_time
        return [(x, spl0[0]), (y, spl0[1]),
                (x.derivative(), T * dspl0[0]), (y.derivative(), T * dspl0[1]),
                (x.derivative(2), (T ** 2) * ddspl0[0]),
                (y.derivative(2), (T ** 2) * ddspl0[1])]

    def get_terminal_constraints(self, splines, horizon_time=None):
        position = self.define_parameter("poseT", 2)
        x, y = splines
        term_con = [(x, position[0]), (y, position[1])]
        term_con_der = []
        for d in range(1, self.degree + 1):
            term_con_der.extend([(x.derivative(d), 0.0),
                                 (y.derivative(d), 0.0)])
        return [term_con, term_con_der]

    def set_initial_conditions(self, state, input=None):
        state = np.asarray(state, dtype=np.float64)
        self.prediction["state"] = np.r_[state[:2], np.zeros(3)]
        self.prediction["dspl"] = np.zeros(2)
        self.prediction["ddspl"] = np.zeros(2)

    def set_terminal_conditions(self, position):
        self.poseT = np.asarray(position, dtype=np.float64)

    def get_init_spline_value(self):
        n = len(self.basis)
        d = self.degree
        pos0 = self.prediction["state"][:2]
        init = np.zeros((n, 2))
        for k in range(2):
            init[:, k] = np.r_[pos0[k] * np.ones(d),
                               np.linspace(pos0[k], self.poseT[k], n - 2 * d),
                               self.poseT[k] * np.ones(d)]
        return [init]

    def check_terminal_conditions(self):
        tol = self.options["stop_tol"]
        return (np.linalg.norm(self.signals["pose"][:2, -1] - self.poseT)
                <= tol and
                np.linalg.norm(self.signals["dspl"][:, -1]) <= tol)

    def set_parameters(self, current_time):
        parameters = Vehicle.set_parameters(self, current_time)
        parameters[self]["spl0"] = self.prediction["state"][:2]
        parameters[self]["dspl0"] = self.prediction["dspl"]
        parameters[self]["ddspl0"] = self.prediction["ddspl"]
        parameters[self]["poseT"] = self.poseT
        return parameters

    def define_collision_constraints(self, hyperplanes, room, splines,
                                     horizon_time):
        x, y = splines[0], splines[1]
        self.define_collision_constraints_2d(hyperplanes, room, [x, y],
                                             horizon_time)

    def splines2signals(self, splines, time):
        x, y = splines
        x_s = sample_spline(x, time)
        y_s = sample_spline(y, time)
        dx_s = sample_spline(x.derivative(), time)
        dy_s = sample_spline(y.derivative(), time)
        ddx_s = sample_spline(x.derivative(2), time)
        ddy_s = sample_spline(y.derivative(2), time)
        dddx_s = sample_spline(x.derivative(3), time)
        dddy_s = sample_spline(y.derivative(3), time)
        theta = np.arctan2(ddx_s, ddy_s + self.g)
        u1 = np.sqrt(ddx_s ** 2 + (ddy_s + self.g) ** 2)
        u2 = (dddx_s * (ddy_s + self.g) - ddx_s * dddy_s) / \
            ((ddy_s + self.g) ** 2 + ddx_s ** 2)
        return {
            "state": np.vstack([x_s, y_s, dx_s, dy_s, theta]),
            "input": np.vstack([u1, u2]),
            "dspl": np.vstack([dx_s, dy_s]),
            "ddspl": np.vstack([ddx_s, ddy_s]),
        }

    def state2pose(self, state):
        return np.r_[state[0], state[1], -state[4]]

    def ode(self, state, input):
        theta = state[4]
        u1, u2 = input[0], input[1]
        return np.r_[state[2:4], u1 * np.sin(theta),
                     u1 * np.cos(theta) - self.g, u2]

"""1D holonomic vehicle (counterpart of
``omg_tools_tpu.models.holonomic1d``; omgtools vehicles/holonomic1d.py):
single position spline, velocity/acceleration bounds."""

from __future__ import annotations

import numpy as np

from .base import Vehicle
from ..environment.shapes import Rectangle
from ..modeling.opti import BIG
from ..ops.spline import sample_spline

__all__ = ["Holonomic1D"]


class Holonomic1D(Vehicle):

    def __init__(self, width=0.7, height=0.1, options=None, bounds=None):
        bounds = bounds or {}
        Vehicle.__init__(self, n_spl=1, degree=3,
                         shapes=Rectangle(width, height), options=options)
        self.vmin = bounds.get("vmin", -0.5)
        self.vmax = bounds.get("vmax", 0.5)
        self.amin = bounds.get("amin", -1.0)
        self.amax = bounds.get("amax", 1.0)

    def define_trajectory_constraints(self, splines, horizon_time):
        x = splines[0]
        dx, ddx = x.derivative(), x.derivative(2)
        T = horizon_time
        self.define_constraint(-dx + T * self.vmin, -BIG, 0.0)
        self.define_constraint(dx - T * self.vmax, -BIG, 0.0)
        self.define_constraint(-ddx + (T ** 2) * self.amin, -BIG, 0.0)
        self.define_constraint(ddx - (T ** 2) * self.amax, -BIG, 0.0)

    def get_initial_constraints(self, splines, horizon_time):
        state0 = self.define_parameter("state0", 1)
        input0 = self.define_parameter("input0", 1)
        x = splines[0]
        return [(x, state0[0]), (x.derivative(), horizon_time * input0[0])]

    def get_terminal_constraints(self, splines, horizon_time=None):
        position = self.define_parameter("poseT", 1)
        x = splines[0]
        term_con = [(x, position[0])]
        term_con_der = [(x.derivative(d), 0.0)
                        for d in range(1, self.degree + 1)]
        return [term_con, term_con_der]

    def set_initial_conditions(self, state, input=None):
        input = np.zeros(1) if input is None else np.atleast_1d(input)
        self.prediction["state"] = np.atleast_1d(np.asarray(state,
                                                            dtype=np.float64))
        self.prediction["input"] = np.asarray(input, dtype=np.float64)

    def set_terminal_conditions(self, position):
        self.poseT = np.atleast_1d(np.asarray(position, dtype=np.float64))

    def get_init_spline_value(self):
        n = len(self.basis)
        return [np.linspace(self.prediction["state"][0], self.poseT[0],
                            n)[:, None]]

    def check_terminal_conditions(self):
        tol = self.options["stop_tol"]
        return (abs(self.signals["state"][0, -1] - self.poseT[0]) <= tol
                and abs(self.signals["input"][0, -1]) <= tol)

    def set_parameters(self, current_time):
        parameters = Vehicle.set_parameters(self, current_time)
        parameters[self]["state0"] = self.prediction["state"]
        parameters[self]["input0"] = self.prediction["input"]
        parameters[self]["poseT"] = self.poseT
        return parameters

    def define_collision_constraints(self, hyperplanes, room, splines,
                                     horizon_time):
        # 1D: only room limits apply
        x = splines[0]
        lims = room["shape"].get_canvas_limits()
        lo = float(lims[0][0] + room["position"][0])
        hi = float(lims[0][1] + room["position"][0])
        half = 0.5 * self.shapes[0].width
        self.define_constraint(-x + lo + half, -BIG, 0.0)
        self.define_constraint(x - hi + half, -BIG, 0.0)

    def splines2signals(self, splines, time):
        x = splines[0]
        return {
            "state": np.atleast_2d(sample_spline(x, time)),
            "input": np.atleast_2d(sample_spline(x.derivative(), time)),
        }

    def state2pose(self, state):
        return np.r_[np.atleast_1d(state), 0.0, 0.0]

    def ode(self, state, input):
        return np.atleast_1d(np.asarray(input, dtype=np.float64))

"""3D holonomic vehicle (counterpart of
``omg_tools_tpu.models.holonomic3d``; omgtools vehicles/holonomic3d.py):
x, y, z integrator splines with per-axis bounds."""

from __future__ import annotations

import numpy as np

from .base import Vehicle
from ..environment.shapes import Sphere
from ..modeling.opti import BIG
from ..ops.spline import sample_spline

__all__ = ["Holonomic3D"]


class Holonomic3D(Vehicle):

    def __init__(self, shapes=None, options=None, bounds=None):
        bounds = bounds or {}
        Vehicle.__init__(self, n_spl=3, degree=3,
                         shapes=shapes if shapes is not None else Sphere(0.1),
                         options=options)
        self.vmin = bounds.get("vmin", -0.5)
        self.vmax = bounds.get("vmax", 0.5)
        self.amin = bounds.get("amin", -1.0)
        self.amax = bounds.get("amax", 1.0)

    def define_trajectory_constraints(self, splines, horizon_time):
        T = horizon_time
        for s in splines:
            ds, dds = s.derivative(), s.derivative(2)
            self.define_constraint(-ds + T * self.vmin, -BIG, 0.0)
            self.define_constraint(ds - T * self.vmax, -BIG, 0.0)
            self.define_constraint(-dds + (T ** 2) * self.amin, -BIG, 0.0)
            self.define_constraint(dds - (T ** 2) * self.amax, -BIG, 0.0)

    def get_initial_constraints(self, splines, horizon_time):
        state0 = self.define_parameter("state0", 3)
        input0 = self.define_parameter("input0", 3)
        con = []
        for k, s in enumerate(splines):
            con.append((s, state0[k]))
            con.append((s.derivative(), horizon_time * input0[k]))
        return con

    def get_terminal_constraints(self, splines, horizon_time=None):
        position = self.define_parameter("poseT", 3)
        term_con = [(s, position[k]) for k, s in enumerate(splines)]
        term_con_der = []
        for d in range(1, self.degree + 1):
            term_con_der.extend([(s.derivative(d), 0.0) for s in splines])
        return [term_con, term_con_der]

    def set_initial_conditions(self, state, input=None):
        input = np.zeros(3) if input is None else np.asarray(input)
        self.prediction["state"] = np.asarray(state, dtype=np.float64)
        self.prediction["input"] = np.asarray(input, dtype=np.float64)

    def set_terminal_conditions(self, position):
        self.poseT = np.asarray(position, dtype=np.float64)

    def get_init_spline_value(self):
        n = len(self.basis)
        pos0, posT = self.prediction["state"], self.poseT
        return [np.stack([np.linspace(pos0[k], posT[k], n)
                          for k in range(3)], axis=1)]

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

    def define_collision_constraints(self, hyperplanes, room, splines,
                                     horizon_time):
        self.define_collision_constraints_3d(hyperplanes, room, list(splines),
                                             horizon_time)

    def splines2signals(self, splines, time):
        state = np.vstack([sample_spline(s, time) for s in splines])
        inp = np.vstack([sample_spline(s.derivative(), time)
                         for s in splines])
        return {"state": state, "input": inp}

    def state2pose(self, state):
        return np.r_[np.asarray(state), 0.0, 0.0, 0.0]

    def ode(self, state, input):
        return np.asarray(input, dtype=np.float64)

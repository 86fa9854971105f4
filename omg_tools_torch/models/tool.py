"""CNC machining tool moving inside a G-code tolerance tube (counterpart
of ``omg_tools_tpu.models.tool``, after omgtools vehicles/tool.py).

Splines x, y, z of degree 3 with velocity ('machining' total-xy or
per-'axes'), acceleration and jerk bounds; collision = stay inside the
segment shape (rectangle tube for G00/G01, ring annulus for G02/G03) with
variable-tolerance support.  Used by the G-code problems only; it has no
batched rollout recipe (``problems.rollout_models`` raises for it).
"""

from __future__ import annotations

import numpy as np

from .base import Vehicle
from ..environment.shapes import Circle, Rectangle, Square, Ring
from ..modeling.opti import BIG
from ..ops.spline import sample_spline

__all__ = ["Tool"]


class Tool(Vehicle):

    def __init__(self, tolerance, options=None, bounds=None, **kwargs):
        self.tolerance = tolerance
        self.tolerance_small = kwargs.get("tol_small", 0.0)
        bounds = bounds or {}
        Vehicle.__init__(self, n_spl=3, degree=3, shapes=[Circle(0.0)],
                         options=options)
        b = bounds
        self.vxmin = b.get("vxmin", b.get("vmin", -0.5))
        self.vymin = b.get("vymin", b.get("vmin", -0.5))
        self.vzmin = b.get("vzmin", b.get("vmin", -0.5))
        self.vxmax = b.get("vxmax", b.get("vmax", 0.5))
        self.vymax = b.get("vymax", b.get("vmax", 0.5))
        self.vzmax = b.get("vzmax", b.get("vmax", 0.5))
        self.axmin = b.get("axmin", b.get("amin", -1.0))
        self.aymin = b.get("aymin", b.get("amin", -1.0))
        self.azmin = b.get("azmin", b.get("amin", -1.0))
        self.axmax = b.get("axmax", b.get("amax", 1.0))
        self.aymax = b.get("aymax", b.get("amax", 1.0))
        self.azmax = b.get("azmax", b.get("amax", 1.0))
        self.jxmin = b.get("jxmin", b.get("jmin", -2.0))
        self.jymin = b.get("jymin", b.get("jmin", -2.0))
        self.jzmin = b.get("jzmin", b.get("jmin", -2.0))
        self.jxmax = b.get("jxmax", b.get("jmax", 2.0))
        self.jymax = b.get("jymax", b.get("jmax", 2.0))
        self.jzmax = b.get("jzmax", b.get("jmax", 2.0))

    def set_default_options(self):
        Vehicle.set_default_options(self)
        self.options.update({"vel_limit": "machining",
                             "variable_tolerance": False})

    def define_trajectory_constraints(self, splines, horizon_time, skip=()):
        x, y, z = splines
        dx, dy, dz = x.derivative(), y.derivative(), z.derivative()
        ddx, ddy, ddz = (x.derivative(2), y.derivative(2), z.derivative(2))
        dddx, dddy, dddz = (x.derivative(3), y.derivative(3), z.derivative(3))
        T = horizon_time
        if self.options["vel_limit"] == "machining":
            if self.vxmax != 0.0:
                self.define_constraint(
                    dx * dx + dy * dy - (T ** 2) * self.vxmax ** 2,
                    -BIG, 0.0, skip=skip)
            else:
                self.define_constraint(
                    dz * dz - (T ** 2) * self.vzmax ** 2, -BIG, 0.0,
                    skip=skip)
        elif self.options["vel_limit"] == "axes":
            self.define_constraint(-dx + T * self.vxmin, -BIG, 0.0, skip=skip)
            self.define_constraint(-dy + T * self.vymin, -BIG, 0.0, skip=skip)
            self.define_constraint(-dz + T * self.vzmin, -BIG, 0.0, skip=skip)
            self.define_constraint(dx - T * self.vxmax, -BIG, 0.0, skip=skip)
            self.define_constraint(dy - T * self.vymax, -BIG, 0.0, skip=skip)
            self.define_constraint(dz - T * self.vzmax, -BIG, 0.0, skip=skip)
        else:
            raise ValueError("vel_limit must be 'machining' or 'axes'")
        self.define_constraint(-ddx + (T ** 2) * self.axmin, -BIG, 0.0,
                               skip=skip)
        self.define_constraint(-ddy + (T ** 2) * self.aymin, -BIG, 0.0,
                               skip=skip)
        self.define_constraint(-ddz + (T ** 2) * self.azmin, -BIG, 0.0,
                               skip=skip)
        self.define_constraint(ddx - (T ** 2) * self.axmax, -BIG, 0.0,
                               skip=skip)
        self.define_constraint(ddy - (T ** 2) * self.aymax, -BIG, 0.0,
                               skip=skip)
        self.define_constraint(ddz - (T ** 2) * self.azmax, -BIG, 0.0,
                               skip=skip)
        self.define_constraint(-dddx + (T ** 3) * self.jxmin, -BIG, 0.0)
        self.define_constraint(-dddy + (T ** 3) * self.jymin, -BIG, 0.0)
        self.define_constraint(-dddz + (T ** 3) * self.jzmin, -BIG, 0.0)
        self.define_constraint(dddx - (T ** 3) * self.jxmax, -BIG, 0.0)
        self.define_constraint(dddy - (T ** 3) * self.jymax, -BIG, 0.0)
        self.define_constraint(dddz - (T ** 3) * self.jzmax, -BIG, 0.0)

    def get_initial_constraints(self, splines, horizon_time):
        state0 = self.define_parameter("state0", 3)
        input0 = self.define_parameter("input0", 3)
        dinput0 = self.define_parameter("dinput0", 3)
        x, y, z = splines
        T = horizon_time
        return [(x, state0[0]), (y, state0[1]), (z, state0[2]),
                (x.derivative(), T * input0[0]),
                (y.derivative(), T * input0[1]),
                (z.derivative(), T * input0[2]),
                (x.derivative(2), T ** 2 * dinput0[0]),
                (y.derivative(2), T ** 2 * dinput0[1]),
                (z.derivative(2), T ** 2 * dinput0[2])]

    def get_terminal_constraints(self, splines, horizon_time=None):
        position = self.define_parameter("poseT", 3)
        x, y, z = splines
        term_con = [(x, position[0]), (y, position[1]), (z, position[2])]
        term_con_der = []
        for d in range(1, self.degree):
            term_con_der.extend([(x.derivative(d), 0.0),
                                 (y.derivative(d), 0.0),
                                 (z.derivative(d), 0.0)])
        return [term_con, term_con_der]

    def set_initial_conditions(self, state, input=None, dinput=None,
                               ddinput=None):
        self.prediction["state"] = np.asarray(state, dtype=np.float64)
        self.prediction["input"] = np.zeros(3) if input is None \
            else np.asarray(input)
        self.prediction["dinput"] = np.zeros(3) if dinput is None \
            else np.asarray(dinput)

    def set_terminal_conditions(self, position):
        self.poseT = np.asarray(position, dtype=np.float64)

    def get_init_spline_value(self):
        n = len(self.basis)
        pos0 = self.prediction["state"]
        return [np.stack([np.linspace(pos0[k], self.poseT[k], n)
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
        parameters[self]["dinput0"] = self.prediction["dinput"]
        parameters[self]["poseT"] = self.poseT
        return parameters

    def define_collision_constraints(self, segment, splines, horizon_time):
        """Stay inside the G-code segment shape (omgtools tool.py:179-267)."""
        x, y, z = splines
        position = [x, y]
        shape = self.shapes[0]
        checkpoints, rad = shape.get_checkpoints()
        r0 = float(rad[0])
        seg_shape = segment["shape"]
        if (isinstance(seg_shape, (Rectangle, Square))
                and (seg_shape.orientation % (np.pi / 2)) == 0
                and isinstance(shape, (Circle, Rectangle, Square))):
            lims = seg_shape.get_canvas_limits()
            room_limits = [lims[k] + segment["pose"][k] for k in range(2)]
            for chck in checkpoints:
                for k in range(2):
                    self.define_constraint(
                        -(float(chck[k]) + position[k])
                        + float(room_limits[k][0]) + r0, -BIG, 0.0)
                    self.define_constraint(
                        (float(chck[k]) + position[k])
                        - float(room_limits[k][1]) + r0, -BIG, 0.0)
        elif isinstance(seg_shape, (Rectangle, Square)) and \
                isinstance(shape, Circle):
            # diagonal line segment: tolerance tube around the line
            x1, y1, _ = segment["start"]
            x2, y2, _ = segment["end"]
            tolerance = seg_shape.height * 0.5
            vec = [x2 - x1, y2 - y1]
            nrm = np.sqrt(vec[0] ** 2 + vec[1] ** 2)
            a = np.array([-vec[1], vec[0]]) / nrm
            bb = float(a @ np.array([x1, y1]))
            self.define_constraint(float(a[0]) * position[0]
                                   + float(a[1]) * position[1]
                                   - bb - tolerance + r0, -BIG, 0.0)
            self.define_constraint(-float(a[0]) * position[0]
                                   - float(a[1]) * position[1]
                                   + bb - tolerance + r0, -BIG, 0.0)
        elif isinstance(seg_shape, Ring) and isinstance(shape, Circle):
            cx, cy = float(segment["pose"][0]), float(segment["pose"][1])
            dx_ = position[0] - cx
            dy_ = position[1] - cy
            self.define_constraint(
                -(dx_ * dx_) - (dy_ * dy_)
                + (seg_shape.radius_in + r0) ** 2, -BIG, 0.0)
            self.define_constraint(
                (dx_ * dx_) + (dy_ * dy_)
                - (seg_shape.radius_out - r0) ** 2, -BIG, 0.0)
        else:
            raise RuntimeError("invalid G-code segment shape")
        if segment["start"][2] != segment["end"][2]:
            z_min = min(segment["start"][2], segment["end"][2])
            z_max = max(segment["start"][2], segment["end"][2])
            self.define_constraint(-z + z_min - r0, -BIG, 0.0)
            self.define_constraint(z - z_max - r0, -BIG, 0.0)
        if self.options["variable_tolerance"]:
            ex, ey = float(segment["end"][0]), float(segment["end"][1])
            box = self.tolerance * 0.9
            self.define_constraint(position[0](np.asarray(1.0)) - ex - box,
                                   -BIG, 0.0)
            self.define_constraint(-position[0](np.asarray(1.0)) + ex - box,
                                   -BIG, 0.0)
            self.define_constraint(position[1](np.asarray(1.0)) - ey - box,
                                   -BIG, 0.0)
            self.define_constraint(-position[1](np.asarray(1.0)) + ey - box,
                                   -BIG, 0.0)

    def splines2signals(self, splines, time):
        x, y, z = splines
        state = np.vstack([sample_spline(s, time) for s in (x, y, z)])
        inp = np.vstack([sample_spline(s.derivative(), time)
                         for s in (x, y, z)])
        return {
            "state": state, "input": inp,
            "v_tot": np.sqrt(inp[0] ** 2 + inp[1] ** 2 + inp[2] ** 2),
            "dinput": np.vstack([sample_spline(s.derivative(2), time)
                                 for s in (x, y, z)]),
            "ddinput": np.vstack([sample_spline(s.derivative(3), time)
                                  for s in (x, y, z)]),
        }

    def state2pose(self, state):
        return np.r_[np.asarray(state), np.zeros(3)]

    def ode(self, state, input):
        return np.asarray(input, dtype=np.float64)

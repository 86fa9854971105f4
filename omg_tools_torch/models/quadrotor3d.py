"""3D quadrotors (counterpart of ``omg_tools_tpu.models.quadrotor3d``).

- SimpleQuadrotor3D (omgtools vehicles/quadrotor3d_simple.py): x, y, z
  splines of degree 4; thrust u1 and roll/pitch rates u2/u3 recovered
  from 2nd/3rd derivatives with small-angle decoupling; polynomial
  input/attitude bounds.
- Quadrotor3D (omgtools vehicles/quadrotor3d.py:47): the full model --
  decision splines f_til (scaled thrust) + tangent-half-angle attitude
  splines, position by exact double spline integration, acceleration
  spline substitution with soft/exact equality ties.
"""

from __future__ import annotations

import numpy as np

from .base import Vehicle
from ..environment.shapes import Sphere
from ..modeling.opti import BIG
from ..ops.basis import clamped_basis
from ..ops.spline import (evalspline, running_integral, sample_spline)

__all__ = ["SimpleQuadrotor3D", "Quadrotor3D"]


class SimpleQuadrotor3D(Vehicle):

    def __init__(self, radius=0.2, options=None, bounds=None):
        bounds = bounds or {}
        Vehicle.__init__(self, n_spl=3, degree=4, shapes=Sphere(radius),
                         options=options)
        self.radius = radius
        self.g = 9.81
        self.u1min = bounds.get("u1min", 1.0)
        self.u1max = bounds.get("u1max", 15.0)
        self.u2min = bounds.get("u2min", -8.0)
        self.u2max = bounds.get("u2max", 8.0)
        self.u3min = bounds.get("u3min", -8.0)
        self.u3max = bounds.get("u3max", 8.0)
        self.phimin = bounds.get("phimin", -np.pi / 6)
        self.phimax = bounds.get("phimax", np.pi / 6)
        self.thetamin = bounds.get("thetamin", -np.pi / 6)
        self.thetamax = bounds.get("thetamax", np.pi / 6)

    def set_default_options(self):
        Vehicle.set_default_options(self)
        self.options["stop_tol"] = 1.0e-2

    def define_trajectory_constraints(self, splines, horizon_time):
        x, y, z = splines
        ddx, ddy, ddz = (x.derivative(2), y.derivative(2), z.derivative(2))
        dddx, dddy, dddz = (x.derivative(3), y.derivative(3), z.derivative(3))
        T = horizon_time
        g_tf = self.g * (T ** 2)
        zz = ddz + g_tf
        # thrust magnitude
        self.define_constraint(
            -(ddx * ddx + ddy * ddy + zz * zz) + (T ** 4) * self.u1min ** 2,
            -BIG, 0.0)
        self.define_constraint(
            (ddx * ddx + ddy * ddy + zz * zz) - (T ** 4) * self.u1max ** 2,
            -BIG, 0.0)
        # roll rate u2
        self.define_constraint(
            -dddy * zz + dddz * ddy - (zz * zz) * T * self.u2max, -BIG, 0.0)
        self.define_constraint(
            dddy * zz - dddz * ddy + (zz * zz) * T * self.u2min, -BIG, 0.0)
        # pitch rate u3
        self.define_constraint(
            dddx * zz - dddz * ddx - (zz * zz) * T * self.u3max, -BIG, 0.0)
        self.define_constraint(
            -dddx * zz + dddz * ddx + (zz * zz) * T * self.u3min, -BIG, 0.0)
        # attitude bounds
        self.define_constraint(-ddy - zz * self.phimax, -BIG, 0.0)
        self.define_constraint(ddy + zz * self.phimin, -BIG, 0.0)
        self.define_constraint(ddx - zz * self.thetamax, -BIG, 0.0)
        self.define_constraint(-ddx + zz * self.thetamin, -BIG, 0.0)

    def get_initial_constraints(self, splines, horizon_time):
        spl0 = self.define_parameter("spl0", 3)
        dspl0 = self.define_parameter("dspl0", 3)
        ddspl0 = self.define_parameter("ddspl0", 3)
        T = horizon_time
        con = []
        for k, s in enumerate(splines):
            con.append((s, spl0[k]))
            con.append((s.derivative(), T * dspl0[k]))
            con.append((s.derivative(2), (T ** 2) * ddspl0[k]))
        return con

    def get_terminal_constraints(self, splines, horizon_time=None):
        position = self.define_parameter("positionT", 3)
        term_con = [(s, position[k]) for k, s in enumerate(splines)]
        term_con_der = []
        for d in range(1, self.degree + 1):
            term_con_der.extend([(s.derivative(d), 0.0) for s in splines])
        return [term_con, term_con_der]

    def set_initial_conditions(self, state, input=None):
        state = np.asarray(state, dtype=np.float64)
        self.prediction["state"] = np.r_[state[:3], np.zeros(3)][:6]
        self.prediction["dspl"] = np.zeros(3)
        self.prediction["ddspl"] = np.zeros(3)

    def set_terminal_conditions(self, position):
        self.positionT = np.asarray(position, dtype=np.float64)
        self.poseT = self.positionT

    def get_init_spline_value(self):
        n = len(self.basis)
        d = self.degree
        pos0 = self.prediction["state"][:3]
        init = np.zeros((n, 3))
        for k in range(3):
            init[:, k] = np.r_[pos0[k] * np.ones(d),
                               np.linspace(pos0[k], self.positionT[k],
                                           n - 2 * d),
                               self.positionT[k] * np.ones(d)]
        return [init]

    def check_terminal_conditions(self):
        tol = self.options["stop_tol"]
        return (np.linalg.norm(self.signals["state"][:3, -1]
                               - self.positionT) <= tol and
                np.linalg.norm(self.signals["dspl"][:, -1]) <= tol)

    def set_parameters(self, current_time):
        parameters = Vehicle.set_parameters(self, current_time)
        parameters[self]["spl0"] = self.prediction["state"][:3]
        parameters[self]["dspl0"] = self.prediction["dspl"]
        parameters[self]["ddspl0"] = self.prediction["ddspl"]
        parameters[self]["positionT"] = self.positionT
        return parameters

    def define_collision_constraints(self, hyperplanes, room, splines,
                                     horizon_time):
        self.define_collision_constraints_3d(hyperplanes, room, list(splines),
                                             horizon_time)

    def splines2signals(self, splines, time):
        x, y, z = splines
        pos = np.vstack([sample_spline(s, time) for s in splines])
        vel = np.vstack([sample_spline(s.derivative(), time)
                         for s in splines])
        acc = np.vstack([sample_spline(s.derivative(2), time)
                         for s in splines])
        u1 = np.sqrt(acc[0] ** 2 + acc[1] ** 2 + (acc[2] + self.g) ** 2)
        phi = -np.arctan2(acc[1], acc[2] + self.g)
        theta = np.arctan2(acc[0], acc[2] + self.g)
        return {
            "state": np.vstack([pos, vel]),
            "input": np.vstack([u1, phi, theta]),
            "dspl": vel, "ddspl": acc,
        }

    def state2pose(self, state):
        return np.r_[np.asarray(state)[:3], 0.0, 0.0, 0.0]

    def ode(self, state, input):
        # state: pos (3), vel (3); input: u1, phi, theta (small angles)
        u1, phi, theta = input[0], input[1], input[2]
        acc = np.r_[u1 * np.sin(theta), -u1 * np.sin(phi),
                    u1 * np.cos(phi) * np.cos(theta) - self.g]
        return np.r_[state[3:6], acc]


class Quadrotor3D(Vehicle):
    """Full 3D quadrotor with tangent-half-angle attitude splines and
    spline-substituted accelerations (omgtools quadrotor3d.py:47).

    Model (omgtools quadrotor3d.py:29-44):
        ddx = (F/m) cos(phi) sin(theta),  ddy = -(F/m) sin(phi),
        ddz = (F/m) cos(phi) cos(theta) - g;  inputs u1 = F/m,
        u2 = dphi, u3 = dtheta.
    Decision splines: f_til = u1 / ((1+q_phi^2)(1+q_theta^2)),
    q_phi = tan(phi/2), q_theta = tan(theta/2) (degree 2), which makes the
    accelerations POLYNOMIAL in the spline coefficients:
        ddx = f_til (1-q_phi^2)(2 q_theta)
        ddy = -f_til (1+q_theta^2)(2 q_phi)
        ddz = f_til (1-q_phi^2)(1-q_theta^2) - g.
    Position comes from exact double spline integration; the
    ``substitution`` option (default, omgtools quadrotor3d.py:102-134)
    introduces lower-degree acceleration spline variables ddx/ddy/ddz tied
    to the model by soft (or exact) equality, so collision constraints act
    on a cheaper basis.
    """

    def __init__(self, radius=0.2, options=None, bounds=None):
        bounds = bounds or {}
        Vehicle.__init__(self, n_spl=3, degree=2, shapes=Sphere(radius),
                         options=options)
        self.radius = radius
        self.g = 9.81
        self.u1min = bounds.get("u1min", 2.0)
        self.u1max = bounds.get("u1max", 15.0)
        self.u2min = bounds.get("u2min", -2.0)
        self.u2max = bounds.get("u2max", 2.0)
        self.u3min = bounds.get("u3min", -2.0)
        self.u3max = bounds.get("u3max", 2.0)
        self.phimin = bounds.get("phimin", -np.pi / 6)
        self.phimax = bounds.get("phimax", np.pi / 6)
        self.thetamin = bounds.get("thetamin", -np.pi / 6)
        self.thetamax = bounds.get("thetamax", np.pi / 6)

    def set_default_options(self):
        Vehicle.set_default_options(self)
        self.options["stop_tol"] = 5.0e-1
        self.options["substitution"] = True
        self.options["exact_substitution"] = False

    def init(self):
        self.pos0 = self.define_parameter("pos0", 3)
        self.dpos0 = self.define_parameter("dpos0", 3)

    def _accelerations(self, splines):
        f_til, q_phi, q_theta = splines
        ddx = f_til * (1 - q_phi ** 2) * (2 * q_theta)
        ddy = -1.0 * (f_til * (1 + q_theta ** 2) * (2 * q_phi))
        ddz = f_til * (1 - q_phi ** 2) * (1 - q_theta ** 2) - self.g
        return ddx, ddy, ddz

    def integrate_twice(self, dds, ds0, s0, t, T=1.0):
        """Exact double spline integration with s(t) = s0, ds(t) = ds0
        (omgtools quadrotor3d.py:238-251)."""
        dds_int = T * running_integral(dds)
        ds = dds_int - evalspline(dds_int, _as_frac(t, T)) + ds0
        ds_int = T * running_integral(ds)
        s = ds_int - evalspline(ds_int, _as_frac(t, T)) + s0
        return s, ds

    def define_trajectory_constraints(self, splines, horizon_time):
        f_til, q_phi, q_theta = splines
        dq_phi, dq_theta = q_phi.derivative(), q_theta.derivative()
        T = horizon_time
        # thrust u1 = f_til (1+q_phi^2)(1+q_theta^2) bounds
        den = (1 + q_phi ** 2) * (1 + q_theta ** 2)
        self.define_constraint(f_til * den - self.u1max, -BIG, 0.0)
        self.define_constraint(-1.0 * (f_til * den) + self.u1min, -BIG, 0.0)
        # attitude rates: dphi = 2 dq_phi / (1+q_phi^2)
        self.define_constraint(
            2 * dq_phi - (1 + q_phi ** 2) * T * self.u2max, -BIG, 0.0)
        self.define_constraint(
            -2 * dq_phi + (1 + q_phi ** 2) * T * self.u2min, -BIG, 0.0)
        self.define_constraint(
            2 * dq_theta - (1 + q_theta ** 2) * T * self.u3max, -BIG, 0.0)
        self.define_constraint(
            -2 * dq_theta + (1 + q_theta ** 2) * T * self.u3min, -BIG, 0.0)
        # attitude bounds in tangent-half-angle space
        self.define_constraint(q_phi - np.tan(0.5 * self.phimax), -BIG, 0.0)
        self.define_constraint(-q_phi + np.tan(0.5 * self.phimin), -BIG, 0.0)
        self.define_constraint(q_theta - np.tan(0.5 * self.thetamax),
                               -BIG, 0.0)
        self.define_constraint(-q_theta + np.tan(0.5 * self.thetamin),
                               -BIG, 0.0)
        if self.options["substitution"]:
            ddx, ddy, ddz = self._accelerations(splines)
            t = self.problem_t
            if self.options["exact_substitution"]:
                # acceleration variables on the model's own (product) basis
                self.ddx = self.define_spline_variable(
                    "ddx", 1, basis=ddx.basis)[0]
                self.ddy = self.define_spline_variable(
                    "ddy", 1, basis=ddy.basis)[0]
                self.ddz = self.define_spline_variable(
                    "ddz", 1, basis=ddz.basis)[0]
                self.x, self.dx = self.integrate_twice(
                    self.ddx, self.dpos0[0], self.pos0[0], t, T)
                self.y, self.dy = self.integrate_twice(
                    self.ddy, self.dpos0[1], self.pos0[1], t, T)
                self.z, self.dz = self.integrate_twice(
                    self.ddz, self.dpos0[2], self.pos0[2], t, T)
                self.define_constraint(self.ddx - ddx, 0.0, 0.0)
                self.define_constraint(self.ddy - ddy, 0.0, 0.0)
                self.define_constraint(self.ddz - ddz, 0.0, 0.0)
            else:
                # lower-degree acceleration basis + soft position ties
                # (omgtools quadrotor3d.py:117-134)
                sub_basis = clamped_basis(10, 4)
                self.ddx = self.define_spline_variable(
                    "ddx", 1, basis=sub_basis)[0]
                self.ddy = self.define_spline_variable(
                    "ddy", 1, basis=sub_basis)[0]
                self.ddz = self.define_spline_variable(
                    "ddz", 1, basis=sub_basis)[0]
                self.x, self.dx = self.integrate_twice(
                    self.ddx, self.dpos0[0], self.pos0[0], t, T)
                self.y, self.dy = self.integrate_twice(
                    self.ddy, self.dpos0[1], self.pos0[1], t, T)
                self.z, self.dz = self.integrate_twice(
                    self.ddz, self.dpos0[2], self.pos0[2], t, T)
                x, _ = self.integrate_twice(ddx, self.dpos0[0], self.pos0[0],
                                            t, T)
                y, _ = self.integrate_twice(ddy, self.dpos0[1], self.pos0[1],
                                            t, T)
                z, _ = self.integrate_twice(ddz, self.dpos0[2], self.pos0[2],
                                            t, T)
                eps = 1e-3
                self.define_constraint(self.x - x, -eps, eps)
                self.define_constraint(self.y - y, -eps, eps)
                self.define_constraint(self.z - z, -eps, eps)

    def _position_splines(self, splines, horizon_time):
        if self.options["substitution"]:
            return self.x, self.y, self.z
        ddx, ddy, ddz = self._accelerations(splines)
        t = self.problem_t
        x, _ = self.integrate_twice(ddx, self.dpos0[0], self.pos0[0], t,
                                    horizon_time)
        y, _ = self.integrate_twice(ddy, self.dpos0[1], self.pos0[1], t,
                                    horizon_time)
        z, _ = self.integrate_twice(ddz, self.dpos0[2], self.pos0[2], t,
                                    horizon_time)
        return x, y, z

    def get_initial_constraints(self, splines, horizon_time):
        f_til0 = self.define_parameter("f_til0", 1)
        q_phi0 = self.define_parameter("q_phi0", 1)
        q_theta0 = self.define_parameter("q_theta0", 1)
        f_til, q_phi, q_theta = splines
        return [(f_til, f_til0[0]), (q_phi, q_phi0[0]),
                (q_theta, q_theta0[0])]

    def get_terminal_constraints(self, splines, horizon_time=None):
        posT = self.define_parameter("posT", 3)
        q_phiT = self.define_parameter("q_phiT", 1)
        q_thetaT = self.define_parameter("q_thetaT", 1)
        f_til, q_phi, q_theta = splines
        x, y, z = self.x, self.y, self.z
        dx, dy, dz = self.dx, self.dy, self.dz
        term_con = [(x, posT[0]), (y, posT[1]), (z, posT[2])]
        term_con_der = [(q_phi, q_phiT[0]), (q_theta, q_thetaT[0]),
                        (f_til, self.g), (dx, 0.0), (dy, 0.0), (dz, 0.0)]
        return [term_con, term_con_der]

    def set_initial_conditions(self, state, input=None):
        state = np.asarray(state, dtype=np.float64)
        if input is None:
            input = np.array([self.g, 0.0, 0.0])
        if state.shape[0] < 8:
            state = np.r_[state[:3], np.zeros(3), np.zeros(2)][:8]
        self.prediction["state"] = state
        self.prediction["input"] = np.asarray(input, dtype=np.float64)

    def set_terminal_conditions(self, position, roll=0.0, pitch=0.0):
        self.poseT = np.r_[np.asarray(position, dtype=np.float64),
                           roll, pitch, 0.0]

    def get_init_spline_value(self):
        n = len(self.basis)
        init = np.zeros((n, 3))
        q_phi0 = np.tan(self.prediction["state"][6] / 2.0)
        q_theta0 = np.tan(self.prediction["state"][7] / 2.0)
        q_phiT = np.tan(self.poseT[3] / 2.0)
        q_thetaT = np.tan(self.poseT[4] / 2.0)
        init[:, 0] = self.g / ((1 + q_phi0 ** 2) * (1 + q_theta0 ** 2))
        init[:, 1] = np.linspace(q_phi0, q_phiT, n)
        init[:, 2] = np.linspace(q_theta0, q_thetaT, n)
        return [init]

    def check_terminal_conditions(self):
        tol = self.options["stop_tol"]
        pose_ok = np.linalg.norm(self.signals["pose"][:3, -1]
                                 - self.poseT[:3]) <= tol
        input_ok = abs(np.linalg.norm(self.signals["input"][:, -1])
                       - self.g) <= tol
        return bool(pose_ok and input_ok)

    def set_parameters(self, current_time):
        parameters = Vehicle.set_parameters(self, current_time)
        state = self.prediction["state"]
        inp = self.prediction["input"]
        q_phi0 = np.tan(state[6] / 2.0)
        q_theta0 = np.tan(state[7] / 2.0)
        parameters[self]["q_phi0"] = q_phi0
        parameters[self]["q_theta0"] = q_theta0
        parameters[self]["f_til0"] = inp[0] / ((1 + q_phi0 ** 2)
                                               * (1 + q_theta0 ** 2))
        parameters[self]["pos0"] = state[:3]
        parameters[self]["dpos0"] = state[3:6]
        parameters[self]["posT"] = self.poseT[:3]
        parameters[self]["q_phiT"] = np.tan(self.poseT[3] / 2.0)
        parameters[self]["q_thetaT"] = np.tan(self.poseT[4] / 2.0)
        return parameters

    def define_collision_constraints(self, hyperplanes, room, splines,
                                     horizon_time):
        x, y, z = self._position_splines(splines, horizon_time)
        self.define_collision_constraints_3d(hyperplanes, room, [x, y, z],
                                             horizon_time)

    def splines2signals(self, splines, time):
        f_til, q_phi, q_theta = splines
        dq_phi, dq_theta = q_phi.derivative(), q_theta.derivative()
        ddx, ddy, ddz = self._accelerations(splines)
        state = self.prediction["state"]
        x, dx = self.integrate_twice(ddx, state[3], state[0], float(time[0]))
        y, dy = self.integrate_twice(ddy, state[4], state[1], float(time[0]))
        z, dz = self.integrate_twice(ddz, state[5], state[2], float(time[0]))
        pos = np.vstack([sample_spline(s, time) for s in (x, y, z)])
        vel = np.vstack([sample_spline(s, time) for s in (dx, dy, dz)])
        q_phi_s = np.asarray(sample_spline(q_phi, time))
        q_theta_s = np.asarray(sample_spline(q_theta, time))
        dq_phi_s = np.asarray(sample_spline(dq_phi, time))
        dq_theta_s = np.asarray(sample_spline(dq_theta, time))
        f_til_s = np.asarray(sample_spline(f_til, time))
        phi = 2 * np.arctan2(q_phi_s, 1.0)
        theta = 2 * np.arctan2(q_theta_s, 1.0)
        dphi = 2 * dq_phi_s / (1.0 + q_phi_s ** 2)
        dtheta = 2 * dq_theta_s / (1.0 + q_theta_s ** 2)
        f = f_til_s * (1 + q_phi_s ** 2) * (1 + q_theta_s ** 2)
        return {"state": np.vstack([pos, vel, phi[None, :], theta[None, :]]),
                "input": np.vstack([f, dphi, dtheta])}

    def state2pose(self, state):
        state = np.asarray(state)
        return np.r_[state[0], state[1], state[2], state[6], state[7], 0.0]

    def ode(self, state, input):
        phi, theta = state[6], state[7]
        u1, u2, u3 = input[0], input[1], input[2]
        return np.r_[state[3:6],
                     u1 * np.sin(theta) * np.cos(phi),
                     -u1 * np.sin(phi),
                     -self.g + u1 * np.cos(phi) * np.cos(theta),
                     u2, u3]


def _as_frac(t, T):
    """t / T valid for a number t and a tensor t."""
    if isinstance(t, (int, float)):
        return float(t) / (T if isinstance(T, (int, float)) else 1.0)
    return t / T

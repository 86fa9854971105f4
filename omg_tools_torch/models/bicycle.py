"""Bicycle (car-like) vehicle with steering angle (counterpart of
``omg_tools_tpu.models.bicycle``; omgtools vehicles/bicycle.py).  Model:
    dx = V cos(theta), dy = V sin(theta), dtheta = V/L tan(delta)
with the tangent-half-angle substitution (tg_ha = tan(theta/2),
v_til = V/(1+tg_ha^2)); steering delta is recovered from
    tan(delta) = 2 dtg_ha L / (v_til (1+tg_ha^2)^2)
and steering angle/rate limits become polynomial constraints in the
decision splines (v_til, tg_ha) of degree 2.
"""

from __future__ import annotations

import numpy as np

from .base import Vehicle
from .dubins import Dubins
from ..environment.shapes import Circle
from ..modeling.opti import BIG
from ..ops.spline import evalspline, sample_spline

__all__ = ["Bicycle"]


class Bicycle(Dubins):
    """Shares the half-angle/integration machinery with Dubins."""

    def __init__(self, length=0.4, options=None, bounds=None):
        bounds = bounds or {}
        options = dict(options or {})
        options.setdefault("degree", 2)
        Dubins.__init__(self, shapes=Circle(length / 2.0), options=options,
                        bounds=bounds)
        self.length = length
        self.amax = bounds.get("amax", 1.0)
        self.dmin = bounds.get("dmin", -np.pi / 6.0)
        self.dmax = bounds.get("dmax", np.pi / 6.0)
        self.ddmin = bounds.get("ddmin", -np.pi / 4.0)
        self.ddmax = bounds.get("ddmax", np.pi / 4.0)
        self.vmax = bounds.get("vmax", 0.8)

    def define_trajectory_constraints(self, splines, horizon_time):
        v_til, tg_ha = splines
        dv_til, dtg_ha = v_til.derivative(), tg_ha.derivative()
        ddtg_ha = tg_ha.derivative(2)
        T = horizon_time
        L = self.length
        one_tg2 = 1 + tg_ha * tg_ha
        self.define_constraint(v_til * one_tg2 - self.vmax, -BIG, 0.0)
        self.define_constraint(
            dv_til * one_tg2 + 2 * v_til * tg_ha * dtg_ha - T * self.amax,
            -BIG, 0.0)
        # steering angle limits: tan(delta) in [tan(dmin), tan(dmax)]
        one_tg2_sq = one_tg2 * one_tg2
        self.define_constraint(
            2 * dtg_ha * L - v_til * one_tg2_sq * np.tan(self.dmax) * T,
            -BIG, 0.0)
        self.define_constraint(
            -2 * dtg_ha * L + v_til * one_tg2_sq * np.tan(self.dmin) * T,
            -BIG, 0.0)
        # steering-rate limits (quotient rule on tan(delta), denominator
        # multiplied through to stay polynomial)
        num_d = (2 * L * ddtg_ha * (v_til * one_tg2_sq)
                 - 2 * L * dtg_ha * (dv_til * one_tg2_sq
                                     + v_til * (4 * tg_ha
                                                + 4 * tg_ha * tg_ha * tg_ha)
                                     * dtg_ha))
        den = ((T ** 2) * v_til * v_til * one_tg2_sq * one_tg2_sq
               + (2 * L * dtg_ha) * (2 * L * dtg_ha))
        self.define_constraint(num_d - den * self.ddmax, -BIG, 0.0)
        self.define_constraint(-num_d + den * self.ddmin, -BIG, 0.0)
        self.define_constraint(-v_til, -BIG, 0.0)  # forward driving

    def get_initial_constraints(self, splines, horizon_time):
        v_til0 = self.define_parameter("v_til0", 1)
        tg_ha0 = self.define_parameter("tg_ha0", 1)
        dtg_ha0 = self.define_parameter("dtg_ha0", 1)
        hop0 = self.define_parameter("hop0", 1)
        tdelta0 = self.define_parameter("tdelta0", 1)
        v_til, tg_ha = splines
        dv_til, dtg_ha = v_til.derivative(), tg_ha.derivative()
        ddtg_ha = tg_ha.derivative(2)
        T = horizon_time
        t0 = self.problem_t / T
        # standstill steering continuity via l'Hopital (omgtools
        # bicycle.py:146-159): active only when hop0 = 1
        self.define_constraint(
            hop0[0] * (2.0 * evalspline(ddtg_ha, t0) * self.length
                       - tdelta0[0] * evalspline(dv_til, t0)
                       * (1.0 + tg_ha0[0] ** 2) ** 2 * T), 0.0, 0.0)
        return [(v_til, v_til0[0]), (tg_ha, tg_ha0[0]),
                (dtg_ha, T * dtg_ha0[0])]

    def get_terminal_constraints(self, splines, horizon_time=None):
        horizon_time = horizon_time if horizon_time is not None \
            else self.problem_T
        posT = self.define_parameter("posT", 2)
        tg_haT = self.define_parameter("tg_haT", 1)
        v_til, tg_ha = splines
        dv_til, dtg_ha = v_til.derivative(), tg_ha.derivative()
        ddtg_ha = tg_ha.derivative(2)
        x, y = self._positions(splines, horizon_time)
        term_con = [(x, posT[0]), (y, posT[1]), (tg_ha, tg_haT[0])]
        term_con_der = [(v_til, 0.0), (dtg_ha, 0.0), (dv_til, 0.0),
                        (ddtg_ha, 0.0)]
        return [term_con, term_con_der]

    def set_initial_conditions(self, state, input=None):
        input = np.zeros(2) if input is None else np.asarray(input)
        state = np.asarray(state, dtype=np.float64)
        self.prediction["state"] = state
        self.prediction["input"] = np.asarray(input, dtype=np.float64)
        self.pose0 = state[:3]
        self.delta0 = state[3] if len(state) > 3 else 0.0

    def set_parameters(self, current_time):
        parameters = Vehicle.set_parameters(self, current_time)
        tg_ha0 = np.tan(self.prediction["state"][2] / 2.0)
        v_til0 = self.prediction["input"][0] / (1 + tg_ha0 ** 2)
        parameters[self]["tg_ha0"] = [tg_ha0]
        parameters[self]["pos0"] = self.prediction["state"][:2]
        parameters[self]["posT"] = self.poseT[:2]
        parameters[self]["tg_haT"] = [np.tan(self.poseT[2] / 2.0)]
        delta = self.prediction["state"][3] \
            if len(self.prediction["state"]) > 3 else 0.0
        if v_til0 <= 1e-4:  # standstill: use l'Hopital constraint
            parameters[self]["hop0"] = [1.0]
            parameters[self]["v_til0"] = [0.0]
            parameters[self]["dtg_ha0"] = [0.0]
            parameters[self]["tdelta0"] = [np.tan(delta)]
        else:
            parameters[self]["hop0"] = [0.0]
            parameters[self]["v_til0"] = [v_til0]
            parameters[self]["dtg_ha0"] = [
                np.tan(delta) * v_til0 * (1 + tg_ha0 ** 2) ** 2
                / (2 * self.length)]
            parameters[self]["tdelta0"] = [0.0]
        return parameters

    def check_terminal_conditions(self):
        tol = self.options["stop_tol"]
        return (np.linalg.norm(self.signals["state"][:3, -1] - self.poseT)
                <= tol and
                np.linalg.norm(self.signals["input"][:, -1]) <= tol)

    def splines2signals(self, splines, time):
        v_til, tg_ha = splines
        dv_til, dtg_ha = v_til.derivative(), tg_ha.derivative()
        ddtg_ha = tg_ha.derivative(2)
        dx = v_til * (1 - tg_ha * tg_ha)
        dy = v_til * (2 * tg_ha)
        if not self.signals:
            x0, y0 = self.pose0[0], self.pose0[1]
        else:
            x0, y0 = self.signals["state"][0, -1], self.signals["state"][1, -1]
        x = self.integrate_once(dx, x0, float(time[0]))
        y = self.integrate_once(dy, y0, float(time[0]))
        L = self.length
        v_s = np.asarray(sample_spline(v_til, time))
        tg_s = np.asarray(sample_spline(tg_ha, time))
        dv_s = np.asarray(sample_spline(dv_til, time))
        dtg_s = np.asarray(sample_spline(dtg_ha, time))
        ddtg_s = np.asarray(sample_spline(ddtg_ha, time))
        theta = 2 * np.arctan2(tg_s, 1.0)
        one2 = (1 + tg_s ** 2)
        delta = np.arctan2(2 * dtg_s * L, v_s * one2 ** 2)
        den = v_s ** 2 * one2 ** 4 + (2 * dtg_s * L) ** 2
        num = (2 * ddtg_s * L * (v_s * one2 ** 2)
               - 2 * dtg_s * L * (dv_s * one2 ** 2
                                  + v_s * (4 * tg_s + 4 * tg_s ** 3) * dtg_s))
        with np.errstate(divide="ignore", invalid="ignore"):
            ddelta = np.where(den > 1e-10, num / np.maximum(den, 1e-10), 0.0)
        standstill = (np.abs(v_s) <= 1e-4) & (np.abs(dtg_s) <= 1e-4)
        delta = np.where(standstill,
                         np.arctan2(2 * ddtg_s * L, dv_s * one2 ** 2), delta)
        return {
            "state": np.vstack([sample_spline(x, time),
                                sample_spline(y, time), theta, delta]),
            "input": np.vstack([v_s * one2, ddelta]),
        }

    def state2pose(self, state):
        return np.asarray(state)[:3]

    def ode(self, state, input):
        # state: x, y, theta, delta; input: V, ddelta
        v, dd = input[0], input[1]
        return np.r_[v * np.cos(state[2]), v * np.sin(state[2]),
                     v / self.length * np.tan(state[3]), dd]

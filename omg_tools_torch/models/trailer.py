"""Trailer towed by a lead vehicle (counterpart of
``omg_tools_tpu.models.trailer``; omgtools vehicles/trailer.py): the
decision splines are [tg_ha_trailer] followed by the lead vehicle's
splines; the trailer orientation dynamics (dtheta_tr = V/l sin(theta_veh
- theta_tr)) become relaxed polynomial equality constraints in the
half-angle variables."""

from __future__ import annotations

import numpy as np

from .base import Vehicle
from .dubins import Dubins
from ..environment.shapes import Circle
from ..modeling.opti import BIG
from ..ops.spline import sample_spline

__all__ = ["Trailer"]


class Trailer(Vehicle):

    def __init__(self, lead_veh=None, shapes=None, l_hitch=0.2, options=None,
                 bounds=None):
        bounds = bounds or {}
        self.lead_veh = lead_veh if lead_veh is not None \
            else Dubins(Circle(0.2))
        Vehicle.__init__(self, n_spl=1 + self.lead_veh.n_spl, degree=3,
                         shapes=shapes if shapes is not None else Circle(0.2),
                         options=options)
        self.l_hitch = l_hitch
        self.tmax = bounds.get("tmax", np.pi / 4.0)
        self.tmin = bounds.get("tmin", -np.pi / 4.0)

    def define_knots(self, knot_intervals=None, knots=None):
        # the combined spline variables live on the TRAILER's basis, and the
        # init guess stacks the lead's guess next to the trailer's -- keep
        # the lead's knot structure in lockstep
        Vehicle.define_knots(self, knot_intervals=knot_intervals,
                             knots=knots)
        self.lead_veh.define_knots(knot_intervals=knot_intervals,
                                   knots=knots)

    def init(self):
        self.lead_veh.problem_t = self.problem_t
        self.lead_veh.problem_T = self.problem_T
        self.lead_veh._ctx = self._ctx
        self.lead_veh.init()

    def define_trajectory_constraints(self, splines, horizon_time):
        tg_ha_tr = splines[0]
        dtg_ha_tr = tg_ha_tr.derivative()
        v_til_veh, tg_ha_veh = splines[1:]
        T = horizon_time
        eps = 1e-3
        # trailer orientation follows the towing velocity (relaxed equality;
        # omgtools trailer.py:52-60)
        expr = (2 * dtg_ha_tr * self.l_hitch
                - T * v_til_veh * (2 * tg_ha_veh * (1 - tg_ha_tr * tg_ha_tr)
                                   - (1 - tg_ha_veh * tg_ha_veh)
                                   * 2 * tg_ha_tr))
        self.define_constraint(expr - T * eps, -BIG, 0.0)
        self.define_constraint(-expr - T * eps, -BIG, 0.0)
        # limit the hitch angle
        self.define_constraint(tg_ha_veh - tg_ha_tr - np.tan(self.tmax / 2.0),
                               -BIG, 0.0)
        self.define_constraint(-tg_ha_veh + tg_ha_tr + np.tan(self.tmin / 2.0),
                               -BIG, 0.0)
        self.lead_veh.define_trajectory_constraints(splines[1:], T)

    def get_initial_constraints(self, splines, horizon_time):
        tg_ha_tr0 = self.define_parameter("tg_ha_tr0", 1)
        dtg_ha_tr0 = self.define_parameter("dtg_ha_tr0", 1)
        tg_ha_tr = splines[0]
        con_tr = [(tg_ha_tr, tg_ha_tr0[0]),
                  (tg_ha_tr.derivative(), horizon_time * dtg_ha_tr0[0])]
        con_veh = self.lead_veh.get_initial_constraints(splines[1:],
                                                        horizon_time)
        return con_tr + con_veh

    def get_terminal_constraints(self, splines, horizon_time=None):
        if hasattr(self, "theta_trT"):
            tg_ha_trT = self.define_parameter("tg_ha_trT", 1)
            term_con_tr = [(splines[0], tg_ha_trT[0])]
        else:
            term_con_tr = []
        con_veh = self.lead_veh.get_terminal_constraints(splines[1:],
                                                         horizon_time)
        return [term_con_tr + con_veh[0], con_veh[1]]

    def set_initial_conditions(self, state, input=None):
        theta = float(np.atleast_1d(state)[0])
        full_state = np.zeros(6)
        full_state[2] = theta
        full_state[3:] = self.lead_veh.prediction["state"]
        self.prediction["state"] = full_state
        self.prediction["input"] = self.lead_veh.prediction["input"]

    def set_terminal_conditions(self, theta):
        self.theta_trT = float(np.atleast_1d(theta)[0])

    def get_init_spline_value(self):
        n = len(self.basis)
        tg_ha_tr0 = np.tan(self.prediction["state"][2] / 2.0)
        tg_ha_trT = np.tan(self.theta_trT / 2.0) \
            if hasattr(self, "theta_trT") else tg_ha_tr0
        init_tr = np.linspace(tg_ha_tr0, tg_ha_trT, n)[:, None]
        init_veh = self.lead_veh.get_init_spline_value()[0]
        return [np.c_[init_tr, init_veh]]

    def check_terminal_conditions(self):
        tol = self.options["stop_tol"]
        ok = True
        if hasattr(self, "theta_trT"):
            ok = abs(self.signals["state"][2, -1] - self.theta_trT) <= tol
        # the lead vehicle is not simulated separately: its pose lives in
        # rows 3:6 of the combined trailer state
        lead_pose = self.signals["state"][3:6, -1]
        lead_goal = np.asarray(self.lead_veh.poseT, dtype=np.float64)
        n = min(2, lead_goal.shape[0])
        return ok and bool(np.linalg.norm(lead_pose[:n] - lead_goal[:n])
                           <= self.lead_veh.options.get("stop_tol", 5e-2))

    def set_parameters(self, current_time):
        pred_veh = {"input": self.prediction["input"],
                    "state": self.prediction["state"][3:]}
        self.lead_veh.prediction = pred_veh
        parameters = Vehicle.set_parameters(self, current_time)
        tg_ha_tr0 = np.tan(self.prediction["state"][2] / 2.0)
        parameters[self]["tg_ha_tr0"] = [tg_ha_tr0]
        parameters[self]["dtg_ha_tr0"] = [
            0.5 * self.prediction["input"][0] / self.l_hitch
            * np.sin(self.prediction["state"][5]
                     - self.prediction["state"][2]) * (1 + tg_ha_tr0 ** 2)]
        if hasattr(self, "theta_trT"):
            parameters[self]["tg_ha_trT"] = [np.tan(self.theta_trT / 2.0)]
        # the lead's parameters (pos0/posT/...) are registered under the
        # LEAD's label in the layout -- key them by the lead object, not
        # merged into the trailer's dict (that silently leaves them at
        # their defaults and makes the degenerate T = 0 solution feasible)
        parameters.update(self.lead_veh.set_parameters(current_time))
        return parameters

    def define_collision_constraints(self, hyperplanes, room, splines,
                                     horizon_time):
        tg_ha_tr = splines[0]
        x_veh, y_veh = self.lead_veh._positions(splines[1:], horizon_time)
        # trailer body sits -l_hitch behind the vehicle along theta_tr
        self.define_collision_constraints_2d(hyperplanes, room,
                                             [x_veh, y_veh], horizon_time,
                                             tg_ha=tg_ha_tr,
                                             offset=-self.l_hitch)
        self.lead_veh.define_collision_constraints(hyperplanes, room,
                                                   splines[1:], horizon_time)

    def splines2signals(self, splines, time):
        tg_ha_tr = splines[0]
        dtg_ha_tr = tg_ha_tr.derivative()
        tg_s = np.asarray(sample_spline(tg_ha_tr, time))
        dtg_s = np.asarray(sample_spline(dtg_ha_tr, time))
        theta_tr = 2 * np.arctan2(tg_s, 1.0)
        # the lead vehicle is not simulated separately: integrate its
        # position from the current prediction
        self.lead_veh.pose0 = self.prediction["state"][3:6]
        self.lead_veh.signals = {}
        signals_veh = self.lead_veh.splines2signals(splines[1:], time)
        x_tr = signals_veh["state"][0] - self.l_hitch * np.cos(theta_tr)
        y_tr = signals_veh["state"][1] - self.l_hitch * np.sin(theta_tr)
        return {
            "state": np.vstack([x_tr, y_tr, theta_tr, signals_veh["state"]]),
            "input": signals_veh["input"],
            "r1": np.vstack([tg_s, dtg_s]),
        }

    def state2pose(self, state):
        return np.r_[state[:3],
                     self.lead_veh.state2pose(np.asarray(state)[3:])]

    def ode(self, state, input):
        _, _, theta_tr, x_veh, y_veh, theta_veh = state
        V_veh = input[0]
        dtheta_tr = V_veh / self.l_hitch * np.sin(theta_veh - theta_tr)
        ode_veh = self.lead_veh.ode(np.r_[x_veh, y_veh, theta_veh], input)
        return np.r_[ode_veh[0] + self.l_hitch * np.sin(theta_tr) * dtheta_tr,
                     ode_veh[1] - self.l_hitch * np.cos(theta_tr) * dtheta_tr,
                     dtheta_tr, ode_veh]

"""Dubins vehicle (unicycle) with tangent-half-angle substitution
(counterpart of ``omg_tools_tpu.models.dubins``; omgtools
vehicles/dubins.py).  Model:
    dx = V cos(theta), dy = V sin(theta), dtheta = omega
with tg_ha = tan(theta/2) and v_til = V / (1 + tg_ha^2), so
    dx = v_til (1 - tg_ha^2),   dy = v_til (2 tg_ha)
-- all constraints stay polynomial in the decision splines (v_til, tg_ha).
Positions are recovered by exact spline integration (running_integral),
or, with the ``substitution`` option, by lifted position splines tied to
the velocities (a quadratic transcription).
"""

from __future__ import annotations

import numpy as np

from .base import Vehicle
from ..environment.shapes import Circle
from ..modeling.opti import BIG
from ..ops.spline import (BSpline, evalspline, running_integral,
                          sample_spline)

__all__ = ["Dubins"]


class Dubins(Vehicle):

    def __init__(self, shapes=None, options=None, bounds=None):
        bounds = bounds or {}
        options = options or {}
        degree = options.get("degree", 3)
        Vehicle.__init__(self, n_spl=2, degree=degree,
                         shapes=shapes if shapes is not None else Circle(0.1),
                         options=options)
        self.vmax = bounds.get("vmax", 0.5)
        self.amax = bounds.get("amax", 1.0)
        self.wmin = bounds.get("wmin", -np.pi / 6.0)
        self.wmax = bounds.get("wmax", np.pi / 6.0)

    def set_default_options(self):
        Vehicle.set_default_options(self)
        self.options["stop_tol"] = 1.0e-2

    def init(self):
        self.pos0 = self.define_parameter("pos0", 2)
        self._lift = None

    def integrate_once(self, dx, x0, t, T=1.0):
        """Exact spline antiderivative with x(t) = x0
        (omgtools dubins.py:262-268)."""
        dx_int = T * running_integral(dx)
        if isinstance(t, (int, float)):
            return dx_int - dx_int(np.asarray(float(t) / T)) + x0
        return dx_int - evalspline(dx_int, t / T) + x0

    def _positions(self, splines, horizon_time):
        if self._lift is not None:
            _, xs, ys = self._lift
            return xs, ys
        v_til, tg_ha = splines
        dx = v_til * (1 - tg_ha * tg_ha)
        dy = v_til * (2 * tg_ha)
        x = self.integrate_once(dx, self.pos0[0], self.problem_t,
                                horizon_time)
        y = self.integrate_once(dy, self.pos0[1], self.problem_t,
                                horizon_time)
        return x, y

    def define_trajectory_constraints(self, splines, horizon_time):
        v_til, tg_ha = splines
        dtg_ha = tg_ha.derivative()
        T = horizon_time
        if self.options.get("substitution"):
            # Full quadratic lift (an extension of omgtools'
            # substitution modes, dubins.py:92-115; omgtools lifts
            # dx, dy and its tie rows stay CUBIC in the decision splines).
            # Three auxiliaries make EVERY constraint row at most quadratic
            # with COEFFICIENTS free of the time parameter, so the batched
            # rollout's quadratic-structure detection, compact-arrow
            # factorization and fused kernel (K3) all apply:
            #   w  = tg_ha^2                    (exact quadratic tie)
            #   xs, ys: POSITION splines tied through their derivatives,
            #       xs' - T v_til (1 - w) in [-eps, eps]   (quadratic,
            #       t-free; the integral anchor that would make the
            #       quadratic weights time-dependent is replaced by the
            #       linear initial-condition row xs(t0) = pos0)
            #   V  = v_til (1 + w) <= vmax      (quadratic)
            # Position error vs the exact integral is bounded by eps
            # (unit horizon domain) -- the same tolerance-tie idea as the
            # non-exact substitution of omgtools (dubins.py:104-115).
            # Declaration order (xs, ys before w) keeps the arrow head
            # small: collision/terminal rows touch only the spline+xs+ys
            # span, and w becomes its own uncoupled tail block.
            from ..ops.basis import Basis
            d = self.degree
            interior = self.knots[d + 1:len(self.knots) - (d + 1)]
            # elevated-degree position splines: their derivative must
            # approximate the degree-3d product T*v_til(1-w) within the
            # eps tie corridor
            d_pos = d + int(self.options.get("substitution_degree_extra", 1))
            knots_pos = np.r_[np.zeros(d_pos + 1), interior,
                              np.ones(d_pos + 1)]
            basis_pos = Basis(knots_pos, d_pos)
            xs = self.define_spline_variable("xs_lift", 1,
                                             basis=basis_pos)[0]
            ys = self.define_spline_variable("ys_lift", 1,
                                             basis=basis_pos)[0]
            w2 = tg_ha * tg_ha
            w = self.define_spline_variable("w_lift", 1, basis=w2.basis)[0]
            self.define_constraint(w - w2, 0.0, 0.0)
            dx_q = v_til * (1.0 - w)
            dy_q = v_til * (2.0 * tg_ha)
            eps = self.options.get("substitution_eps", 5e-3)
            self.define_constraint(xs.derivative() - T * dx_q, -eps, eps)
            self.define_constraint(ys.derivative() - T * dy_q, -eps, eps)
            self._lift = (w, xs, ys)
            self.define_constraint(v_til + v_til * w - self.vmax, -BIG, 0.0)
        else:
            self._lift = None
            # velocity bound: V = v_til (1 + tg_ha^2) <= vmax; forward only
            self.define_constraint(v_til * (1 + tg_ha * tg_ha) - self.vmax,
                                   -BIG, 0.0)
        self.define_constraint(-v_til, -BIG, 0.0)
        # rotation-rate bounds: dtheta = 2 dtg_ha / (1 + tg_ha^2)
        self.define_constraint(2 * dtg_ha - (1 + tg_ha * tg_ha) * T * self.wmax,
                               -BIG, 0.0)
        self.define_constraint(-2 * dtg_ha + (1 + tg_ha * tg_ha) * T * self.wmin,
                               -BIG, 0.0)

    def get_initial_constraints(self, splines, horizon_time):
        v_til0 = self.define_parameter("v_til0", 1)
        tg_ha0 = self.define_parameter("tg_ha0", 1)
        dtg_ha0 = self.define_parameter("dtg_ha0", 1)
        v_til, tg_ha = splines
        con = [(v_til, v_til0[0]), (tg_ha, tg_ha0[0]),
               (tg_ha.derivative(), horizon_time * dtg_ha0[0])]
        if self._lift is not None:
            # the lifted position splines are anchored HERE (linear rows
            # at t0) instead of inside the integral transform, which would
            # make the quadratic tie weights time-dependent
            _, xs, ys = self._lift
            con += [(xs, self.pos0[0]), (ys, self.pos0[1])]
        return con

    def get_terminal_constraints(self, splines, horizon_time=None):
        horizon_time = horizon_time if horizon_time is not None \
            else self.problem_T
        posT = self.define_parameter("posT", 2)
        tg_haT = self.define_parameter("tg_haT", 1)
        v_til, tg_ha = splines
        x, y = self._positions(splines, horizon_time)
        term_con = [(x, posT[0]), (y, posT[1]), (tg_ha, tg_haT[0])]
        term_con_der = [(v_til, 0.0), (tg_ha.derivative(), 0.0)]
        return [term_con, term_con_der]

    def set_initial_conditions(self, state, input=None):
        input = np.zeros(2) if input is None else np.asarray(input)
        self.prediction["state"] = np.asarray(state, dtype=np.float64)
        self.prediction["input"] = np.asarray(input, dtype=np.float64)
        self.pose0 = np.asarray(state, dtype=np.float64)

    def set_terminal_conditions(self, pose):
        self.poseT = np.asarray(pose, dtype=np.float64)

    def get_init_spline_value(self, subgoals=None):
        """Initial guess for the (v_til, tg_ha) splines.  Single segment:
        ramp tg_ha between the known initial/terminal headings (omgtools
        dubins.py get_init_spline_value).  Multi-segment (scheduler /
        multiframe, subgoals = room-overlap centers): per-node headings
        from the chord directions (central difference at interior joints),
        ramped per segment -- the analog of Holonomic's waypoint interp."""
        n = len(self.basis)
        tg_ha0 = np.tan(self.prediction["state"][2] / 2.0)
        # frame goals may be position-only; fall back to the initial heading
        tg_haT = np.tan(self.poseT[2] / 2.0) if len(self.poseT) > 2 \
            else tg_ha0
        n_seg = getattr(self, "n_seg", 1)
        if n_seg == 1 or not subgoals:
            init = np.zeros((n, 2))
            init[:, 1] = np.linspace(tg_ha0, tg_haT, n)
            return [init] * n_seg if n_seg > 1 else [init]
        pts = ([np.asarray(self.prediction["state"][:2], dtype=np.float64)]
               + [np.asarray(s, dtype=np.float64)[:2] for s in subgoals]
               + [np.asarray(self.poseT[:2], dtype=np.float64)])
        m = len(pts) - 1          # number of segments
        node_tg = np.empty(m + 1)
        node_tg[0], node_tg[m] = tg_ha0, tg_haT
        for j in range(1, m):
            d = pts[j + 1] - pts[j - 1]
            node_tg[j] = np.tan(0.5 * np.arctan2(d[1], d[0])) \
                if np.linalg.norm(d) > 1e-9 else node_tg[j - 1]
        out = []
        for k in range(m):
            init = np.zeros((n, 2))
            init[:, 1] = np.linspace(node_tg[k], node_tg[k + 1], n)
            out.append(init)
        return out

    def check_terminal_conditions(self):
        tol = self.options["stop_tol"]
        return (np.linalg.norm(self.signals["state"][:, -1] - self.poseT)
                <= tol and
                np.linalg.norm(self.signals["input"][:, -1]) <= tol)

    def set_parameters(self, current_time):
        parameters = Vehicle.set_parameters(self, current_time)
        tg_ha0 = np.tan(self.prediction["state"][2] / 2.0)
        parameters[self]["tg_ha0"] = [tg_ha0]
        parameters[self]["v_til0"] = [
            self.prediction["input"][0] / (1 + tg_ha0 ** 2)]
        parameters[self]["dtg_ha0"] = [
            0.5 * self.prediction["input"][1] * (1 + tg_ha0 ** 2)]
        parameters[self]["pos0"] = self.prediction["state"][:2]
        parameters[self]["posT"] = self.poseT[:2]
        parameters[self]["tg_haT"] = [np.tan(self.poseT[2] / 2.0)]
        return parameters

    def define_collision_constraints(self, hyperplanes, room, splines,
                                     horizon_time):
        v_til, tg_ha = splines
        x, y = self._positions(splines, horizon_time)
        if isinstance(self.shapes[0], Circle):
            self.define_collision_constraints_2d(hyperplanes, room, [x, y],
                                                 horizon_time)
        else:
            self.define_collision_constraints_2d(hyperplanes, room, [x, y],
                                                 horizon_time, tg_ha=tg_ha)

    def splines2signals(self, splines, time):
        v_til, tg_ha = splines
        dtg_ha = tg_ha.derivative()
        dx = v_til * (1 - tg_ha * tg_ha)
        dy = v_til * (2 * tg_ha)
        if not self.signals:
            x0, y0 = self.pose0[0], self.pose0[1]
        else:
            x0, y0 = self.signals["state"][0, -1], self.signals["state"][1, -1]
        x = self.integrate_once(dx, x0, float(time[0]))
        y = self.integrate_once(dy, y0, float(time[0]))
        x_s = np.asarray(sample_spline(x, time))
        y_s = np.asarray(sample_spline(y, time))
        v_til_s = np.asarray(sample_spline(v_til, time))
        tg_s = np.asarray(sample_spline(tg_ha, time))
        dtg_s = np.asarray(sample_spline(dtg_ha, time))
        theta = 2 * np.arctan2(tg_s, 1.0)
        dtheta = 2 * dtg_s / (1 + tg_s ** 2)
        v_s = v_til_s * (1 + tg_s ** 2)
        return {
            "state": np.vstack([x_s, y_s, theta]),
            "input": np.vstack([v_s, dtheta]),
        }

    def state2pose(self, state):
        return np.asarray(state)

    def ode(self, state, input):
        v, w = input[0], input[1]
        return np.r_[v * np.cos(state[2]), v * np.sin(state[2]), w]

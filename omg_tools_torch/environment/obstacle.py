"""Obstacles: motion-prediction splines + collision constraints
(counterpart of ``omg_tools_tpu.environment.obstacle``).

- quadratic position prediction x0 + v t + 0.5 a t^2 encoded as a degree-2
  BSpline on the horizon-normalized basis [0,0,0,1,1,1] with the current
  time-offset correction;
- arbitrary spline trajectories via the ``spline_traj`` option;
- half-space constraints over shape checkpoints;
- plant simulation (host numpy): closed-form constant-acceleration
  propagation, a user's linear model x' = A x (+ B u), and scripted
  position/velocity/acceleration increments; the bounce predicates and
  drawing;
- rotating 2D obstacles: the cosine and sine of the yaw over the horizon
  as quadratic-NURBS circle arcs, the constraints multiplied through by
  the arc weight so that they stay polynomial.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..modeling.opti import OptiChild, BIG
from ..ops.basis import Basis
from ..ops.spline import BSpline, _const, circle_arc_coeffs

__all__ = ["Obstacle"]


class Obstacle(OptiChild):

    def __init__(self, initial, shape, simulation=None, options=None):
        OptiChild.__init__(self, "obstacle")
        self.shape = shape
        self.n_dim = shape.n_dim
        self.initial = initial
        self.simulation = simulation or {}
        self.set_default_options()
        self.set_options(options or {})
        self.basis = Basis(np.array([0.0, 0, 0, 1, 1, 1]), 2)
        self.cos, self.sin, self.gon_weight = None, None, 1.0
        self.prepare_simulation(initial, self.simulation)

    # -- options -----------------------------------------------------------
    def set_default_options(self):
        self.options = {
            "draw": True, "avoid": True, "bounce": False,
            "spline_traj": False,
            "spline_params": {"knots": [0, 0, 0, 1, 1, 1], "degree": 2,
                              "coeffs": None},
            # required when the obstacle rotates (the arcs need the
            # horizon's length)
            "horizon_time": None,
        }

    def set_options(self, options):
        self.options.update(options)

    # -- modeling ----------------------------------------------------------
    def init(self, horizon_times=None):
        """Declare parameters and build the position-prediction spline(s)."""
        checkpoints, _ = self.shape.get_checkpoints()
        if not self.options["spline_traj"]:
            x = self.define_parameter("x", self.n_dim)
            v = self.define_parameter("v", self.n_dim)
            a = self.define_parameter("a", self.n_dim)
            t = self.problem_t
            # state rewound to the horizon start (t is the elapsed time into
            # the current knot interval)
            v0 = v - t * a
            x0 = x - t * v0 - 0.5 * (t ** 2) * a
            if horizon_times is None:
                horizon_times = [self.problem_T]
            elif not isinstance(horizon_times, list):
                horizon_times = [horizon_times]
            pos0 = [x0[k] for k in range(self.n_dim)]
            for T in horizon_times:
                self.pos_spline = [
                    BSpline(self.basis, torch.stack([
                        pos0[k],
                        pos0[k] + 0.5 * v0[k] * T,
                        pos0[k] + v0[k] * T + 0.5 * a[k] * T ** 2]))
                    for k in range(self.n_dim)]
                pos0 = [self.pos_spline[k](1.0) for k in range(self.n_dim)]
        else:
            sp = self.options["spline_params"]
            traj_basis = Basis(np.asarray(sp["knots"], dtype=np.float64),
                               sp["degree"])
            coeffs = self.define_parameter(
                "traj_coeffs", (len(traj_basis), self.n_dim))
            self.pos_spline = [BSpline(traj_basis, coeffs[:, k])
                               for k in range(self.n_dim)]
        self.checkpoints_par = self.define_parameter(
            "checkpoints", (len(checkpoints), self.n_dim))
        self.rad_par = self.define_parameter("rad", len(checkpoints))
        self._init_rotation(horizon_times)

    def _init_rotation(self, horizon_times):
        """Rotating 2D obstacles: cos/sin of the yaw over the horizon as
        quadratic-NURBS circle arcs (numerators over the weight spline
        ``gon_weight``), from the parameter theta and the angular
        velocity."""
        omega = float(self.signals["angular_velocity"][0, -1])
        if omega == 0.0 or self.n_dim != 2:
            self.cos, self.sin, self.gon_weight = None, None, 1.0
            return
        T = self.options.get("horizon_time")
        if T is None:
            if isinstance(horizon_times, list) and horizon_times and \
                    isinstance(horizon_times[0], (int, float)):
                T = float(horizon_times[0])
            else:
                raise ValueError("rotating obstacles need a numeric "
                                 "'horizon_time' option")
        theta = self.define_parameter("theta", 1)
        theta0 = theta[0] - self.problem_t * omega
        # the arcs' coefficients are constants of theta's device and dtype
        basis, *cfs = circle_arc_coeffs(abs(omega) * T)
        cos_w, sin_w, weight = (BSpline(basis, _const(c, theta))
                                for c in cfs)
        sin_w = sin_w * float(np.sign(omega))
        self.cos = cos_w * torch.cos(theta0) - sin_w * torch.sin(theta0)
        self.sin = cos_w * torch.sin(theta0) + sin_w * torch.cos(theta0)
        self.gon_weight = weight

    def define_collision_constraints(self, hyperplanes):
        """Obstacle side of the separating hyperplane: each inflated
        checkpoint stays on the far side; a rotating obstacle's checkpoints
        turn with the arcs, the constraint multiplied through by their
        weight."""
        n_chck = self.checkpoints_par.shape[0]
        for hyp in hyperplanes:
            a, b = hyp["a"], hyp["b"]
            for l in range(n_chck):
                if self.cos is None:
                    pos = [self.pos_spline[k] + self.checkpoints_par[l, k]
                           for k in range(self.n_dim)]
                    con = -sum(a[k] * pos[k] for k in range(self.n_dim)) \
                        + b + self.rad_par[l]
                else:
                    w = self.gon_weight
                    cx, cy = self.checkpoints_par[l, 0], \
                        self.checkpoints_par[l, 1]
                    xpos = self.pos_spline[0] * w \
                        + cx * self.cos - cy * self.sin
                    ypos = self.pos_spline[1] * w \
                        + cx * self.sin + cy * self.cos
                    con = -(a[0] * xpos + a[1] * ypos) \
                        + w * (b + self.rad_par[l])
                self.define_constraint(con, -BIG, 0.0)

    def set_parameters(self, current_time):
        src = getattr(self, "source", None)
        if src is not None:
            # a slot of a scheduler's local problem pointed at a live
            # obstacle: the parameters are the live obstacle's
            return {self: src.set_parameters(current_time)[src]}
        parameters = {self: {}}
        if not self.options["spline_traj"]:
            parameters[self]["x"] = self.signals["position"][:, -1]
            parameters[self]["v"] = self.signals["velocity"][:, -1]
            parameters[self]["a"] = self.signals["acceleration"][:, -1]
        else:
            parameters[self]["traj_coeffs"] = \
                self.options["spline_params"]["coeffs"]
        checkpoints, rad = self.shape.get_checkpoints()
        parameters[self]["checkpoints"] = np.asarray(checkpoints)
        parameters[self]["rad"] = np.asarray(rad)
        if self.cos is not None:
            parameters[self]["theta"] = self.signals["orientation"][:, -1]
        return parameters

    # -- simulation --------------------------------------------------------
    def prepare_simulation(self, initial, simulation):
        self.signals: Dict[str, np.ndarray] = {"time": np.array([0.0])}
        for key in ("position", "velocity", "acceleration"):
            val = initial.get(key, np.zeros(self.n_dim))
            self.signals[key] = np.asarray(val, dtype=np.float64).reshape(
                self.n_dim, 1).copy()
        for key in ("orientation", "angular_velocity"):
            val = initial.get(key, 0.0)
            self.signals[key] = np.atleast_1d(
                np.asarray(val, dtype=np.float64)).reshape(-1, 1).copy()
        # custom linear simulation model x' = A x on the stacked
        # [position; velocity; acceleration] state (omgtools
        # environment.py 'model' simulation: e.g. the sinusoidal mover of
        # annoying_obstacle.py, simulated truthfully while the NLP keeps
        # its constant-acceleration prediction)
        self.sim_A = None
        self.sim_B = None
        self._sim_Phi = (None, None, None)  # (dt, expm(A dt), ZOH Gamma)
        model = simulation.get("model")
        if model is not None and model.get("A") is not None:
            self.sim_A = np.asarray(model["A"], dtype=np.float64)
            if model.get("B") is not None:
                self.sim_B = np.asarray(model["B"], dtype=np.float64)
        # forced input u(t): linearly interpolated between the given sample
        # points (omgtools ObstaclexD.ode integrates x' = A x + B u with
        # interp1d)
        self._input_traj = None
        traj_in = simulation.get("trajectories", {}).get("input")
        if traj_in is not None:
            vv = np.asarray(traj_in["values"], dtype=np.float64)
            if vv.ndim == 1:
                # flat series = scalar-input model (one value per sample
                # time), normalized to (n_times, n_inputs) like the
                # omgtools' vstack(...).T before interp1d
                vv = vv[:, None]
            self._input_traj = (
                np.asarray(traj_in["time"], dtype=np.float64), vv)
            if self.sim_B is None:
                raise ValueError(
                    "input trajectory given but simulation model has no 'B'")
        # user-scripted piecewise state increments: at the given times, the
        # corresponding quantity jumps by the given value
        self.increments = []
        for key, idx in (("position", 0), ("velocity", 1),
                         ("acceleration", 2)):
            traj = simulation.get("trajectories", {}).get(key)
            if traj is not None:
                for time, val in zip(traj["time"], traj["values"]):
                    if time != 0.0:
                        self.increments.append(
                            (float(time), idx,
                             np.asarray(val, dtype=np.float64)))
        self.increments.sort(key=lambda e: e[0])

    def set_state(self, dictionary):
        for key in ("position", "velocity", "acceleration"):
            if key in dictionary:
                self.signals[key] = np.asarray(
                    dictionary[key], dtype=np.float64).reshape(self.n_dim, 1)
            else:
                self.signals[key] = np.zeros((self.n_dim, 1))

    def simulate(self, simulation_time, sample_time):
        n_samp = int(np.round(simulation_time / sample_time, 6))
        t0 = self.signals["time"][-1]
        pos = self.signals["position"][:, -1].copy()
        vel = self.signals["velocity"][:, -1].copy()
        acc = self.signals["acceleration"][:, -1].copy()
        times, P, V, A = [], [], [], []
        t = t0
        for _ in range(n_samp):
            t_next = t + sample_time
            # apply scripted increments that fire in (t, t_next]
            for (ti, idx, val) in self.increments:
                if t < ti <= t_next:
                    if idx == 0:
                        pos += val
                    elif idx == 1:
                        vel += val
                    else:
                        acc += val
            if self.sim_A is not None:
                # exact discrete step of the user's linear model; with a B
                # matrix the ZOH input matrix Gamma = int_0^dt e^(As) ds B
                # comes from the augmented-matrix expm trick
                if self._sim_Phi[0] != sample_time:
                    from scipy.linalg import expm
                    nA = self.sim_A.shape[0]
                    if self.sim_B is not None:
                        nB = self.sim_B.shape[1]
                        Maug = np.zeros((nA + nB, nA + nB))
                        Maug[:nA, :nA] = self.sim_A * sample_time
                        Maug[:nA, nA:] = self.sim_B * sample_time
                        E = expm(Maug)
                        self._sim_Phi = (sample_time, E[:nA, :nA],
                                         E[:nA, nA:])
                    else:
                        self._sim_Phi = (sample_time,
                                         expm(self.sim_A * sample_time),
                                         None)
                _, Phi, Gamma = self._sim_Phi
                x = Phi @ np.concatenate([pos, vel, acc])
                if Gamma is not None:
                    tt, vv = (self._input_traj if self._input_traj is not None
                              else (np.zeros(1), np.zeros((1, Gamma.shape[1]))))
                    # linear interpolation of the input trajectory at time t,
                    # matching omgtools' interp1d over the stacked input
                    # series (ref obstacle.py:172-264); np.interp clamps to
                    # the end samples outside [tt[0], tt[-1]]
                    u = np.array([np.interp(t, tt, vv[:, j])
                                  for j in range(vv.shape[1])])
                    x = x + Gamma @ np.atleast_1d(u)
                n = self.n_dim
                pos, vel, acc = x[:n].copy(), x[n:2 * n].copy(), \
                    x[2 * n:].copy()
            else:
                pos = pos + vel * sample_time + 0.5 * acc * sample_time ** 2
                vel = vel + acc * sample_time
            t = t_next
            times.append(t)
            P.append(pos.copy())
            V.append(vel.copy())
            A.append(acc.copy())
        if n_samp:
            self.signals["time"] = np.r_[self.signals["time"], times]
            self.signals["position"] = np.c_[self.signals["position"],
                                             np.array(P).T]
            self.signals["velocity"] = np.c_[self.signals["velocity"],
                                             np.array(V).T]
            self.signals["acceleration"] = np.c_[self.signals["acceleration"],
                                                 np.array(A).T]
            omega = self.signals["angular_velocity"][:, -1]
            theta0 = self.signals["orientation"][:, -1]
            steps = np.arange(1, n_samp + 1) * sample_time
            self.signals["orientation"] = np.c_[
                self.signals["orientation"], theta0[:, None] + omega[:, None]
                * steps[None, :]]
            self.signals["angular_velocity"] = np.c_[
                self.signals["angular_velocity"],
                np.tile(omega[:, None], (1, n_samp))]

    # -- predicates for bouncing ------------------------------------------
    def overlaps_with(self, other) -> bool:
        from ..utils.geometry import (circle_polyhedron_intersect,
                                      rectangles_overlap)
        from .shapes import Circle, Rectangle
        p1 = self.signals["position"][:, -1]
        p2 = other.signals["position"][:, -1]
        s1, s2 = self.shape, other.shape
        if isinstance(s1, Circle) and isinstance(s2, Circle):
            return np.linalg.norm(p1 - p2) <= s1.radius + s2.radius
        if isinstance(s1, Circle) and isinstance(s2, Rectangle):
            return circle_polyhedron_intersect(p1, s1.radius,
                                               s2.vertices + p2[:, None])
        if isinstance(s1, Rectangle) and isinstance(s2, Circle):
            return circle_polyhedron_intersect(p2, s2.radius,
                                               s1.vertices + p1[:, None])
        if isinstance(s1, Rectangle) and isinstance(s2, Rectangle):
            return rectangles_overlap(p1, s1.width, s1.height,
                                      p2, s2.width, s2.height)
        return False

    def is_outside_of(self, room) -> bool:
        lims = room["shape"].get_canvas_limits()
        pos = self.signals["position"][:, -1]
        own = self.shape.get_canvas_limits()
        for k in range(self.n_dim):
            lo = lims[k][0] + room["position"][k]
            hi = lims[k][1] + room["position"][k]
            if pos[k] + own[k][0] < lo or pos[k] + own[k][1] > hi:
                return True
        return False

    def draw(self, t=-1):
        if not self.options["draw"]:
            return [], []
        pose = np.zeros(2 * self.n_dim)
        pose[:self.n_dim] = self.signals["position"][:, t]
        if self.n_dim == 2:
            pose[2] = self.signals["orientation"][0, t]
        return self.shape.draw(pose)

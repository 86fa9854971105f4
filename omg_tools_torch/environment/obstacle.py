"""Obstacles: motion-prediction splines + collision constraints
(counterpart of ``omg_tools_tpu.environment.obstacle``).

- quadratic position prediction x0 + v t + 0.5 a t^2 encoded as a degree-2
  BSpline on the horizon-normalized basis [0,0,0,1,1,1] with the current
  time-offset correction;
- arbitrary spline trajectories via the ``spline_traj`` option;
- half-space constraints over shape checkpoints.

Not ported yet: rotating obstacles (NURBS trig arcs) and the host plant
simulation / bounce / drawing of the deployment path.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..modeling.opti import OptiChild, BIG
from ..ops.basis import Basis
from ..ops.spline import BSpline

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
        self.signals: Dict[str, np.ndarray] = {"time": np.array([0.0])}
        for key in ("position", "velocity", "acceleration"):
            val = initial.get(key, np.zeros(self.n_dim))
            self.signals[key] = np.asarray(val, dtype=np.float64).reshape(
                self.n_dim, 1).copy()
        for key in ("orientation", "angular_velocity"):
            val = initial.get(key, 0.0)
            self.signals[key] = np.atleast_1d(
                np.asarray(val, dtype=np.float64)).reshape(-1, 1).copy()
        if float(self.signals["angular_velocity"][0, -1]) != 0.0:
            raise NotImplementedError(
                "rotating obstacles are not ported to omg_tools_torch yet")

    # -- options -----------------------------------------------------------
    def set_default_options(self):
        self.options = {
            "draw": True, "avoid": True, "bounce": False,
            "spline_traj": False,
            "spline_params": {"knots": [0, 0, 0, 1, 1, 1], "degree": 2,
                              "coeffs": None},
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

    def define_collision_constraints(self, hyperplanes):
        """Obstacle side of the separating hyperplane: each inflated
        checkpoint stays on the far side."""
        n_chck = self.checkpoints_par.shape[0]
        for hyp in hyperplanes:
            a, b = hyp["a"], hyp["b"]
            for l in range(n_chck):
                pos = [self.pos_spline[k] + self.checkpoints_par[l, k]
                       for k in range(self.n_dim)]
                con = -sum(a[k] * pos[k] for k in range(self.n_dim)) \
                    + b + self.rad_par[l]
                self.define_constraint(con, -BIG, 0.0)

    def set_parameters(self, current_time):
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
        return parameters

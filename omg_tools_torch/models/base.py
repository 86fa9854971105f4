"""Vehicle base class (counterpart of ``omg_tools_tpu.models.base``):
spline knot setup, spline decision variables and the 2D
separating-hyperplane + room collision constraints.

Not ported yet: plotting (the JAX class also derives from ``PlotLayer``),
3D collision constraints, and the host deployment methods (store,
predict, simulate, RK4 plant integration) that the simulator uses.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..modeling.opti import OptiChild, BIG
from ..ops.basis import Basis, clamped_knots
from ..ops.spline import definite_integral

__all__ = ["Vehicle"]


class Vehicle(OptiChild):

    def __init__(self, n_spl, degree, shapes, options=None):
        OptiChild.__init__(self, "vehicle")
        self.shapes = shapes if isinstance(shapes, list) else [shapes]
        self.n_dim = self.shapes[0].n_dim
        for s in self.shapes:
            if s.n_dim != self.n_dim:
                raise ValueError("all vehicle shapes must share one dimension")
        self.n_spl = n_spl
        self.degree = degree
        self.prediction: Dict[str, np.ndarray] = {}
        self.init_spline_values = None
        self.set_default_options()
        self.set_options(options or {})
        self.define_knots(knot_intervals=10)

    # -- options -----------------------------------------------------------
    def set_default_options(self):
        self.options = {
            "safety_distance": 0.0, "safety_weight": 10.0,
            "room_constraints": True, "stop_tol": 1.0e-3,
            "ideal_prediction": False, "ideal_update": False,
            "1storder_delay": False, "time_constant": 0.1,
            "input_disturbance": None,
        }

    def set_options(self, options):
        self.options.update(options)

    # -- spline setup --------------------------------------------------------
    def define_knots(self, knot_intervals=None, knots=None):
        if knot_intervals is not None:
            self.knot_intervals = knot_intervals
            self.knots = clamped_knots(knot_intervals, self.degree)
        if knots is not None:
            self.knots = np.asarray(knots, dtype=np.float64)
            self.knot_intervals = None
        self.basis = Basis(self.knots, self.degree)

    def define_splines(self, n_seg=1):
        self.n_seg = n_seg
        if self.init_spline_values is not None:
            init = self.init_spline_values
        else:
            try:
                init = self.get_init_spline_value()
            except (AttributeError, TypeError):
                init = [None] * n_seg
        if len(init) < n_seg:
            init = list(init) + [init[-1]] * (n_seg - len(init))
        self.splines = [
            self.define_spline_variable(f"splines_seg{k}", self.n_spl,
                                        value=init[k])
            for k in range(n_seg)]
        return self.splines

    def set_init_spline_values(self, values, n_seg=1):
        self.init_spline_values = list(values)

    # -- generic collision constraints ------------------------------------
    def define_collision_constraints_2d(self, hyperplanes, room, positions,
                                        horizon_time, tg_ha=0, offset=0):
        """Separating-hyperplane + room constraints on the position splines,
        polynomial in tg_ha = tan(theta/2) so rotated shapes stay spline-
        transcribable."""
        t = self.problem_t
        safety_distance = self.options["safety_distance"]
        safety_weight = self.options["safety_weight"]
        positions = [positions] if not isinstance(positions[0], list) \
            else positions
        for s, shape in enumerate(self.shapes):
            position = positions[s]
            checkpoints, rad = shape.get_checkpoints()
            checkpoints = [[float(c) for c in chck] for chck in checkpoints]
            rad = [float(r) for r in rad]
            if shape in hyperplanes:
                for k, hyp in enumerate(hyperplanes[shape]):
                    a, b = hyp["a"], hyp["b"]
                    sl = hyp.get("slack", 1)
                    if safety_distance > 0.0:
                        eps = self.define_spline_variable(f"eps_{s}{k}")[0]
                        self.define_objective(
                            safety_weight * definite_integral(
                                eps, t / horizon_time, 1.0))
                        self.define_constraint(eps - safety_distance, -BIG, 0.0)
                        self.define_constraint(-eps, -BIG, 0.0)
                    else:
                        eps = 0.0
                    for l, chck in enumerate(checkpoints):
                        con = (a[0] * chck[0] + a[1] * chck[1]) * (1.0 - tg_ha ** 2) \
                            + (-a[0] * chck[1] + a[1] * chck[0]) * (2 * tg_ha)
                        pos0 = position[0] * (1 + tg_ha ** 2) + offset * (1 - tg_ha ** 2)
                        pos1 = position[1] * (1 + tg_ha ** 2) + offset * (2 * tg_ha)
                        con = con + (a[0] * pos0 + a[1] * pos1)
                        con = con + (-b + sl * rad[l] + safety_distance - eps) \
                            * (1 + tg_ha ** 2)
                        self.define_constraint(con, -BIG, 0.0)
            if self.options["room_constraints"]:
                self._define_room_constraints_2d(room, position, checkpoints,
                                                 rad, tg_ha, offset)

    def _define_room_constraints_2d(self, room, position, checkpoints, rad,
                                    tg_ha, offset):
        from ..environment.shapes import Rectangle, Square, Circle
        if "lims_param" in room:
            # parameter room borders; axis-aligned only
            lo, hi = room["lims_param"]
            room_lims = [[lo[k], hi[k]] for k in range(self.n_dim)]
            for l, chck in enumerate(checkpoints):
                for k in range(self.n_dim):
                    self.define_constraint(
                        -(chck[k] + position[k]) + room_lims[k][0] + rad[0],
                        -BIG, 0.0)
                    self.define_constraint(
                        (chck[k] + position[k]) - room_lims[k][1] + rad[0],
                        -BIG, 0.0)
            return
        lims = room["shape"].get_canvas_limits()
        room_lims = [[float(v) for v in lims[k] + room["position"][k]]
                     for k in range(self.n_dim)]
        axis_aligned = (isinstance(room["shape"], (Rectangle, Square))
                        and room["shape"].orientation == 0.0
                        and isinstance(tg_ha, (int, float)) and tg_ha == 0.0)
        veh_ok = all(isinstance(s, Circle)
                     or (isinstance(s, (Rectangle, Square))
                         and s.orientation == 0.0) for s in self.shapes)
        if axis_aligned and veh_ok:
            for l, chck in enumerate(checkpoints):
                for k in range(self.n_dim):
                    self.define_constraint(
                        -(chck[k] + position[k]) + room_lims[k][0] + rad[0],
                        -BIG, 0.0)
                    self.define_constraint(
                        (chck[k] + position[k]) - room_lims[k][1] + rad[0],
                        -BIG, 0.0)
        else:
            hyp_room = room["shape"].get_hyperplanes(
                position=room["position"])
            for hpp in hyp_room.values():
                hpp["a"] = [float(v) for v in hpp["a"]]
                hpp["b"] = float(hpp["b"])
            for l, chck in enumerate(checkpoints):
                for hpp in hyp_room.values():
                    con = (hpp["a"][0] * chck[0] + hpp["a"][1] * chck[1]) \
                        * (1.0 - tg_ha ** 2) \
                        + (-hpp["a"][0] * chck[1] + hpp["a"][1] * chck[0]) \
                        * (2 * tg_ha)
                    pos0 = position[0] * (1 + tg_ha ** 2) + offset * (1 - tg_ha ** 2)
                    pos1 = position[1] * (1 + tg_ha ** 2) + offset * (2 * tg_ha)
                    con = con + (hpp["a"][0] * pos0 + hpp["a"][1] * pos1)
                    con = con + (-hpp["b"] + rad[l]) * (1 + tg_ha ** 2)
                    self.define_constraint(con, -BIG, 0.0)

    # -- hooks required from concrete vehicles -----------------------------
    def init(self):
        pass

    def set_parameters(self, current_time):
        return {self: {}}

    def define_trajectory_constraints(self, splines, horizon_time):
        raise NotImplementedError

    def get_initial_constraints(self, splines, horizon_time):
        raise NotImplementedError

    def get_terminal_constraints(self, splines, horizon_time=None):
        raise NotImplementedError

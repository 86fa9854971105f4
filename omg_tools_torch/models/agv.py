"""Rear-wheel-steered AGV, the Mercy TCST'17 model (counterpart of
``omg_tools_tpu.models.agv``; omgtools vehicles/agv.py).  Identical half-angle
machinery to the Bicycle but with the opposite steering relation
(dtheta = -V/L tan(delta)), so the steering-angle/rate constraints flip
sign; default shape is a rectangle footprint.
"""

from __future__ import annotations

import numpy as np

from .bicycle import Bicycle
from ..environment.shapes import Rectangle
from ..modeling.opti import BIG

__all__ = ["AGV"]


class AGV(Bicycle):

    def __init__(self, length=0.4, options=None, bounds=None):
        Bicycle.__init__(self, length=length, options=options, bounds=bounds)
        # omgtools' default footprint (agv.py:56)
        self.shapes = [Rectangle(width=0.8, height=0.2)]
        self.vmax = (bounds or {}).get("vmax", 0.5)

    def define_trajectory_constraints(self, splines, horizon_time):
        v_til, tg_ha = splines
        dv_til, dtg_ha = v_til.derivative(), tg_ha.derivative()
        ddtg_ha = tg_ha.derivative(2)
        T = horizon_time
        L = self.length
        one_tg2 = 1 + tg_ha * tg_ha
        one_tg2_sq = one_tg2 * one_tg2
        self.define_constraint(v_til * one_tg2 - self.vmax, -BIG, 0.0)
        self.define_constraint(
            dv_til * one_tg2 + 2 * v_til * tg_ha * dtg_ha - T * self.amax,
            -BIG, 0.0)
        # rear-wheel steering: tan(delta) = -2 dtg_ha L / (v (1+tg^2)^2)
        self.define_constraint(
            -2 * dtg_ha * L - v_til * one_tg2_sq * np.tan(self.dmax) * T,
            -BIG, 0.0)
        self.define_constraint(
            2 * dtg_ha * L + v_til * one_tg2_sq * np.tan(self.dmin) * T,
            -BIG, 0.0)
        num_d = (2 * L * ddtg_ha * (v_til * one_tg2_sq)
                 - 2 * L * dtg_ha * (dv_til * one_tg2_sq
                                     + v_til * (4 * tg_ha
                                                + 4 * tg_ha * tg_ha * tg_ha)
                                     * dtg_ha))
        den = ((T ** 2) * v_til * v_til * one_tg2_sq * one_tg2_sq
               + (2 * L * dtg_ha) * (2 * L * dtg_ha))
        self.define_constraint(-num_d - den * self.ddmax, -BIG, 0.0)
        self.define_constraint(num_d + den * self.ddmin, -BIG, 0.0)
        self.define_constraint(-v_til, -BIG, 0.0)

    def ode(self, state, input):
        v, dd = input[0], input[1]
        return np.r_[v * np.cos(state[2]), v * np.sin(state[2]),
                     -v / self.length * np.tan(state[3]), dd]

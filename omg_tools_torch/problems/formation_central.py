"""Centralized formation control: one NLP over the whole fleet
(counterpart of ``omg_tools_tpu.problems.formation_central``, after
omgtools problems/formation_central.py).  Each vehicle's perceived fleet
center (position splines + rel_pos_c) is equated with its neighbors' along
the interconnection graph; optional soft formation with slack splines
(``soft_formation``, bounded by ``max_formation_deviation``).
"""

from __future__ import annotations

import numpy as np

from .point2point import FixedTPoint2point
from ..modeling.opti import BIG
from ..ops.spline import definite_integral

__all__ = ["FormationPoint2pointCentral"]


class FormationPoint2pointCentral(FixedTPoint2point):

    def set_default_options(self):
        FixedTPoint2point.set_default_options(self)
        self.options["soft_formation"] = False
        self.options["soft_formation_weight"] = 10.0
        self.options["max_formation_deviation"] = np.inf

    def construct(self):
        config = self.fleet.configuration
        rel_pos_c = {}
        for veh in self.vehicles:
            ind_veh = sorted(config[veh].keys())
            rel_pos_c[veh] = veh.define_parameter("rel_pos_c", len(ind_veh))
        FixedTPoint2point.construct(self)
        centra = {}
        for veh in self.vehicles:
            ind_veh = sorted(config[veh].keys())
            splines = [veh.splines[0][k] for k in ind_veh]
            centra[veh] = veh.get_fleet_center(
                splines, [rel_pos_c[veh][i] for i in range(len(ind_veh))],
                substitute=False)
        # spanning set of pairwise center-equality constraints
        couples = {veh: [] for veh in self.vehicles}
        for veh in self.vehicles:
            for nghb in self.fleet.get_neighbors(veh):
                if veh not in couples[nghb] and nghb not in couples[veh]:
                    couples[veh].append(nghb)
        if self.fleet.interconnection == "circular" and self.fleet.N > 2:
            couples.pop(self.vehicles[-1], None)
            couples.pop(self.vehicles[-2], None)
        for veh, nghbs in couples.items():
            for nghb in nghbs:
                for c_v, c_n in zip(centra[veh], centra[nghb]):
                    if self.options["soft_formation"]:
                        weight = self.options["soft_formation_weight"]
                        eps = self.define_spline_variable(
                            f"eps_form_{veh.label}_{nghb.label}",
                            basis=veh.basis)[0]
                        self.define_objective(weight * definite_integral(
                            eps, self.t0, 1.0))
                        self.define_constraint(c_v - c_n - eps, -BIG, 0.0)
                        self.define_constraint(-c_v + c_n - eps, -BIG, 0.0)
                        max_dev = self.options["max_formation_deviation"]
                        if np.isfinite(max_dev):
                            self.define_constraint(eps, -abs(max_dev),
                                                   abs(max_dev))
                    else:
                        self.define_constraint(c_v - c_n, 0.0, 0.0)

    def set_parameters(self, current_time):
        parameters = FixedTPoint2point.set_parameters(self, current_time)
        for veh in self.vehicles:
            parameters.setdefault(veh, {})
            parameters[veh]["rel_pos_c"] = np.asarray(veh.rel_pos_c)
        return parameters

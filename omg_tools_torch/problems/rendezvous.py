"""Rendezvous: the fleet agrees on a meeting configuration by ADMM
(counterpart of ``omg_tools_tpu.problems.rendezvous``).

Each vehicle solves a ``FreeEndPoint2point`` whose terminal conditions
conT are decision variables; the shared quantity is conT + rel_pos_c (the
terminal fleet center the vehicle perceives), driven to consensus along
the fleet graph by the batched ADMM engine of ``problems.admm``.  The run
stops when the pairwise terminal mismatch falls below 5e-2.

The consensus runs on the host (numpy), as in the JAX package
(``device_loop_capable`` stays False); the x-updates run on the problem's
device through ``ADMMProblem._x_update``, on a CUDA card through K1.
"""

from __future__ import annotations

import numpy as np

from .admm import ADMMProblem
from .point2point import FreeEndPoint2point

__all__ = ["RendezVous"]


class _RdVLocal(FreeEndPoint2point):

    def __init__(self, fleet, environment, options, n_slots, rho, free_ind):
        self.n_slots = n_slots
        self.rho = rho
        FreeEndPoint2point.__init__(self, fleet, environment, options,
                                    free_ind=None)
        self._free_indices = free_ind

    def construct(self):
        veh = self.vehicles[0]
        self.free_ind = {veh: list(self._free_indices)}
        FreeEndPoint2point.construct(self)
        ind = self._free_indices
        rel_pos_c = veh.define_parameter("rel_pos_c", len(ind))
        # re-declaring conT0 is idempotent and returns the same block
        conT = self.define_variable("conT0", len(ind))
        self.n_sh = len(ind)
        s = conT + rel_pos_c
        z = self.define_parameter("admm_z", (self.n_slots, self.n_sh))
        lmbd = self.define_parameter("admm_l", (self.n_slots, self.n_sh))
        obj = 0.0
        for e in range(self.n_slots):
            diff = s - z[e]
            obj = obj + lmbd[e] @ diff + 0.5 * self.rho * (diff @ diff)
        self.define_objective(obj)


class RendezVous(ADMMProblem):

    def _make_template(self, vehicle):
        cfg = self.fleet.configuration[vehicle]
        free_ind = sorted(cfg.keys())
        tmpl = _RdVLocal(vehicle, self.environment.copy(), dict(self.options),
                         n_slots=self.n_slots, rho=self.rho,
                         free_ind=free_ind)
        tmpl.fleet_config_indices = free_ind
        return tmpl

    def _shared_selector(self, group):
        tr = group.template.transcription
        sl, _ = tr.var_slice(group.template, "conT0")
        return np.arange(sl.start, sl.stop)

    def _rel_offsets(self, i):
        return np.asarray(self.vehicles[i].rel_pos_c, dtype=np.float64)

    def _interconnection_rows(self):
        return np.zeros((0, self.n_sh))  # no equalities on the terminal z

    def stop_criterium(self, current_time, update_time):
        res = 0.0
        for i, veh in enumerate(self.vehicles):
            ind_veh = sorted(self.fleet.configuration[veh].keys())
            rel = self.fleet.get_rel_config(veh)
            for nghb in self.fleet.get_neighbors(veh):
                j = self.vehicles.index(nghb)
                ind_nghb = sorted(self.fleet.configuration[nghb].keys())
                for k, _ in enumerate(zip(ind_veh, ind_nghb)):
                    s_v = self._s_of_vehicle(i)[k] - self._rel_offsets(i)[k]
                    s_n = self._s_of_vehicle(j)[k] - self._rel_offsets(j)[k]
                    res += (s_v - s_n - rel[nghb][k]) ** 2
        return float(np.sqrt(res)) <= 5e-2

    def export(self, options=None):
        from ..export.export_rendezvous import ExportRendezVous
        return ExportRendezVous(self, options or {})

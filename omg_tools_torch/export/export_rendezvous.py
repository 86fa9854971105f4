"""Rendezvous export: the two-phase embedded ADMM runtime whose consensus
variable is the free terminal condition conT (counterpart of
``omg_tools_tpu.export.export_rendezvous``).

The local problem is a plain FreeEndPoint2point: its conT block is a
regular variable block, so the exported tensors carry it and ``S_idx``
selects it.  The z-projection and the shared knot shift are identities
(the terminal variables live outside the horizon)."""

from __future__ import annotations

import numpy as np

from .export_formation import ExportADMM

__all__ = ["ExportRendezVous"]


class ExportRendezVous(ExportADMM):

    def _local_problem(self):
        from ..problems.point2point import FreeEndPoint2point
        prob = self.problem
        veh = prob.vehicles[0]
        local = FreeEndPoint2point(veh, prob.environment.copy(),
                                   self._local_options(), free_ind=None)
        local.free_ind = {veh: list(prob.template._free_indices)}
        local.init()
        return local

    def _shared_selector(self, runner, local):
        sl, _ = runner.tr.var_slice(local, "conT0")
        return np.arange(sl.start, sl.stop)

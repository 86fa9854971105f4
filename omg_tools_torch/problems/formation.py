"""Distributed formation control via consensus ADMM (counterpart of
``omg_tools_tpu.problems.formation``).

Each vehicle's perceived fleet center (its position splines +
``rel_pos_c``) must agree with its neighbors'; the consensus runs through
the batched ADMM engine of ``problems.admm`` with per-edge shared
variables and terminal center-derivative stabilization in the
z-projection.  ``export`` writes the two-phase embedded C++ runtime
(``export.export_formation``).
"""

from __future__ import annotations

import numpy as np

from .admm import ADMMProblem

__all__ = ["FormationPoint2point"]


class FormationPoint2point(ADMMProblem):

    # the stock consensus path: a problem on a CUDA device takes the
    # device loop by default (options={'device_loop': False} keeps the
    # host loop)
    device_loop_capable = True

    def get_interaction_error(self):
        """Average deviation of each agent's perceived center from the true
        fleet center, integrated over the run (omgtools
        formation.py:74-106)."""
        pos_c, center_veh, rel_pos = [], [], []
        for veh in self.vehicles:
            state = veh.signals["state"][:veh.n_dim]
            rp = np.asarray(veh.rel_pos_c)
            pos_c.append(state + rp[:, None])
            center_veh.append(state)
            rel_pos.append(rp)
        n_samp = min(p.shape[1] for p in pos_c)
        pos_c = [p[:, :n_samp] for p in pos_c]
        center = np.mean([p for p in pos_c], axis=0)
        error = np.zeros(n_samp)
        for pc, rp in zip(pos_c, rel_pos):
            dev = center - pc
            error += np.linalg.norm(dev, axis=0) / max(np.linalg.norm(rp),
                                                       1e-9)
        error /= self.N
        Ts = float(self.vehicles[0].signals["time"][0, 1]
                   - self.vehicles[0].signals["time"][0, 0])
        end_time = float(self.vehicles[0].signals["time"][0, n_samp - 1])
        return float(np.trapezoid(error, dx=Ts) / max(end_time, 1e-9))

    def final(self):
        ADMMProblem.final(self)
        if self.options["verbose"] >= 1:
            err = self.get_interaction_error()
            print("%-18s %6g %%" % ("Formation error:", err * 100.0))

    def export(self, options=None):
        from ..export.export_formation import ExportFormation
        return ExportFormation(self, options or {})

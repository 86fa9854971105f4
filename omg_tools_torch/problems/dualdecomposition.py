"""Distributed consensus by dual decomposition (counterpart of
``omg_tools_tpu.problems.dualdecomposition``).

The dual-subgradient form of the consensus problem, on the batched
template machinery of ``problems.admm``:

    x-update:  x_i = argmin f_i(x) + (sum_j lam_ij - lam_ji)' s_i(x)
                     + prox_w/2 ||s_i(x) - s_i^prev||^2
    dual:      lam_ij += alpha * (s_i - s_j)      (edge subgradient step)

The aggregated multiplier mu_i = sum_j (lam_ij - lam_ji) is the only
quantity the local problem needs, so the template gets one extra parameter
block (and the proximal anchor another).  Communication is the same
vehicle-axis roll as the ADMM engine's.

The x-updates run through ``ADMMProblem._x_update`` on the problem's
device in its dtype (option ``dtype``, float64 by default), one batched
ALM solve a vehicle-type group, warm-started from the group's ALM state;
on a CUDA card every Newton step is a K1 launch.  ``_x_update`` caps a
float32 warm penalty at 10 before each resolve; a float64 run (the
default) keeps the carried penalty, as the JAX package's DD x-update does.
"""

from __future__ import annotations

import numpy as np
import torch

from .admm import ADMMProblem
from .point2point import FixedTPoint2point

__all__ = ["DDProblem", "FormationPoint2pointDualDecomposition"]


class _DDLocalP2P(FixedTPoint2point):
    """Local template: FixedT p2p + a linear dual term on the shared
    (fleet-center) coefficients, plus a proximal quadratic around the
    previous iterate.

    The proximal term makes plain dual (sub)gradient ascent usable: the
    p2p objective is nearly flat in the mid-horizon center coefficients,
    so the dual function has enormous curvature and any practical step
    overshoots.  Anchoring each local solve at its previous shared iterate
    bounds the primal movement per dual step (proximal dual ascent)."""

    prox_w = 1.0  # set by DDProblem before construct()

    def __init__(self, fleet, environment, options):
        FixedTPoint2point.__init__(self, fleet, environment, options)

    def construct(self):
        FixedTPoint2point.construct(self)
        veh = self.vehicles[0]
        ind_veh = getattr(self, "fleet_config_indices",
                          list(range(veh.n_dim)))
        rel_pos_c = veh.define_parameter("rel_pos_c", len(ind_veh))
        splines = [veh.splines[0][k] for k in ind_veh]
        center = veh.get_fleet_center(
            splines, [rel_pos_c[i] for i in range(len(ind_veh))],
            substitute=False)
        self.center_basis = center[0].basis
        self.n_sh = len(self.center_basis) * len(center)
        s = torch.cat([c.coeffs for c in center])
        mu = self.define_parameter("dd_mu", self.n_sh)
        prox = self.define_parameter("dd_prox", self.n_sh)
        self.define_objective(
            mu @ s + 0.5 * self.prox_w * torch.sum((s - prox) ** 2))


class DDProblem(ADMMProblem):
    """Dual decomposition on the circular fleet graph, batched."""

    def __init__(self, fleet, environment, options=None):
        options = dict(options or {})
        self.alpha = options.pop("alpha", 0.5)  # dual step size
        # Proximal weight: the dual gradient's Lipschitz constant is at
        # most sigma_max(edge difference)^2 / prox_w <= 4 / prox_w, so a
        # constant step alpha is stable for alpha < prox_w / 2; 8 alpha
        # leaves a 4x margin without over-damping the primal progress.
        self.prox_w = options.pop("prox", 8.0 * self.alpha)
        ADMMProblem.__init__(self, fleet, environment, options)

    def _make_template(self, vehicle):
        tmpl = _DDLocalP2P(vehicle, self.environment.copy(),
                           dict(self.options))
        tmpl.prox_w = self.prox_w
        cfg = self.fleet.configuration[vehicle]
        tmpl.fleet_config_indices = sorted(cfg.keys())
        return tmpl

    def _reset_dual_state(self):
        ADMMProblem._reset_dual_state(self)
        # per-directed-edge multipliers L[i, slot]; mu_i aggregates them.
        # Slot layout (circular graph): L[i, 0] = +lam_{edge i} (the edge
        # to the next vehicle), L[i, 1] = -lam_{edge i-1} (the mirror copy
        # of the edge to the previous one), so each vehicle holds what it
        # needs and mu_i = L[i, 0] + L[i, 1] = lam_i - lam_{i-1}.
        self.L = np.zeros((self.N, self.n_slots, self.n_sh))
        self.S_prev = np.stack([self._s_of_vehicle(i)
                                for i in range(self.N)])
        self._dd_iter = 0

    def _mu(self, i):
        """mu_i = d L / d s_i = the sum over incident edges of +/- lam_edge.

        Only vehicle i's own multiplier copies enter: pairing own and
        mirror copies (L[i,0] - L[nxt,1]) would count every lambda twice,
        since the mirror already carries the opposite sign."""
        if self.N == 2:
            return self.L[i, 0].copy()
        return self.L[i, 0] + self.L[i, 1]

    def _pack_params(self, group, current_time):
        tmpl = group.template
        tr = tmpl.transcription
        P = np.zeros((len(group.indices), tr.n_p))
        for row, i in enumerate(group.indices):
            veh = self.vehicles[i]
            values = {}
            vpars = veh.set_parameters(current_time)[veh]
            vpars["rel_pos_c"] = np.asarray(veh.rel_pos_c)
            values[tmpl.vehicles[0].label] = vpars
            for obs_t, obs in zip(tmpl.environment.obstacles,
                                  self.environment.obstacles):
                values[obs_t.label] = obs.set_parameters(current_time)[obs]
            ppars = tmpl.set_parameters(current_time)[tmpl]
            ppars["dd_mu"] = self._mu(i)
            ppars["dd_prox"] = self.S_prev[i]
            values[tmpl.label] = ppars
            P[row] = tr.pack_parameters(values)
        return P

    def init_step(self, current_time, update_time):
        ADMMProblem.init_step(self, current_time, update_time)
        # Re-anchor the proximal center at the (possibly knot-shifted)
        # current solutions, once per control period, and hold it fixed
        # across the period's dual iterations: with a fixed anchor the
        # local problems are strongly convex in s, the dual gradient is
        # Lipschitz with constant <= 4 / prox_w and constant-step ascent
        # converges monotonically; re-anchoring every iteration would make
        # it an undamped, oscillating primal-dual scheme.  The anchor biases
        # the converged primal towards the period's start by at most
        # (prox_w / m) ||s* - S_prev|| (m the local strong-convexity
        # modulus in s), which vanishes as the receding horizon converges.
        self.S_prev = np.stack([self._s_of_vehicle(i)
                                for i in range(self.N)])

    def dual_update(self, current_time):
        for group in self.groups:
            self._x_update(group, current_time)
        S = np.stack([self._s_of_vehicle(i) for i in range(self.N)])
        # the dual gradient step along each edge (communicate = roll).  A
        # constant step is stable because the proximal term bounds the
        # dual curvature (alpha < prox_w / 2); no diminishing schedule, so
        # the closed-loop coupling never vanishes.
        self._dd_iter += 1
        step = self.alpha
        if self.N == 2:
            diff = S[0] - S[1]
            self.L[0, 0] += step * diff
            self.L[1, 0] -= step * diff
            pri = float(np.max(np.abs(diff)))
        else:
            diff_next = S - np.roll(S, -1, axis=0)   # s_i - s_{i+1} (edge i)
            self.L[:, 0, :] += step * diff_next
            self.L[:, 1, :] -= step * np.roll(diff_next, 1, axis=0)
            pri = float(np.max(np.abs(diff_next)))
        self.residuals.append((pri, float("nan")))
        return pri, float("nan")


class FormationPoint2pointDualDecomposition(DDProblem):
    """Formation control by dual decomposition (omgtools
    formation_dualdec.py)."""

    def get_interaction_error(self):
        from .formation import FormationPoint2point
        return FormationPoint2point.get_interaction_error(self)

    def final(self):
        DDProblem.final(self)
        if self.options["verbose"] >= 1:
            err = self.get_interaction_error()
            print("%-18s %6g %%" % ("Formation error:", err * 100.0))

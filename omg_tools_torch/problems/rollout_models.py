"""Vehicle-specific recipes for the batched rollout (counterpart of
``omg_tools_tpu.problems.rollout_models``): which parameter blocks carry
the plant state, how the ideal plant update maps solved spline
coefficients to the next parameter vector, and the vectorized initial
guesses -- built from host-precomputed basis samplings, so the per-step
update is a few small matrix products on the batch.

Ported: ``HolonomicRollout``.  The quadrotor, holonomic-orient and Dubins
recipes are not ported yet; :func:`make_rollout_model` raises for them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_rollout_model", "HolonomicRollout"]


class _RolloutModel:
    """Shared plumbing: parameter-slice lookup + sampling matrices."""

    def __init__(self, runner):
        self.runner = runner
        self.vehicle = runner.vehicle
        self.tr = runner.tr
        spk = runner.steps_per_knot
        self.taus = np.arange(spk + 1) * runner.update_time / runner.horizon

    def idx(self, child, name):
        sl, shape = self.tr.par_slice(child, name)
        return np.arange(sl.start, sl.stop)

    def sample_rows(self, order):
        """(spk+1, n_c) rows evaluating the order-th derivative (in basis
        time) of a vehicle spline at the visited tau grid."""
        basis = self.vehicle.basis
        if order == 0:
            return basis.eval(self.taus)
        db, P = basis.derivative(order)
        return db.eval(self.taus) @ P

    # -- default hooks -------------------------------------------------------
    def init_guess(self, starts, goals, n_coef):
        """(B, n_coef, n_spl) straight-line spline guesses (host numpy)."""
        return (np.linspace(0, 1, n_coef)[None, :, None]
                * (goals - starts)[:, None, :] + starts[:, None, :])

    def path_points(self, starts, goals, g):
        """(B, len(g), n_dim) positions along the init path (hyperplane
        warm starts)."""
        return (np.asarray(g)[None, :, None] * (goals - starts)[:, None, :]
                + starts[:, None, :])

    def reset_guess(self, state, goal, n_coef, dtype):
        """(B, n_coef, n_spl) fresh straight-line guesses from the current
        states (B, n_spl) to the goals, for diverged scenarios."""
        w = torch.linspace(0.0, 1.0, n_coef, dtype=dtype,
                           device=state.device)
        return (state[:, None, :] * (1.0 - w[None, :, None])
                + goal[:, None, :] * w[None, :, None])


class HolonomicRollout(_RolloutModel):

    goal_param = "poseT"

    def __init__(self, runner):
        _RolloutModel.__init__(self, runner)
        veh = self.vehicle
        self.i_state0 = self.idx(veh, "state0")
        self.i_input0 = self.idx(veh, "input0")
        self.i_goal = self.idx(veh, self.goal_param)
        dev = dict(dtype=runner.dtype, device=runner.device)
        self.E0 = torch.as_tensor(self.sample_rows(0), **dev)
        self.E1 = torch.as_tensor(self.sample_rows(1), **dev)
        self._ix_state0 = torch.as_tensor(self.i_state0, device=runner.device)
        self._ix_input0 = torch.as_tensor(self.i_input0, device=runner.device)

    def varying_params(self):
        return [self.i_state0, self.i_input0, self.i_goal]

    def batch_params(self, p0, starts, goals):
        p0[:, self.i_state0] = starts
        p0[:, self.i_input0] = 0.0
        p0[:, self.i_goal] = goals
        return p0

    def update(self, p, cfs, row, horizon):
        """Ideal plant update of a batch: cfs (B, n_coef, n_spl) solved
        splines, ``row`` the host index of the next sample instant.
        Returns (p with the new state0/input0, state (B, n_spl))."""
        state = torch.einsum("c,bcs->bs", self.E0[row], cfs)
        inp = torch.einsum("c,bcs->bs", self.E1[row], cfs) / horizon
        p = p.clone()
        p[:, self._ix_state0] = state
        p[:, self._ix_input0] = inp
        return p, state


def make_rollout_model(runner):
    """Pick the recipe for the runner's vehicle by its parameter layout."""
    veh = runner.vehicle
    names = {name for (label, name) in runner.tr.layout.parameters
             if label == veh.label}
    if {"state0", "input0"} <= names:
        return HolonomicRollout(runner)
    raise NotImplementedError(
        f"no rollout recipe for {type(veh).__name__} in omg_tools_torch yet "
        f"(params: {sorted(names)})")

"""Vehicle-specific recipes for the batched rollout (counterpart of
``omg_tools_tpu.problems.rollout_models``): which parameter blocks carry
the plant state, how the ideal plant update maps solved spline
coefficients to the next parameter vector, and the vectorized initial
guesses -- built from host-precomputed basis samplings, product tensors
and interval integrals, so the per-step update is a few small matrix
products on the batch.

Models:
- ``HolonomicRollout``: state = position splines; params state0/input0.
- ``QuadrotorRollout``: planar Quadrotor, SimpleQuadrotor3D:
  spl0/dspl0/ddspl0 from the 0th/1st/2nd derivative rows.
- ``HolonomicOrientRollout``: pos0/vel0/tg_ha0/dtg_ha0.
- ``DubinsRollout``: decision splines (v_til, tg_ha); the plant position
  pos0 advances by the exact spline integral of dx = v_til (1 - tg_ha^2),
  dy = 2 v_til tg_ha over the step interval, through precomputed
  product tensors.

Vehicles without a recipe (Bicycle, AGV, Trailer, Tool in the JAX
package) raise in :func:`make_rollout_model`, as they do there.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_rollout_model", "HolonomicRollout", "QuadrotorRollout",
           "HolonomicOrientRollout", "DubinsRollout"]


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


def _index(runner, i):
    return torch.as_tensor(i, device=runner.device)


class QuadrotorRollout(_RolloutModel):
    """spl0/dspl0/ddspl0 parameter triplet (planar Quadrotor,
    SimpleQuadrotor3D)."""

    def __init__(self, runner, goal_param):
        _RolloutModel.__init__(self, runner)
        veh = self.vehicle
        self.goal_param = goal_param
        self.i_spl0 = self.idx(veh, "spl0")
        self.i_dspl0 = self.idx(veh, "dspl0")
        self.i_ddspl0 = self.idx(veh, "ddspl0")
        self.i_goal = self.idx(veh, goal_param)
        dev = dict(dtype=runner.dtype, device=runner.device)
        self.E0 = torch.as_tensor(self.sample_rows(0), **dev)
        self.E1 = torch.as_tensor(self.sample_rows(1), **dev)
        self.E2 = torch.as_tensor(self.sample_rows(2), **dev)
        self._ix = [_index(runner, i) for i in
                    (self.i_spl0, self.i_dspl0, self.i_ddspl0)]

    def varying_params(self):
        return [self.i_spl0, self.i_dspl0, self.i_ddspl0, self.i_goal]

    def batch_params(self, p0, starts, goals):
        p0[:, self.i_spl0] = starts
        p0[:, self.i_dspl0] = 0.0
        p0[:, self.i_ddspl0] = 0.0
        p0[:, self.i_goal] = goals
        return p0

    def update(self, p, cfs, row, horizon):
        pos = torch.einsum("c,bcs->bs", self.E0[row], cfs)
        vel = torch.einsum("c,bcs->bs", self.E1[row], cfs) / horizon
        acc = torch.einsum("c,bcs->bs", self.E2[row], cfs) / horizon ** 2
        p = p.clone()
        for ix, v in zip(self._ix, (pos, vel, acc)):
            p[:, ix] = v
        return p, pos


class HolonomicOrientRollout(_RolloutModel):
    """pos0/vel0/tg_ha0/dtg_ha0 parameter set (HolonomicOrient: x, y
    position splines + tangent-half-angle orientation spline; the
    derivative parameters enter T-scaled)."""

    def __init__(self, runner):
        _RolloutModel.__init__(self, runner)
        veh = self.vehicle
        self.i_state0 = self.idx(veh, "pos0")       # (2,) position
        self.i_vel0 = self.idx(veh, "vel0")
        self.i_tg0 = self.idx(veh, "tg_ha0")
        self.i_dtg0 = self.idx(veh, "dtg_ha0")
        self.i_goal = self.idx(veh, "posT")
        self.i_tgT = self.idx(veh, "tg_haT")
        dev = dict(dtype=runner.dtype, device=runner.device)
        self.E0 = torch.as_tensor(self.sample_rows(0), **dev)
        self.E1 = torch.as_tensor(self.sample_rows(1), **dev)
        self._ix = [_index(runner, i) for i in
                    (self.i_state0, self.i_vel0, self.i_tg0, self.i_dtg0)]

    def varying_params(self):
        return [self.i_state0, self.i_vel0, self.i_tg0, self.i_dtg0,
                self.i_goal]

    def batch_params(self, p0, starts, goals):
        p0[:, self.i_state0] = starts[:, :2]
        p0[:, self.i_vel0] = 0.0
        p0[:, self.i_goal] = goals[:, :2]
        return p0

    def update(self, p, cfs, row, horizon):
        pos = torch.einsum("c,bcs->bs", self.E0[row], cfs[:, :, :2])
        vel = torch.einsum("c,bcs->bs", self.E1[row], cfs[:, :, :2]) / horizon
        tg = cfs[:, :, 2] @ self.E0[row]
        dtg = cfs[:, :, 2] @ self.E1[row] / horizon
        p = p.clone()
        for ix, v in zip(self._ix, (pos, vel, tg[:, None], dtg[:, None])):
            p[:, ix] = v
        return p, pos


class DubinsRollout(_RolloutModel):
    """Splines (v_til, tg_ha); pos0 advances by the exact integral of the
    rationalized unicycle velocities over the step interval."""

    goal_param = "posT"

    def __init__(self, runner):
        _RolloutModel.__init__(self, runner)
        veh = self.vehicle
        self.i_vtil0 = self.idx(veh, "v_til0")
        self.i_tgha0 = self.idx(veh, "tg_ha0")
        self.i_dtgha0 = self.idx(veh, "dtg_ha0")
        self.i_pos0 = self.idx(veh, "pos0")
        self.i_goal = self.idx(veh, self.goal_param)
        self.i_tghaT = self.idx(veh, "tg_haT")
        basis = veh.basis
        dev = dict(dtype=runner.dtype, device=runner.device)
        self.E0 = torch.as_tensor(self.sample_rows(0), **dev)
        self.E1 = torch.as_tensor(self.sample_rows(1), **dev)
        # product tensors: P2 = basis*basis (v*tg), P3 = P2*basis (v*tg*tg)
        P2, W2 = basis.product_tensor(basis)
        P3, W32 = P2.product_tensor(basis)
        T_v3 = P3.transform(basis)                  # embed v_til into P3

        # interval integrals of P2/P3 splines over [tau_k, tau_k+1]: rows
        # r with  integral = r @ coeffs
        def interval_rows(pb):
            ib, L = pb.running_integral()
            E = ib.eval(self.taus) @ L              # (spk+1, n_p)
            return E[1:] - E[:-1]                   # (spk, n_p)
        self.W2 = torch.as_tensor(W2, **dev)
        self.W32 = torch.as_tensor(W32, **dev)
        self.T_v3 = torch.as_tensor(T_v3, **dev)
        self.R2 = torch.as_tensor(interval_rows(P2), **dev)   # dy rows
        self.R3 = torch.as_tensor(interval_rows(P3), **dev)   # dx rows
        self._ix_pos0, self._ix_vtil0, self._ix_tgha0, self._ix_dtgha0 = (
            _index(runner, i) for i in (self.i_pos0, self.i_vtil0,
                                        self.i_tgha0, self.i_dtgha0))

    def varying_params(self):
        return [self.i_vtil0, self.i_tgha0, self.i_dtgha0, self.i_pos0,
                self.i_goal, self.i_tghaT]

    def _vmax(self):
        return getattr(self.vehicle, "vmax", 0.5)

    def init_guess(self, starts, goals, n_coef):
        # v_til ramp toward vmax/2, tg_ha = heading of the straight path
        B = starts.shape[0]
        head = np.arctan2(goals[:, 1] - starts[:, 1],
                          goals[:, 0] - starts[:, 0])
        tg = np.tan(0.5 * head)
        guess = np.zeros((B, n_coef, 2))
        guess[:, :, 0] = 0.25 * self._vmax() / (1 + tg[:, None] ** 2)
        guess[:, :, 1] = tg[:, None]
        return guess

    def batch_params(self, p0, starts, goals):
        head = np.arctan2(goals[:, 1] - starts[:, 1],
                          goals[:, 0] - starts[:, 0])
        tg = np.tan(0.5 * head)
        p0[:, self.i_pos0] = starts
        p0[:, self.i_vtil0] = 0.0
        p0[:, self.i_tgha0] = tg[:, None]
        p0[:, self.i_dtgha0] = 0.0
        p0[:, self.i_goal] = goals
        p0[:, self.i_tghaT] = tg[:, None]
        return p0

    def reset_guess(self, state, goal, n_coef, dtype):
        d = goal - state
        tg = torch.tan(0.5 * torch.atan2(d[:, 1], d[:, 0]))
        ones = torch.ones((state.shape[0], n_coef), dtype=dtype,
                          device=state.device)
        col_v = ones * (0.25 * self._vmax()) / (1.0 + tg ** 2)[:, None]
        col_t = ones * tg[:, None]
        return torch.stack([col_v, col_t], dim=-1)

    def update(self, p, cfs, row, horizon):
        c_v, c_t = cfs[:, :, 0], cfs[:, :, 1]
        # spline values at the next sample instant
        v_til = c_v @ self.E0[row]
        tg_ha = c_t @ self.E0[row]
        dtg_ha = c_t @ self.E1[row] / horizon
        # exact step displacement: dx = v(1 - tg^2), dy = 2 v tg (in tau),
        # scaled by the horizon (omgtools dubins.py:262-268)
        c_vt = torch.einsum("qij,bi,bj->bq", self.W2, c_v, c_t)    # P2
        c_vtt = torch.einsum("qij,bi,bj->bq", self.W32, c_vt, c_t)  # P3
        c_dx = c_v @ self.T_v3.T - c_vtt
        dx = horizon * (c_dx @ self.R3[row - 1])
        dy = horizon * (2.0 * (c_vt @ self.R2[row - 1]))
        pos = p[:, self._ix_pos0] + torch.stack([dx, dy], dim=-1)
        p = p.clone()
        p[:, self._ix_pos0] = pos
        p[:, self._ix_vtil0] = v_til[:, None]
        p[:, self._ix_tgha0] = tg_ha[:, None]
        p[:, self._ix_dtgha0] = dtg_ha[:, None]
        return p, pos


def make_rollout_model(runner):
    """Pick the recipe for the runner's vehicle by its parameter layout."""
    veh = runner.vehicle
    names = {name for (label, name) in runner.tr.layout.parameters
             if label == veh.label}
    if {"state0", "input0"} <= names:
        return HolonomicRollout(runner)
    if {"v_til0", "tg_ha0", "pos0"} <= names:
        return DubinsRollout(runner)
    if {"pos0", "vel0", "tg_ha0", "dtg_ha0"} <= names:
        return HolonomicOrientRollout(runner)
    if {"spl0", "dspl0", "ddspl0"} <= names:
        goal = "poseT" if (veh.label, "poseT") in runner.tr.layout.parameters \
            else "positionT"
        return QuadrotorRollout(runner, goal)
    raise NotImplementedError(
        f"no rollout recipe for {type(veh).__name__} (params: "
        f"{sorted(names)})")

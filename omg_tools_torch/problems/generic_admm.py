"""Generic distributed constraint partitioning for the ADMM engine
(counterpart of ``omg_tools_tpu.problems.generic_admm``).

omgtools lets users define arbitrary interconnection constraints on a
DistributedProblem and splits them across the per-vehicle updaters by
symbol dependency (distributedproblem.py:26-33, 105-169), requiring the
coupling to be a linear equality in the shared copies (admm.py:313-354).
Here the user supplies

- ``shared_fn(problem, vehicle, splines) -> list of spline/tensor exprs``:
  the per-vehicle shared quantity the coupling constraints act on (the
  perceived fleet center, a terminal configuration, ...); anything the
  modeling layer expresses works;
- optionally ``edge_constraint(problem, veh_i, veh_j) -> (A, b)``: linear
  equality rows A [z_i; z_j] = b tying the two endpoint copies of an edge
  (default: consensus z_i = z_j).

The engine extracts the dependency structure by AD: on the local
transcription

    s_i(x, p) = G x + H p + s0        (checked affine at probe points),

found once by ``torch.func.jacfwd`` over the transcription's replay, on
the CPU in float64.  The x-update objective is built from the captured
expression, the communicated quantity is its affine image, and the
z-update is the closed-form projection onto the user's edge equalities.
The x-updates run on the problem's device through
``ADMMProblem._x_update``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from scipy.linalg import block_diag
from torch.func import jacfwd

from .admm import ADMMProblem
from .point2point import FixedTPoint2point
from ..ops.spline import BSpline
from ..ops.spline_jax import shiftfirstknot_T

__all__ = ["GenericADMMProblem"]


class _GenericLocal(FixedTPoint2point):
    """Local template whose ADMM penalty acts on a user-defined shared
    expression, captured at every replay of ``construct`` for the AD
    extraction of its affine map."""

    def __init__(self, fleet, environment, options, n_slots, rho, shared_fn,
                 ama=False):
        self.n_slots = n_slots
        self.rho = rho
        self.ama = ama
        self.shared_fn = shared_fn
        self.shared_capture = None
        self.shared_bases = None
        FixedTPoint2point.__init__(self, fleet, environment, options)

    def construct(self):
        FixedTPoint2point.construct(self)
        veh = self.vehicles[0]
        exprs = self.shared_fn(self, veh, veh.splines[0])
        parts, bases = [], []
        for expr in exprs:
            if isinstance(expr, BSpline):
                parts.append(expr.coeffs.reshape(-1))
                bases.append((expr.basis, 1))
            else:
                arr = torch.as_tensor(expr).reshape(-1)
                parts.append(arr)
                bases.append((None, int(arr.shape[0])))
        s = torch.cat(parts)
        self.shared_capture = s
        self.shared_bases = bases
        self.n_sh = int(s.shape[0])
        z = self.define_parameter("admm_z", (self.n_slots, self.n_sh))
        lmbd = self.define_parameter("admm_l", (self.n_slots, self.n_sh))
        # the future-piece transform of each spline-valued expression
        # (identity for the others): block-diagonal over the list
        tf_blocks, off = [], 0
        for basis, size in bases:
            n_b = size if basis is None else len(basis)
            tf_blocks.append((basis, off, n_b))
            off += n_b

        def tf_vec(vec):
            out = []
            for basis, o, n_b in tf_blocks:
                piece = vec[o:o + n_b]
                if basis is not None:
                    piece = shiftfirstknot_T(basis, self.t0) @ piece
                out.append(piece)
            return torch.cat(out)

        self._tf_blocks = tf_blocks
        s_t = tf_vec(s)
        obj = 0.0
        for e in range(self.n_slots):
            diff = s_t - tf_vec(z[e])
            obj = obj + tf_vec(lmbd[e]) @ diff
            if not self.ama:
                obj = obj + 0.5 * self.rho * (diff @ diff)
        self.define_objective(obj)


class GenericADMMProblem(ADMMProblem):
    """ADMM over a user-defined shared quantity with optional linear edge
    equalities: the generic path of which the hand-built formation and
    rendezvous templates are special cases."""

    def __init__(self, fleet, environment, shared_fn: Callable,
                 edge_constraint: Optional[Callable] = None, options=None):
        self.shared_fn = shared_fn
        self.edge_constraint = edge_constraint
        ADMMProblem.__init__(self, fleet, environment, options)

    # -- template -----------------------------------------------------------
    def _make_template(self, vehicle):
        tmpl = _GenericLocal(
            vehicle, self.environment.copy(), dict(self.options),
            n_slots=self.n_slots, rho=self.rho, shared_fn=self.shared_fn,
            ama=self.ama)
        cfg = self.fleet.configuration.get(vehicle)
        tmpl.fleet_config_indices = sorted(cfg.keys()) if cfg else None
        return tmpl

    # -- AD-based dependency extraction --------------------------------------
    def _shared_selector(self, group):
        """Extract the affine map s(x, p) = G x + H p + s0 of the captured
        shared expression (host AD in float64) and check its affineness at
        probe points (omgtools admm.py:313-354)."""
        tmpl = group.template
        tr = tmpl.transcription

        def shared_eval(x, p):
            tr._replay(x, p)
            return tmpl.shared_capture

        p_ref = torch.as_tensor(tmpl.pack_parameters(0.0),
                                dtype=torch.float64)
        zero = torch.zeros(tr.n_x, dtype=torch.float64)
        G = jacfwd(shared_eval)(zero, p_ref).numpy()
        H = jacfwd(shared_eval, argnums=1)(zero, p_ref).numpy()
        s_ref = shared_eval(zero, p_ref).numpy()
        s0 = s_ref - H @ p_ref.numpy()
        # the affineness probe
        rng = np.random.default_rng(0)
        x_pr = rng.standard_normal(tr.n_x) * 0.1
        p_pr = p_ref.numpy() + rng.standard_normal(tr.n_p) * 0.05
        direct = shared_eval(torch.as_tensor(x_pr),
                             torch.as_tensor(p_pr)).numpy()
        pred = G @ x_pr + H @ p_pr + s0
        if np.max(np.abs(pred - direct)) > 1e-6 * (
                np.max(np.abs(direct)) + 1.0):
            raise ValueError(
                "shared expression is not affine in (x, p); only "
                "linear-equality couplings can be distributed "
                "(omgtools admm.py:313-354)")
        group.G = G
        group.H = H
        group.s0 = s0
        return None   # no index selector: _s_of applies the affine map

    def _s_of(self, x, i):
        group = self.groups[self.group_of[i]]
        p_i = self._vehicle_params(group, i)
        return group.G @ x + group.H @ p_i + group.s0

    def _vehicle_params(self, group, i):
        tmpl = group.template
        tr = tmpl.transcription
        veh = self.vehicles[i]
        values: Dict = {}
        vpars = veh.set_parameters(0.0)[veh]
        if getattr(veh, "rel_pos_c", None) is not None:
            vpars["rel_pos_c"] = np.asarray(veh.rel_pos_c)
        values[tmpl.vehicles[0].label] = vpars
        return tr.pack_parameters(values)

    def _rel_offsets(self, i):
        return 0.0    # the offsets live inside H p (AD extracts them)

    # -- shared-coefficient transforms --------------------------------------
    def _blockdiag(self, per_basis):
        blocks = [np.eye(size) if basis is None else per_basis(basis)
                  for basis, size in self.template.shared_bases]
        return block_diag(*blocks)

    def _shared_shift(self):
        return self._blockdiag(lambda b: b.shiftoverknot_T())

    def _shared_transform(self, t0):
        if t0 <= 0.0:
            return None
        return self._blockdiag(lambda b: b.shiftfirstknot_T(float(t0)))

    # -- z-update: projection onto the user's edge equalities ---------------
    def _interconnection_rows(self):
        return np.zeros((0, self.n_sh))

    def dual_update(self, current_time):
        if self.edge_constraint is None:
            return ADMMProblem.dual_update(self, current_time)
        # edge-equality variant: the z-update of each edge solves
        #   min ||zi - ai||^2 + ||zj - aj||^2  s.t.  A [zi; zj] = b
        for group in self.groups:
            self._x_update(group, current_time)
        S = np.stack([self._s_of_vehicle(i) for i in range(self.N)])
        rho = self.rho
        Z_prev = self.Z.copy()
        n = self.n_sh
        pr2 = dr2 = 0.0
        # here Z has the shape (n_edges, 2, n_sh): the copies (z_i, z_j)
        # of each edge, reshaped at the first update
        if self.Z.shape != (self.n_edges, 2, n):
            self.Z = np.stack([np.stack([self.Z[e], self.Z[e]])
                               for e in range(self.n_edges)])
            self._Z_p = self.Z.copy()
            Z_prev = self.Z.copy()
        for e in range(self.n_edges):
            i, j = e, (e + 1) % self.N
            A, b = self.edge_constraint(self, self.vehicles[i],
                                        self.vehicles[j])
            a_i = S[i] + self.L[i, 0] / rho
            a_j = S[j] + self.L[j, 1 % self.n_slots] / rho
            a = np.concatenate([a_i, a_j])
            if A.shape[0]:
                lam = np.linalg.solve(A @ A.T, A @ a - b)
                z = a - A.T @ lam
            else:
                z = a
            self.Z[e, 0], self.Z[e, 1] = z[:n], z[n:]
            self.L[i, 0] += rho * (S[i] - self.Z[e, 0])
            self.L[j, 1 % self.n_slots] += rho * (S[j] - self.Z[e, 1])
            pr2 += float(np.sum((S[i] - self.Z[e, 0]) ** 2)
                         + np.sum((S[j] - self.Z[e, 1]) ** 2))
            dr2 += rho * float(np.sum((self.Z[e] - Z_prev[e]) ** 2))
        pri_res, dual_res = np.sqrt(pr2), np.sqrt(dr2)
        if self.nesterov:
            self._accelerate(rho * pr2 + dr2)
        self.residuals.append((pri_res, dual_res))
        return pri_res, dual_res

    def _pack_params(self, group, current_time):
        # edge-equality mode: each vehicle's z slots are its own copies
        if self.edge_constraint is None or \
                self.Z.shape == (self.n_edges, self.n_sh):
            return ADMMProblem._pack_params(self, group, current_time)
        tmpl = group.template
        tr = tmpl.transcription
        P = np.zeros((len(group.indices), tr.n_p))
        for row, i in enumerate(group.indices):
            veh = self.vehicles[i]
            values: Dict = {}
            vpars = veh.set_parameters(current_time)[veh]
            if getattr(veh, "rel_pos_c", None) is not None:
                vpars["rel_pos_c"] = np.asarray(veh.rel_pos_c)
            values[tmpl.vehicles[0].label] = vpars
            for obs_t, obs in zip(tmpl.environment.obstacles,
                                  self.environment.obstacles):
                values[obs_t.label] = obs.set_parameters(current_time)[obs]
            ppars = tmpl.set_parameters(current_time)[tmpl]
            zrows = np.zeros((self.n_slots, self.n_sh))
            for k, e in enumerate(self._slot_edges(i)):
                zrows[k] = self.Z[e, 0 if e == i else 1]
            ppars["admm_z"] = zrows
            ppars["admm_l"] = self.L[i]
            values[tmpl.label] = ppars
            P[row] = tr.pack_parameters(values)
        return P

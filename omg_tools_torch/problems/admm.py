"""Distributed consensus ADMM over the fleet graph (counterpart of
``omg_tools_tpu.problems.admm``).

One local-problem template is transcribed per vehicle type and the
x-updates of all vehicles of a type run as one batched ALM solve; the
z-update is a closed-form projection; communication along the circular
graph is an index roll over the vehicle axis, along the full graph a mean.

Algorithm (per control period, omgtools admm.py:584-628), with the
consensus algebra in the future-piece coordinates s~ = (I (x) T(t0)) s,
T(t0) the first-knot shift transform (``ops.spline_jax``):

    1. x-update:   x_i = argmin f_i(x) + sum_e lam~_ie'(s~_i(x) - z~_e)
                                 + rho/2 ||s~_i(x) - z~_e||^2
       (the AMA option drops the quadratic term);
    2. communicate s_i along the edges (roll / mean);
    3. z-update:   z~_e = P~ [ (s~_i + lam~_ie/rho + s~_j + lam~_je/rho)/2 ]
       with P~ the projection onto the interconnection equalities in
       transformed coordinates; z = T(t0)^-1 z~ is stored;
    4. lam-update in original coordinates: lam_ie += rho (s_i - z_e);
       residuals in transformed coordinates;
    5. optional Nesterov acceleration with restart on the combined
       residual.

``initialize`` runs ``init_iter`` (default 5) dual updates before motion
starts; then ``max_iter_per_update`` (default 1) iterations interleave
with the plant.

The x-updates run on the problem's device (option ``device``: None is
CUDA) in its dtype.  With ``device_loop="auto"`` (the default) a problem on
a CUDA device routes its dual updates through ``parallel.FleetRunner``,
with the consensus on the device; on the CPU the host (numpy) consensus
runs.
"""

from __future__ import annotations

import time as _time
from typing import Dict, List

import numpy as np
import torch

from .batch import resolve_device
from .point2point import FixedTPoint2point
from .problem import Problem
from ..ops.spline_jax import shiftfirstknot_T

__all__ = ["ADMMProblem", "DistributedProblem"]


class _ADMMLocalP2P(FixedTPoint2point):
    """Local-problem template: FixedT p2p + ADMM augmented objective on the
    shared (fleet-center) coefficients, penalizing only the future piece of
    the horizon (omgtools admm.py:63-115)."""

    def __init__(self, fleet, environment, options, n_slots, rho, ama=False):
        self.n_slots = n_slots
        self.rho = rho
        self.ama = ama
        FixedTPoint2point.__init__(self, fleet, environment, options)

    def construct(self):
        FixedTPoint2point.construct(self)
        veh = self.vehicles[0]
        config = getattr(self, "fleet_config_indices", None)
        ind_veh = config if config is not None \
            else list(range(veh.n_dim))
        rel_pos_c = veh.define_parameter("rel_pos_c", len(ind_veh))
        splines = [veh.splines[0][k] for k in ind_veh]
        center = veh.get_fleet_center(
            splines, [rel_pos_c[i] for i in range(len(ind_veh))],
            substitute=False)
        self.center_basis = center[0].basis
        n_c = len(self.center_basis)
        dims = len(center)
        self.n_sh = n_c * dims
        s = torch.stack([c.coeffs for c in center])          # (dims, n_c)
        z = self.define_parameter("admm_z", (self.n_slots, self.n_sh))
        lmbd = self.define_parameter("admm_l", (self.n_slots, self.n_sh))
        # future-piece transform: T(t0) with t0 = t/T the elapsed fraction
        # of the current knot interval (identity at t0 = 0)
        Tt = shiftfirstknot_T(self.center_basis, self.t0)   # (n_c, n_c)
        s_t = (s @ Tt.T).reshape(-1)                        # (n_sh,)
        z_t = torch.einsum("ab,edb->eda", Tt,
                           z.reshape(self.n_slots, dims, n_c)
                           ).reshape(self.n_slots, self.n_sh)
        l_t = torch.einsum("ab,edb->eda", Tt,
                           lmbd.reshape(self.n_slots, dims, n_c)
                           ).reshape(self.n_slots, self.n_sh)
        obj = 0.0
        for e in range(self.n_slots):
            diff = s_t - z_t[e]
            obj = obj + l_t[e] @ diff
            if not self.ama:
                obj = obj + 0.5 * self.rho * (diff @ diff)
        self.define_objective(obj)


class _Group:
    """Vehicles sharing one local-problem template (omgtools'
    separate_per_build dedup, distributedproblem.py:88-103)."""

    __slots__ = ("indices", "template", "S_idx", "x_shift", "lb", "ub",
                 "X", "alm_state", "G", "H", "s0")

    def __init__(self, indices):
        self.indices = indices
        self.alm_state = None


def _build_key(vehicle):
    basis = getattr(vehicle, "basis", None)
    bkey = (len(basis), basis.degree) if basis is not None else None
    return (type(vehicle).__name__, vehicle.n_dim, bkey)


class DistributedProblem(Problem):
    """Base for multi-updater problems: owns the fleet, fans the lifecycle
    out to vehicles (omgtools distributedproblem.py:36+)."""

    def __init__(self, fleet, environment, options=None, label="distributed"):
        Problem.__init__(self, fleet, environment, options, label=label)

    def stop_criterium(self, current_time, update_time):
        return all(v.check_terminal_conditions() for v in self.vehicles)


class ADMMProblem(DistributedProblem):

    # subclasses whose dual_update runs through the stock consensus path
    # (formation centers) can take the device loop
    device_loop_capable = False

    def __init__(self, fleet, environment, options=None):
        options = dict(options or {})
        self.rho = options.pop("rho", 2.0)
        # 'auto': the device consensus loop whenever the problem's device
        # is a CUDA device; True forces it on, False keeps the host loop
        self.device_loop = options.pop("device_loop", "auto")
        self.init_iter = options.pop("init_iter", 5)
        self.max_iter_per_update = options.pop("max_iter_per_update", 1)
        # Nesterov/AMA options (omgtools admm.py:568-571)
        self.nesterov = options.pop("nesterov_acceleration", False)
        self.eta = options.pop("eta", 0.999)
        self.nesterov_reset = options.pop("nesterov_reset", False)
        self.ama = options.pop("AMA", False)
        DistributedProblem.__init__(self, fleet, environment, options,
                                    label="admm")
        self.N = self.fleet.N
        graph = self.fleet.interconnection
        if graph == "full" and self.N > 2:
            # full graph = global-average consensus: one shared variable,
            # updated by a mean over all vehicles
            self.n_slots = 1
            self.n_edges = 1
        elif self.N > 2:
            self.n_slots = 2
            self.n_edges = self.N
        else:
            self.n_slots = 1
            self.n_edges = 1
        self.graph = graph

    # -- subclass hooks (defaults = formation-center consensus) ------------
    def _make_template(self, vehicle):
        tmpl = _ADMMLocalP2P(
            vehicle, self.environment.copy(), dict(self.options),
            n_slots=self.n_slots, rho=self.rho, ama=self.ama)
        cfg = self.fleet.configuration[vehicle]
        tmpl.fleet_config_indices = sorted(cfg.keys())
        return tmpl

    def _shared_selector(self, group):
        """Indices of the shared coefficients within the local x."""
        tmpl, tr = group.template, group.template.transcription
        sl, shape = tr.var_slice(tmpl.vehicles[0], "splines_seg0")
        n_c, n_spl = shape
        idx = np.arange(sl.start, sl.stop).reshape(n_c, n_spl)
        ind = tmpl.fleet_config_indices
        return np.concatenate([idx[:, k] for k in ind])

    def _interconnection_rows(self):
        """Rows A with A z = 0 the interconnection equalities imposed on z
        (terminal center-derivative stabilization, omgtools
        formation.py:59-65), in original coordinates."""
        tmpl = self.template
        basis = tmpl.center_basis
        ind = tmpl.fleet_config_indices
        rows = []
        for d in range(1, basis.degree + 1):
            Bd, P = basis.derivative(d)
            end_row = Bd.eval(np.array([basis.domain[1]]))[0] @ P
            rows.append(end_row)
        A1 = np.vstack(rows)                       # (deg, n_c)
        return np.kron(np.eye(len(ind)), A1)       # (deg*dims, n_sh)

    def _shared_transform(self, t0):
        """(n_sh, n_sh) future-piece transform of the shared coefficients at
        elapsed knot fraction t0, or None at t0 = 0."""
        tmpl = self.template
        basis = getattr(tmpl, "center_basis", None)
        if basis is None or t0 <= 0.0:
            return None
        Tc = basis.shiftfirstknot_T(float(t0))
        dims = self.n_sh // len(basis)
        return np.kron(np.eye(dims), Tc)

    def _shared_shift(self):
        """Knot-passage shift for the shared coefficients."""
        tmpl = self.template
        basis = getattr(tmpl, "center_basis", None)
        if basis is None:
            return np.eye(self.n_sh)
        Tc = basis.shiftoverknot_T()
        return np.kron(np.eye(len(tmpl.fleet_config_indices)), Tc)

    # -- build -------------------------------------------------------------
    def init(self):
        self.device = resolve_device(self.options.get("device"))
        self.dtype = getattr(torch, self.options["dtype"])
        # group vehicles by build key (heterogeneous fleets: one template
        # per type, omgtools distributedproblem.py:88-103)
        keys = [_build_key(v) for v in self.vehicles]
        group_map: Dict = {}
        for i, key in enumerate(keys):
            group_map.setdefault(key, []).append(i)
        self.groups: List[_Group] = []
        self.group_of = np.zeros(self.N, dtype=int)
        for key, indices in group_map.items():
            group = _Group(indices)
            group.template = self._make_template(self.vehicles[indices[0]])
            group.template.set_options({"verbose": 0})
            group.template.init()
            for i in indices:
                self.group_of[i] = len(self.groups)
            self.groups.append(group)
        # the "canonical" template (the z-projection structure must agree
        # across groups: the same shared-variable dimension)
        self.template = self.groups[0].template
        self.n_sh = self.template.n_sh
        for group in self.groups:
            if group.template.n_sh != self.n_sh:
                raise ValueError(
                    "heterogeneous fleet groups must share the consensus "
                    f"dimension: {group.template.n_sh} vs {self.n_sh}")
            tr = group.template.transcription
            group.S_idx = self._shared_selector(group)
            group.x_shift = tr.spline_shift_matrix(
                lambda b: b.shiftoverknot_T())
            group.X = np.tile(tr.initial_guess()[None, :],
                              (len(group.indices), 1))
            for row, i in enumerate(group.indices):
                init = self._init_guess_for(group, self.vehicles[i])
                if init is not None:
                    group.X[row] = init
            group.lb, group.ub = tr.bounds(0.0)
        self.A_z = self._interconnection_rows()
        self._proj_cache: Dict = {}
        self._sh_shift = self._shared_shift()

        self._reset_dual_state()
        self.update_times = []
        self._runner = None
        if self.device_loop is True:
            self.enable_device_loop()
        elif (self.device_loop == "auto" and self.device_loop_capable
                and self.device.type == "cuda"):
            try:
                self.enable_device_loop()
            except NotImplementedError:
                # no rollout recipe for this vehicle type: host loop
                if self.options["verbose"] >= 1:
                    print("[admm] device loop unavailable for this fleet; "
                          "using the host consensus path")
        if self.options["verbose"] >= 1:
            sizes = ", ".join(
                f"{len(g.indices)}x(n_x={g.template.transcription.n_x})"
                for g in self.groups)
            print(f"[admm] groups: {sizes} N={self.N} n_sh={self.n_sh} "
                  f"graph={self.graph}")

    def _reset_dual_state(self):
        """(Re)set the fleet-level consensus state from the groups' current
        primal iterates: z at neighborhood means, multipliers at zero,
        fresh Nesterov/residual bookkeeping."""
        S0 = np.stack([self._s_of_vehicle(i) for i in range(self.N)])
        self.Z = np.zeros((self.n_edges, self.n_sh))
        for e in range(self.n_edges):
            if self.graph == "full" or self.N == 2:
                self.Z[e] = S0.mean(axis=0)
            else:
                i, j = e, (e + 1) % self.N
                self.Z[e] = 0.5 * (S0[i] + S0[j])
        self.L = np.zeros((self.N, self.n_slots, self.n_sh))
        self.residuals: List = []
        # Nesterov state
        self._alpha = 1.0
        self._c_res_p = None
        self._Z_p = self.Z.copy()
        self._L_p = self.L.copy()
        self.iteration = 0

    def reinitialize(self, father=None):
        """Reset every updater's warm start to a fresh init guess for the
        current conditions and clear the consensus state (omgtools
        distributedproblem.py:188-241 + problem.py:165-181)."""
        for group in self.groups:
            tr = group.template.transcription
            tr.relayout()
            group.X = np.tile(tr.initial_guess()[None, :],
                              (len(group.indices), 1))
            for row, i in enumerate(group.indices):
                init = self._init_guess_for(group, self.vehicles[i])
                if init is not None:
                    group.X[row] = init
            group.alm_state = None
        self._reset_dual_state()
        if self._runner is not None:
            self._device_carry = None   # drop the stale device warm state
        self._device_reset = False

    def _init_guess_for(self, group, veh):
        try:
            init = veh.get_init_spline_value()
        except AttributeError:
            return None
        tr = group.template.transcription
        x = tr.initial_guess().copy()
        sl, shape = tr.var_slice(group.template.vehicles[0], "splines_seg0")
        x[sl] = np.asarray(init[0]).reshape(-1)
        return x

    def _rel_offsets(self, i):
        """Per-coefficient shared offset r_i (rel_pos_c broadcast)."""
        veh = self.vehicles[i]
        group = self.groups[self.group_of[i]]
        n_c = len(group.template.center_basis)
        return np.concatenate([np.full(n_c, rp) for rp in veh.rel_pos_c])

    def _s_of(self, x, i):
        group = self.groups[self.group_of[i]]
        return x[group.S_idx] + self._rel_offsets(i)

    def _s_of_vehicle(self, i):
        group = self.groups[self.group_of[i]]
        row = group.indices.index(i)
        return self._s_of(group.X[row], i)

    # -- parameter packing -------------------------------------------------
    def _pack_params(self, group, current_time):
        tmpl = group.template
        tr = tmpl.transcription
        P = np.zeros((len(group.indices), tr.n_p))
        for row, i in enumerate(group.indices):
            veh = self.vehicles[i]
            values: Dict = {}
            vpars = veh.set_parameters(current_time)[veh]
            vpars["rel_pos_c"] = np.asarray(veh.rel_pos_c)
            values[tmpl.vehicles[0].label] = vpars
            for obs_t, obs in zip(tmpl.environment.obstacles,
                                  self.environment.obstacles):
                values[obs_t.label] = obs.set_parameters(current_time)[obs]
            ppars = tmpl.set_parameters(current_time)[tmpl]
            slots = self._slot_edges(i)
            ppars["admm_z"] = self.Z[slots]
            ppars["admm_l"] = self.L[i]
            values[tmpl.label] = ppars
            P[row] = tr.pack_parameters(values)
        return P

    def _slot_edges(self, i):
        """Edge indices for vehicle i's slots."""
        if self.n_edges == 1:
            return np.array([0])
        return np.array([i, (i - 1) % self.N])

    def _projection_for(self, Tf):
        """Projection onto the interconnection equalities in transformed
        coordinates: A z = 0 becomes (A Tf^-1) z~ = 0."""
        key = None if Tf is None else id(Tf)
        if key in self._proj_cache:
            return self._proj_cache[key]
        A = self.A_z
        if A.shape[0] == 0:
            proj = np.eye(self.n_sh)
        else:
            At = A if Tf is None else A @ np.linalg.inv(Tf)
            AAt = At @ At.T
            proj = np.eye(self.n_sh) - At.T @ np.linalg.solve(AAt, At)
        self._proj_cache[key] = proj
        return proj

    @property
    def z_proj(self):
        """Projection onto the interconnection equalities in original
        coordinates (t0 = 0)."""
        return self._projection_for(None)

    # -- device loop --------------------------------------------------------
    def enable_device_loop(self, dtype=None, update_time=0.1,
                           outer_iter: int = 2):
        """Route dual updates through the device consensus loop
        (``parallel.FleetRunner``): x-updates, future-piece transform,
        z-projection, lambda updates and residuals stay on the problem's
        device.  Call after init()."""
        from ..parallel.fleet_runner import FleetRunner
        self._runner = FleetRunner(self, dtype=dtype or self.dtype,
                                   update_time=update_time,
                                   outer_iter=outer_iter,
                                   device=self.device)
        self._device_carry = None
        self._device_reset = False

    def _device_dual_update(self, current_time):
        """One consensus iteration through the device loop: the host
        refreshes the parameters (vehicle predictions, obstacle motion)
        and hands X/Z/L to the device, where the x-updates, future-piece
        transform, z-projection, lambda updates and residuals run."""
        runner = self._runner
        dev = dict(dtype=runner.dtype, device=runner.device)
        if self._device_carry is None:
            self._device_carry = runner.make_state(current_time)
        carry = self._device_carry._replace(
            X=tuple(torch.as_tensor(g.X, **dev) for g in self.groups),
            Pp=tuple(torch.as_tensor(self._pack_params(g, current_time),
                                     **dev) for g in self.groups),
            Z=torch.as_tensor(self.Z, **dev),
            L=torch.as_tensor(self.L, **dev))
        t0 = self.time_parameter(current_time) / \
            self.template.options["horizon_time"]
        phase = int(round(t0 * runner.horizon / runner.update_time)) \
            % runner.spk
        reset = self._device_reset
        self._device_reset = False
        carry, (pri, dua) = runner.iterate_fn(1, phase=phase)(carry, reset)
        self._device_carry = carry
        runner.sync_to_host(carry)
        pri_res = float(pri[-1])
        dual_res = float(dua[-1])
        if self.nesterov:
            self._accelerate(self.rho * pri_res ** 2 + dual_res ** 2)
        self.residuals.append((pri_res, dual_res))
        return pri_res, dual_res

    # -- the ADMM iteration -------------------------------------------------
    def _x_update(self, group, current_time):
        """One batched solve of the group's x-updates, warm-started from
        its ALM state after the first."""
        tmpl = group.template
        dev = dict(dtype=self.dtype, device=self.device)
        X = torch.as_tensor(group.X, **dev)
        P = torch.as_tensor(self._pack_params(group, current_time), **dev)
        warm = group.alm_state
        if warm is not None and warm.rho.dtype == torch.float32:
            # re-arm the ALM penalty on f32 warm resolves: carried across
            # consensus iterations it only ratchets, until the f32 Newton
            # systems lose their conditioning (parallel/fleet_runner.py,
            # alm_rho_cap); the f64 path keeps the carried penalty
            warm = warm._replace(rho=torch.clamp(warm.rho, max=10.0))
        st = tmpl._solver(X, P, group.lb, group.ub, state0=warm)
        group.alm_state = st
        group.X = st.x.cpu().numpy().astype(np.float64)

    def dual_update(self, current_time):
        if self._runner is not None:
            return self._device_dual_update(current_time)
        # 1. x-updates, one batched solve per vehicle-type group
        for group in self.groups:
            self._x_update(group, current_time)
        # shared coefficients (original coordinates)
        S = np.stack([self._s_of_vehicle(i) for i in range(self.N)])
        # future-piece coordinates
        t0 = self.time_parameter(current_time) / \
            self.template.options["horizon_time"]
        Tf = self._shared_transform(t0)
        proj = self._projection_for(Tf)

        def fwd(arr):
            return arr if Tf is None else arr @ Tf.T

        S_t = fwd(S)
        L_t = fwd(self.L.reshape(-1, self.n_sh)).reshape(self.L.shape)
        rho = self.rho
        Z_prev = self.Z.copy()
        # 2./3. communicate + z-update (transformed space)
        if self.n_edges == 1:
            # full graph / N == 2: global average consensus
            avg = np.mean(S_t + L_t[:, 0, :] / rho, axis=0)
            Zt_new = (proj @ avg)[None, :]
        else:
            slot_next = L_t[:, 0, :]                        # lam_{i, edge i}
            slot_prev = np.roll(L_t[:, 1, :], -1, axis=0)   # lam_{i+1, edge i}
            S_next = np.roll(S_t, -1, axis=0)
            avg = 0.5 * (S_t + slot_next / rho + S_next + slot_prev / rho)
            Zt_new = avg @ proj.T
        # store z back in original coordinates
        self.Z = Zt_new if Tf is None else \
            np.linalg.solve(Tf, Zt_new.T).T
        # 4. lam-update in original coordinates (omgtools admm.py:248-268)
        for i in range(self.N):
            for k, e in enumerate(self._slot_edges(i)):
                self.L[i, k] += rho * (S[i] - self.Z[e])
        # residuals in transformed coordinates (omgtools admm.py:270-307)
        Zt_prev = fwd(Z_prev)
        pr2 = dr2 = 0.0
        for i in range(self.N):
            for e in self._slot_edges(i):
                pr2 += float(np.sum((S_t[i] - Zt_new[e]) ** 2))
        for e in range(self.n_edges):
            dr2 += rho * float(np.sum((Zt_new[e] - Zt_prev[e]) ** 2))
        pri_res, dual_res = np.sqrt(pr2), np.sqrt(dr2)
        c_res = rho * pr2 + dr2          # combined [Goldstein]
        # 5. optional Nesterov acceleration with restart
        if self.nesterov:
            self._accelerate(c_res)
        self.residuals.append((pri_res, dual_res))
        return pri_res, dual_res

    def _accelerate(self, c_res):
        """Nesterov acceleration of (z, lam) with optional restart
        (omgtools admm.py:510-554)."""
        eta = self.eta
        if self._c_res_p is None:
            self._c_res_p = c_res / eta
        if self.nesterov_reset and c_res > eta * self._c_res_p:
            if self.options["verbose"] >= 2:
                print("resetting alpha")
            self._alpha = 1.0
            self.Z = self._Z_p.copy()
            self.L = self._L_p.copy()
            self._c_res_p = self._c_res_p / eta
            return
        alpha_p = self._alpha
        self._alpha = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * alpha_p ** 2))
        beta = (alpha_p - 1.0) / self._alpha
        Z_new, L_new = self.Z.copy(), self.L.copy()
        if not self.ama:
            Z_new = self.Z + beta * (self.Z - self._Z_p)
        L_new = self.L + beta * (self.L - self._L_p)
        self._Z_p, self._L_p = self.Z.copy(), self.L.copy()
        self.Z, self.L = Z_new, L_new
        self._c_res_p = c_res

    # -- residual plot provider (omgtools admm.py:634-670) -------------------
    def init_plot(self, argument, **kwargs):
        if argument != "residuals":
            return super().init_plot(argument, **kwargs)
        return [[{"labels": ["iteration", "log10(primal res)"],
                  "lines": [{"color": "tab:blue"}]}],
                [{"labels": ["iteration", "log10(dual res)"],
                  "lines": [{"color": "tab:orange"}]}]]

    def update_plot(self, argument, t, **kwargs):
        if argument != "residuals":
            return super().update_plot(argument, t, **kwargs)
        res = np.asarray(self.residuals, dtype=np.float64)
        if res.size == 0:
            empty = np.zeros((2, 0))
            return [[[empty]], [[empty]]]
        it = np.arange(res.shape[0])
        with np.errstate(divide="ignore"):
            logres = np.log10(np.maximum(res, 1e-300))
        return [[[np.vstack([it, logres[:, 0]])]],
                [[np.vstack([it, logres[:, 1]])]]]

    # -- lifecycle (Problem API) -------------------------------------------
    def initialize(self, current_time):
        self.start_time = current_time
        self.current_time_prev = current_time
        for _ in range(self.init_iter):
            self.dual_update(current_time)

    def solve(self, current_time, update_time):
        current_time -= self.start_time
        t0 = _time.time()
        self.init_step(current_time, update_time)
        for _ in range(self.max_iter_per_update):
            pri, dua = self.dual_update(current_time)
        t_upd = _time.time() - t0
        self.update_times.append(t_upd)
        self.iteration += 1
        if self.options["verbose"] >= 2:
            if (self.iteration - 1) % 20 == 0:
                print("----|------------|------------|------------")
                print("%3s | %10s | %10s | %10s" %
                      ("it", "t upd", "pri res", "dual res"))
                print("----|------------|------------|------------")
            print("%3d | %.4e | %.4e | %.4e" %
                  (self.iteration, t_upd, pri, dua))

    def init_step(self, current_time, update_time):
        knot_time = self.template.knot_time
        interval_prev = int(np.round(self.current_time_prev / knot_time, 6))
        interval_now = int(np.round(current_time / knot_time, 6))
        if interval_prev < interval_now:
            for group in self.groups:
                group.X = group.X @ group.x_shift.T
                group.alm_state = None
            self._device_reset = True   # device path: drop lam warm state
            self.Z = self.Z @ self._sh_shift.T
            self.L = self.L @ self._sh_shift.T
            self._Z_p = self._Z_p @ self._sh_shift.T
            self._L_p = self._L_p @ self._sh_shift.T
        self.current_time_prev = current_time
        for group in self.groups:
            group.template.current_time_prev = current_time

    def time_parameter(self, current_time):
        return self.template.time_parameter(current_time)

    def predict(self, current_time, predict_time, sample_time, states=None,
                delay=0, enforce_states=False, enforce_inputs=False):
        if states is None:
            states = [None] * self.N
        if current_time == self.start_time:
            enforce_states = True
        for k, vehicle in enumerate(self.vehicles):
            vehicle.predict(current_time, predict_time, sample_time,
                            states[k], delay=delay,
                            enforce_states=enforce_states,
                            enforce_inputs=enforce_inputs)

    def store(self, current_time, update_time, sample_time):
        for group in self.groups:
            tmpl = group.template
            horizon_time = tmpl.options["horizon_time"]
            rel_current_time = np.round(current_time - self.start_time, 6) \
                % tmpl.knot_time
            n_samp = int(round(
                (horizon_time - rel_current_time) / sample_time, 6)) + 1
            time_axis = np.linspace(
                rel_current_time,
                rel_current_time + (n_samp - 1) * sample_time, n_samp)
            sl, shape = tmpl.transcription.var_slice(tmpl.vehicles[0],
                                                     "splines_seg0")
            for row, i in enumerate(group.indices):
                coeffs = group.X[row][sl].reshape(shape)
                self.vehicles[i].store(current_time, sample_time, [coeffs],
                                       horizon_time, time_axis)

    def simulate(self, current_time, simulation_time, sample_time):
        for vehicle in self.vehicles:
            vehicle.simulate(simulation_time, sample_time)
        self.environment.simulate(simulation_time, sample_time)

    def compute_objective(self):
        return float("nan")

    def final(self):
        if self.options["verbose"] >= 1:
            print("\nWe reached our target!")
            if self.update_times:
                print("%-18s %6g ms" % ("Max update time:",
                                        max(self.update_times) * 1000.0))
                print("%-18s %6g ms" % (
                    "Av update time:",
                    sum(self.update_times) * 1000.0 / len(self.update_times)))

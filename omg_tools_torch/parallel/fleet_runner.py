"""Receding-horizon consensus-ADMM fleet loop on one device (counterpart
of ``omg_tools_tpu.parallel.fleet_runner``).

The host path (``problems.admm`` ``dual_update``) runs the z/lambda
consensus in numpy every iteration.  Here the whole fleet MPC loop stays
on the device, as a host loop over fixed-shape tensor code (the JAX
package's ``lax.scan``):

- batched warm-started x-updates (one ALM solve per vehicle-type group,
  its lanes the group's vehicles; the generic ALM mode replays CUDA graphs
  of its Newton steps, ``ops.alm``),
- the future-piece transform at every phase: per-phase ``shiftfirstknot_T``
  and projection matrices precomputed on the host for the steps_per_knot
  discrete phases (omgtools admm.py:86-88,143-145),
- knot-passage shifts of X/Z/L (omgtools admm.py:477-491),
- the z-projection and lambda updates as matrix products,
- plant updates through the vehicle rollout recipe
  (``problems.rollout_models``).

Fleet communication: on one device the circular-graph neighbor exchange
is an index roll along the vehicle axis; on a ``torch.distributed``
device mesh (``mesh=``) every rank owns a block of vehicles and the
exchange is one ring step between neighbouring ranks, the residuals
all-reduced (``parallel.fleet_mesh``, the JAX package's ``shard_map``
with ``ppermute``/``psum``).  Any fleet size runs on the mesh: the blocks
are padded to equal sizes, and the exchange goes through a gathered table
when N does not divide the mesh dimension.

Heterogeneous fleets (several vehicle-type groups, omgtools
separate_per_build, distributedproblem.py:88-103): on one device one
batched solve a group, scattered into the fleet-wide shared matrix; on the
mesh every rank runs every group's solver on its block (SPMD, no
divergent control flow), one-hot type masks selecting the rows each group
owns, while the consensus exchange stays group-agnostic (one fleet-wide
shared-coefficient layout).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..problems.batch import resolve_device
from ..problems.rollout_models import make_rollout_model
from .fleet_mesh import all_gather, all_reduce, axis_size, ring_pull

__all__ = ["FleetRunner", "FleetCarry"]


class FleetCarry(NamedTuple):
    X: tuple              # per-group (n_i, n_x_g) primal iterates
    st: tuple             # per-group ALMStates (warm solver state)
    Pp: tuple             # per-group (n_i, n_p_g) parameter vectors
    Z: torch.Tensor       # (n_edges, n_sh)
    L: torch.Tensor       # (N, n_slots, n_sh)


class _ModelAdapter:
    """Quacks like a BatchedP2PRunner for ``problems.rollout_models``."""

    def __init__(self, template, update_time, dtype, device):
        self.problem = template
        self.vehicle = template.vehicles[0]
        self.tr = template.transcription
        self.update_time = update_time
        self.horizon = float(template.options["horizon_time"])
        knot_time = float(template.knot_time)
        self.steps_per_knot = int(round(knot_time / update_time))
        self.dtype = dtype
        self.device = device


class FleetRunner:
    """Fleet-ADMM stepper for an initialized
    :class:`problems.admm.ADMMProblem` (e.g. FormationPoint2point):
    ``device`` None is CUDA, which must then exist.

    ``mesh``/``axis``: an optional ``torch.distributed`` DeviceMesh of the
    runner's device type; the vehicle dimension is then split over its
    dimension ``axis`` and the consensus communication becomes ring steps
    and all-reduces (mixed fleets through per-group type masks).
    """

    def __init__(self, admm_problem, dtype=torch.float32, update_time=0.1,
                 mesh=None, axis: str = "fleet", outer_iter: int = 2,
                 nesterov: bool = False, eta: float = 0.999, device=None):
        ap = admm_problem
        self.ap = ap
        self.dtype = dtype
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a runner on "
                             f"{self.device.type}")
        self.mesh = mesh
        self.axis = axis
        self.update_time = float(update_time)
        self.outer_iter = outer_iter
        # Nesterov acceleration with restart in the device loop (the
        # branch-free mirror of the host ADMMProblem._accelerate, omgtools
        # admm.py:510-554)
        self.nesterov = nesterov
        self.eta = float(eta)
        # warm-resolve ALM penalty cap: the x-update's rho ratchets inside
        # each solve (rho_growth on stall) and, carried across ADMM
        # iterations, climbs until the f32 Newton systems lose their
        # conditioning; re-arming it at its initial value each consensus
        # iteration keeps the warm multipliers and the subproblems solvable
        self.alm_rho_cap = 10.0
        self.N = ap.N
        self.n_sh = ap.n_sh
        self.n_slots = ap.n_slots
        self.n_edges = ap.n_edges
        self.rho = float(ap.rho)
        self.circular = ap.n_edges > 1
        dev = dict(dtype=dtype, device=self.device)

        tmpl = ap.template
        self.horizon = float(tmpl.options["horizon_time"])
        self.knot_time = float(tmpl.knot_time)
        self.spk = int(round(self.knot_time / self.update_time))

        # per-phase future-piece transforms (t0 = phase*dt / horizon)
        TfT, TfinvT, projT = [], [], []
        eye = np.eye(self.n_sh)
        for ph in range(self.spk):
            t0 = ph * self.update_time / self.horizon
            Tf = ap._shared_transform(t0)
            proj = ap._projection_for(Tf)
            if Tf is None:
                TfT.append(eye)
                TfinvT.append(eye)
            else:
                TfT.append(Tf.T)
                TfinvT.append(np.linalg.inv(Tf).T)
            projT.append(proj.T)
        # row-major copies: a product with a transposed operand rounds each
        # row differently by the number of rows (MKL), and the mesh's
        # blocks must compute the rows the whole fleet would
        def const(a):
            return torch.as_tensor(np.ascontiguousarray(a), **dev)
        self.TfT = const(np.stack(TfT))
        self.TfinvT = const(np.stack(TfinvT))
        self.projT = const(np.stack(projT))
        self.sh_shiftT = const(ap._shared_shift().T)

        # per-group constants
        self.groups = ap.groups
        self._g = []

        def index(a):
            return torch.as_tensor(np.asarray(a), device=self.device)
        for group in ap.groups:
            tr = group.template.transcription
            i_z, _ = tr.par_slice(group.template, "admm_z")
            i_l, _ = tr.par_slice(group.template, "admm_l")
            i_t, _ = tr.par_slice(group.template, "t")
            i_spl, spl_shape = tr.var_slice(group.template.vehicles[0],
                                            "splines_seg0")
            adapter = _ModelAdapter(group.template, self.update_time, dtype,
                                    self.device)
            rows = np.asarray(group.indices)
            edges = np.stack([ap._slot_edges(i) for i in group.indices])
            rel = np.stack([ap._rel_offsets(i) for i in group.indices])
            self._g.append(dict(
                solver=group.template._solver,
                i_spl=index(np.arange(i_spl.start, i_spl.stop)),
                spl_shape=tuple(spl_shape),
                i_z=index(np.arange(i_z.start, i_z.stop)),
                i_l=index(np.arange(i_l.start, i_l.stop)),
                i_t=index(np.arange(i_t.start, i_t.stop)),
                S_idx=index(group.S_idx),
                rel=torch.as_tensor(rel, **dev), rows=index(rows),
                edges=index(edges),
                x_shiftT=const(group.x_shift.T),
                lb=torch.as_tensor(np.asarray(group.lb), **dev),
                ub=torch.as_tensor(np.asarray(group.ub), **dev),
                model=make_rollout_model(adapter)))

    # -- state construction -------------------------------------------------
    def make_state(self, current_time=0.0):
        """Initial device state from the host-side ADMM problem: packed
        parameters, warm X, Z, L, and the groups' converged cold solves."""
        ap = self.ap
        dev = dict(dtype=self.dtype, device=self.device)
        X, Pp = [], []
        for group in ap.groups:
            Pp.append(torch.as_tensor(ap._pack_params(group, current_time),
                                      **dev))
            X.append(torch.as_tensor(group.X, **dev))
        st = tuple(self._cold_state(g, x, p)
                   for g, x, p in zip(self._g, X, Pp))
        return FleetCarry(X=tuple(X), st=st, Pp=tuple(Pp),
                          Z=torch.as_tensor(ap.Z, **dev),
                          L=torch.as_tensor(ap.L, **dev))

    @staticmethod
    def _cold_state(g, X, Pp):
        """Converged cold solves for the initial warm state."""
        return g["solver"](X, Pp, g["lb"], g["ub"])

    def sync_to_host(self, carry: FleetCarry):
        """Copy the device state back into the host ADMM problem (for
        store/plotting)."""
        ap = self.ap
        for group, X in zip(ap.groups, carry.X):
            group.X = X.cpu().numpy().astype(np.float64)
        ap.Z = carry.Z.cpu().numpy().astype(np.float64)
        ap.L = carry.L.cpu().numpy().astype(np.float64)

    # -- the consensus iteration ---------------------------------------------
    def _solve_groups(self, X, st, Pp, Z, L, reset_lam):
        """x-updates: write z/l into the parameters, one batched
        warm-started solve per group.  Returns (X', st', S) with S the
        fleet-wide shared matrix (N, n_sh)."""
        X_n, st_n = [], []
        S = torch.zeros((self.N, self.n_sh), dtype=Z.dtype, device=Z.device)
        for g, Xg, stg, Pg in zip(self._g, X, st, Pp):
            rows = Xg.shape[0]
            Pg = Pg.clone()
            Pg[:, g["i_z"]] = Z[g["edges"]].reshape(rows, -1)
            Pg[:, g["i_l"]] = L[g["rows"]].reshape(rows, -1)
            inf = torch.full_like(stg.feas, float("inf"))
            st_in = stg._replace(
                x=Xg,
                lam=torch.zeros_like(stg.lam) if reset_lam else stg.lam,
                rho=torch.clamp(stg.rho, max=self.alm_rho_cap),
                feas=inf, stat=inf, n_iter=torch.zeros_like(stg.n_iter))
            stg2 = g["solver"](Xg, Pg, g["lb"], g["ub"], state0=st_in,
                               outer_iter=self.outer_iter)
            X_n.append(stg2.x)
            st_n.append(stg2)
            S[g["rows"]] = stg2.x[:, g["S_idx"]] + g["rel"]
        return tuple(X_n), tuple(st_n), S

    def _consensus(self, S, Z, L, phase):
        """z-update (projection in future-piece coordinates), lambda update
        in original coordinates, residuals (omgtools admm.py:117-307)."""
        rho = self.rho
        TfT = self.TfT[phase]
        S_t = S @ TfT
        L_t = torch.einsum("nks,st->nkt", L, TfT)
        if self.circular:
            slot_next = L_t[:, 0, :]
            slot_prev = torch.roll(L_t[:, 1, :], -1, dims=0)
            S_next = torch.roll(S_t, -1, dims=0)
            avg = 0.5 * (S_t + slot_next / rho + S_next + slot_prev / rho)
        else:
            avg = torch.mean(S_t + L_t[:, 0, :] / rho, dim=0, keepdim=True)
        Zt_new = avg @ self.projT[phase]
        Z_new = Zt_new @ self.TfinvT[phase]
        # lambda in original coordinates (omgtools admm.py:248-268)
        if self.circular:
            Z_prev = torch.roll(Z_new, 1, dims=0)
            L0 = L[:, 0, :] + rho * (S - Z_new)
            L1 = L[:, 1, :] + rho * (S - Z_prev)
            L_new = torch.stack([L0, L1], dim=1)
            pr2 = torch.sum((S_t - Zt_new) ** 2) \
                + torch.sum((S_t - torch.roll(Zt_new, 1, dims=0)) ** 2)
        else:
            L_new = L + rho * (S - Z_new)[:, None, :]
            pr2 = torch.sum((S_t - Zt_new) ** 2)
        Zt_prev = torch.einsum("es,st->et", Z, TfT)
        dr2 = rho * torch.sum((Zt_new - Zt_prev) ** 2)
        return Z_new, L_new, torch.sqrt(pr2), torch.sqrt(dr2)

    def _iteration(self, carry: FleetCarry, phase, reset_lam):
        X, st, S = self._solve_groups(carry.X, carry.st, carry.Pp,
                                      carry.Z, carry.L, reset_lam)
        Z, L, pri, dua = self._consensus(S, carry.Z, carry.L, phase)
        return carry._replace(X=X, st=st, Z=Z, L=L), (pri, dua)

    # -- Nesterov acceleration (device, branch-free) ------------------------
    def _accel_init(self, Z, L):
        """Fresh momentum state: previous iterates anchored at (Z, L)."""
        return (Z, L, torch.ones((), dtype=Z.dtype, device=Z.device),
                torch.full((), float("inf"), dtype=Z.dtype, device=Z.device))

    def _accelerate(self, Z, L, acc, pri, dua):
        """One acceleration step on (z, lambda) with combined-residual
        restart, the masked equivalent of the host
        ADMMProblem._accelerate (omgtools admm.py:510-554):

        - no restart: alpha' = (1+sqrt(1+4 alpha^2))/2, beta = (alpha-1)/
          alpha', extrapolate Z/L by beta along the last step, remember the
          un-extrapolated iterates, c_res' = c_res;
        - restart (c_res > eta * c_res_prev): roll (Z, L) back to the
          previous iterates, alpha' = 1, c_res_prev' = c_res_prev / eta.
        """
        Z_p, L_p, alpha, c_prev = acc
        c_res = self.rho * pri * pri + dua * dua
        reset = c_res > self.eta * c_prev
        alpha_n = torch.where(
            reset, torch.ones_like(alpha),
            0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * alpha * alpha)))
        beta = torch.where(reset, torch.zeros_like(alpha),
                           (alpha - 1.0) / alpha_n)
        Z_out = torch.where(reset, Z_p, Z + beta * (Z - Z_p))
        L_out = torch.where(reset, L_p, L + beta * (L - L_p))
        Z_p_n = torch.where(reset, Z_p, Z)
        L_p_n = torch.where(reset, L_p, L)
        c_prev_n = torch.where(reset, c_prev / self.eta, c_res)
        return Z_out, L_out, (Z_p_n, L_p_n, alpha_n, c_prev_n)

    def _iterations(self, carry, n_iter, phase, reset_lam):
        """``n_iter`` consensus iterations (with acceleration, momentum
        anchored at the start); the solver's multipliers are dropped on
        the first iteration when ``reset_lam``."""
        acc = self._accel_init(carry.Z, carry.L)
        pri, dua = [], []
        for i in range(n_iter):
            carry, res = self._iteration(carry, phase, reset_lam and i == 0)
            if self.nesterov:
                Z, L, acc = self._accelerate(carry.Z, carry.L, acc, *res)
                carry = carry._replace(Z=Z, L=L)
            pri.append(res[0])
            dua.append(res[1])
        return carry, (torch.stack(pri), torch.stack(dua))

    # -- the loops a caller runs -------------------------------------------
    def iterate_fn(self, n_iter, phase=0):
        """(carry, reset_lam=False) -> (carry, (pri, dua) tensors of
        n_iter): consensus iterations at a fixed time -- the init_iter
        phase (omgtools dualmethod.py:209-216) and the ADMM benchmark.
        ``reset_lam`` drops the solver's multiplier warm state on the
        first iteration (after a knot-passage shift)."""
        def run(carry, reset_lam=False):
            return self._iterations(carry, n_iter, phase, bool(reset_lam))
        return run

    def rollout_fn(self, n_steps, iters_per_update=1):
        """(carry) -> (carry, outs): advance ``n_steps`` control periods.
        Each period: the knot shift when due, ``iters_per_update``
        consensus iterations, the ideal plant update through the vehicle
        recipes.  outs = dict(pri, dua, states (N, n_steps, n_dim))."""
        spk = self.spk
        dt = self.update_time

        def run(carry):
            pri, dua, states = [], [], []
            for k in range(n_steps):
                phase = k % spk
                do_shift = phase == 0 and k > 0
                if do_shift:
                    # knot-passage shift of X/Z/L (omgtools
                    # admm.py:477-491); the solver's multipliers lose
                    # their row correspondence and are dropped below
                    carry = carry._replace(
                        X=tuple(Xg @ g["x_shiftT"]
                                for g, Xg in zip(self._g, carry.X)),
                        Z=carry.Z @ self.sh_shiftT,
                        L=torch.einsum("nks,st->nkt", carry.L,
                                       self.sh_shiftT))
                Pp = []
                for g, Pg in zip(self._g, carry.Pp):
                    Pg = Pg.clone()
                    Pg[:, g["i_t"]] = phase * dt
                    Pp.append(Pg)
                carry = carry._replace(Pp=tuple(Pp))
                # momentum re-anchored each control period: the knot shift
                # changes the coordinate frame of Z/L
                carry, res = self._iterations(carry, iters_per_update, phase,
                                              do_shift)
                pri.append(res[0][-1])
                dua.append(res[1][-1])
                # ideal plant update: sample the solved splines one period
                # ahead, write state0/input0 back into the parameters
                Pp, out = [], None
                for g, Xg, Pg in zip(self._g, carry.X, carry.Pp):
                    cfs = Xg[:, g["i_spl"]].reshape(
                        (Xg.shape[0],) + g["spl_shape"])
                    Pg, st_g = g["model"].update(Pg, cfs, phase + 1,
                                                 self.horizon)
                    Pp.append(Pg)
                    if out is None:
                        out = torch.zeros((self.N, st_g.shape[-1]),
                                          dtype=st_g.dtype,
                                          device=st_g.device)
                    out[g["rows"]] = st_g
                carry = carry._replace(Pp=tuple(Pp))
                states.append(out)
            return carry, {"pri": torch.stack(pri), "dua": torch.stack(dua),
                           "states": torch.stack(states, dim=1)}
        return run

    # -- mesh-sharded variant ----------------------------------------------
    def _mesh_setup(self):
        """Common mesh-path geometry: the process group of the fleet
        dimension, this rank's place in it, the padded block size, and the
        neighbor-pull helpers (ring steps for divisible N, a gathered table
        otherwise)."""
        if self.mesh is None:
            raise ValueError("construct the FleetRunner with a mesh")
        mesh, axis = self.mesh, self.axis
        group = mesh.get_group(axis)
        n_dev = axis_size(mesh, axis)
        me = mesh.get_local_rank(axis)
        N = self.N
        blk = -(-N // n_dev)          # padded block size
        N_pad = blk * n_dev
        ring = (N == N_pad)

        if ring:
            def _pull_next(Sb):
                # S_{i+1}: in-block shift; boundary row from the next rank
                return torch.cat([Sb[1:], ring_pull(Sb[:1], group, 1)])

            def _pull_prev(Zb):
                return torch.cat([ring_pull(Zb[-1:], group, -1), Zb[:-1]])
        else:
            # padded blocks: the neighbor lookup goes through an all-gather
            rows = me * blk + np.arange(blk)
            idx_next = torch.as_tensor(np.array(
                [(i + 1) % N for i in range(N)] + [0] * (N_pad - N))[rows],
                device=self.device)
            idx_prev = torch.as_tensor(np.array(
                [(i - 1) % N for i in range(N)] + [0] * (N_pad - N))[rows],
                device=self.device)

            def _pull_next(Sb):
                return all_gather(Sb, group)[idx_next]

            def _pull_prev(Zb):
                return all_gather(Zb, group)[idx_prev]

        return dict(group=group, n_dev=n_dev, me=me, blk=blk, N_pad=N_pad,
                    ring=ring, pull_next=_pull_next, pull_prev=_pull_prev)

    def _mesh_consensus_iter(self, ms, rel, mask, tmasks, Xs, Ps, Z, L,
                             phase):
        """ONE ADMM iteration on this rank's block: per-group cold
        x-updates (every rank runs every group's solver on its block;
        ``tmasks`` one-hot selects the rows each group owns), the ring or
        all-reduced consensus, the lambda update, the residuals (summed
        over the group, then square-rooted).  Neighbor pulls that go the
        same way ride one exchange."""
        rho = self.rho
        n_sh = self.n_sh
        group = ms["group"]
        _pull_next, _pull_prev = ms["pull_next"], ms["pull_prev"]
        TfT = self.TfT[phase]
        TfinvT = self.TfinvT[phase]
        projT = self.projT[phase]
        rows = Xs[0].shape[0]
        Zrows = torch.cat([Z, _pull_prev(Z)], dim=1) \
            if self.circular else Z.reshape(1, -1).expand(rows, n_sh)
        Xn_list = []
        S = torch.zeros((rows, n_sh), dtype=Xs[0].dtype,
                        device=Xs[0].device)
        for g, Xg, Pg, tm in zip(self._g, Xs, Ps, tmasks):
            Pl = Pg.clone()
            Pl[:, g["i_z"]] = Zrows.reshape(rows, -1)
            Pl[:, g["i_l"]] = L.reshape(rows, -1)
            st = g["solver"](Xg, Pl, g["lb"], g["ub"],
                             outer_iter=self.outer_iter)
            Xn_g = torch.where(tm[:, None] > 0, st.x, Xg)
            Xn_list.append(Xn_g)
            S = S + tm[:, None] * (Xn_g[:, g["S_idx"]] + rel)
        Xn = tuple(Xn_list)
        m = mask[:, None]
        S_t = S @ TfT
        L_t = torch.einsum("nks,st->nkt", L, TfT)
        Zt_prev = torch.einsum("es,st->et", Z, TfT)
        if self.circular:
            nxt = _pull_next(torch.cat([S_t, L_t[:, 1, :]], dim=1))
            S_next, slot_prev = nxt[:, :n_sh], nxt[:, n_sh:]
            avg = 0.5 * (S_t + L_t[:, 0, :] / rho + S_next + slot_prev / rho)
            Zt_new = avg @ projT
            Z_new = Zt_new @ TfinvT
            prv = _pull_prev(torch.cat([Z_new, Zt_new], dim=1))
            Z_prev, Zt_new_prev = prv[:, :n_sh], prv[:, n_sh:]
            L0 = L[:, 0, :] + rho * (S - Z_new)
            L1 = L[:, 1, :] + rho * (S - Z_prev)
            L_new = torch.stack([L0, L1], dim=1)
            pr2 = torch.sum(m * (S_t - Zt_new) ** 2) \
                + torch.sum(m * (S_t - Zt_new_prev) ** 2)
            dr2 = rho * torch.sum(m * (Zt_new - Zt_prev) ** 2)
            pr2, dr2 = all_reduce(torch.stack([pr2, dr2]), group)
        else:
            # full graph: the global average, all-reduced
            s_sum = all_reduce(
                torch.sum(m * (S_t + L_t[:, 0, :] / rho), dim=0), group)
            avg = s_sum / self.N
            Zt_new = (avg @ projT).reshape(1, -1)
            Z_new = Zt_new @ TfinvT
            L_new = L + rho * (S - Z_new)[:, None, :]
            pr2 = all_reduce(torch.sum(m * (S_t - Zt_new) ** 2), group)
            dr2 = rho * torch.sum((Zt_new - Zt_prev) ** 2)
        return Xn, Z_new, L_new, torch.sqrt(pr2), torch.sqrt(dr2)

    def _mesh_run_wrapper(self, local, ms, out_states=False):
        """Scatter per-group arrays into fleet order, pad to equal
        per-rank blocks, take this rank's block onto its device, run
        ``local`` on it, and gather the results back to group order: every
        rank returns the whole fleet.  Single-group (homogeneous) callers
        pass and receive bare tensors."""
        N, N_pad, blk = self.N, ms["N_pad"], ms["blk"]
        group = ms["group"]
        lo, hi = ms["me"] * blk, (ms["me"] + 1) * blk
        ap = self.ap
        rel_full = np.zeros((N_pad, self.n_sh))
        for i in range(N):
            rel_full[i] = ap._rel_offsets(i)
        mask_full = np.zeros(N_pad)
        mask_full[:N] = 1.0
        tmasks_full = []
        for g in self._g:
            tm = np.zeros(N_pad)
            tm[g["rows"].cpu().numpy()] = 1.0
            tmasks_full.append(tm)
        dev = dict(dtype=self.dtype, device=self.device)

        def prepare(Xs, Ps, Z, L):
            """Once, before the timed calls: scatter per-group arrays into
            padded fleet order and take this rank's block of every operand
            onto its device.  Xs/Ps: per-group (n_i, n_x_g)/(n_i, n_p_g)
            arrays (bare arrays for a homogeneous fleet); Z:(n_edges,
            n_sh); L:(N, slots, n_sh)."""
            single = not isinstance(Xs, (tuple, list))
            Xs = (Xs,) if single else tuple(Xs)
            Ps = (Ps,) if single else tuple(Ps)

            def scatter(g, A):
                """Group-local rows -> padded fleet-order rows (pad and
                foreign rows replicate the group's first row -- benign,
                masked out of the consensus)."""
                A = torch.as_tensor(A, **dev)
                full = A[:1].repeat(N_pad, 1)
                full[g["rows"]] = A
                return full[lo:hi]

            def pad(a):
                a = torch.as_tensor(a, **dev)
                if a.shape[0] < N_pad:
                    a = torch.cat([a, a[-1:].expand(
                        (N_pad - a.shape[0],) + tuple(a.shape[1:]))])
                return a[lo:hi]

            Xf = tuple(scatter(g, X) for g, X in zip(self._g, Xs))
            Pf = tuple(scatter(g, Pg) for g, Pg in zip(self._g, Ps))
            Zp = pad(Z) if self.circular else torch.as_tensor(Z, **dev)
            rel = torch.as_tensor(rel_full[lo:hi], **dev)
            msk = torch.as_tensor(mask_full[lo:hi], **dev)
            tms = tuple(torch.as_tensor(tm[lo:hi], **dev)
                        for tm in tmasks_full)
            return (Xf, Pf, Zp, pad(L), rel, msk, tms, single)

        def run_placed(placed):
            """Run on pre-placed operands and gather the results back to
            group order.  Benchmarks time THIS (no host padding or
            transfer inside)."""
            Xf, Pf, Zp, Lp, rel, msk, tms, single = placed
            (Xn, Zn, Ln), res = local(Xf, Pf, Zp, Lp, rel, msk, tms)
            # every per-row output rides one all-gather
            parts = list(Xn) + [Ln] + ([Zn] if self.circular else []) \
                + ([res[2]] if out_states else [])
            full = all_gather(torch.cat(
                [a.reshape(blk, -1) for a in parts], dim=1), group)[:N]
            out, col = [], 0
            for a in parts:
                w = a[0].numel()
                out.append(full[:, col:col + w].reshape(
                    (N,) + tuple(a.shape[1:])))
                col += w
            Xg_out = tuple(X[g["rows"]] for g, X in zip(self._g, out))
            Ln = out[len(Xn)]
            if self.circular:
                Zn = out[len(Xn) + 1]
            if out_states:
                res = (res[0], res[1], out[-1])   # (N, n_steps, n_dim)
            return ((Xg_out[0] if single else Xg_out, Zn, Ln), res)

        def run(Xs, Ps, Z, L):
            return run_placed(prepare(Xs, Ps, Z, L))
        run.prepare = prepare
        run.run_placed = run_placed
        return run

    def _mesh_iterations(self, ms, rel, mask, tmasks, Xs, Ps, Z, L, n_iter,
                         phase):
        """``n_iter`` mesh iterations with acceleration (momentum anchored
        at the start); the residuals are all-reduced, so every rank takes
        the same restart decision."""
        acc = self._accel_init(Z, L)
        pri, dua = [], []
        for _ in range(n_iter):
            Xs, Z, L, pr, dr = self._mesh_consensus_iter(
                ms, rel, mask, tmasks, Xs, Ps, Z, L, phase)
            if self.nesterov:
                Z, L, acc = self._accelerate(Z, L, acc, pr, dr)
            pri.append(pr)
            dua.append(dr)
        return Xs, Z, L, torch.stack(pri), torch.stack(dua)

    def mesh_iterate_fn(self, n_iter, phase=0):
        """Mesh version of :meth:`iterate_fn`: vehicles split over the
        mesh dimension ``self.axis``; neighbor exchange by ring steps or a
        gathered table (N not divisible), residuals all-reduced.  The
        x-updates solve cold.  Returns ``run(Xs, Ps, Z, L) -> ((Xs, Z, L),
        (pri, dua))`` with ``run.prepare`` / ``run.run_placed``."""
        ms = self._mesh_setup()

        def local(Xs, Ps, Z, L, rel, mask, tmasks):
            Xs, Z, L, pri, dua = self._mesh_iterations(
                ms, rel, mask, tmasks, Xs, Ps, Z, L, n_iter, phase)
            return (Xs, Z, L), (pri, dua)
        return self._mesh_run_wrapper(local, ms)

    def mesh_rollout_fn(self, n_steps, iters_per_update=1):
        """Mesh receding-horizon fleet rollout: the knot-passage X/Z/L
        shifts, phase-indexed future-piece transforms and ideal plant
        updates of :meth:`rollout_fn` run on every rank's block, with the
        mesh consensus (omgtools admm.py:477-491 + dualmethod.py:209-224
        semantics).  Returns ``run(Xs, Ps, Z, L) -> ((Xs, Z, L), (pri,
        dua, states (N, n_steps, n_dim)))``."""
        ms = self._mesh_setup()
        spk = self.spk
        dt = self.update_time

        # per-group plant-state dims may differ in a mixed fleet: the
        # states output is padded to the widest
        def _sdim(model):
            for attr in ("i_state0", "i_spl0", "i_pose0"):
                if hasattr(model, attr):
                    return int(np.asarray(getattr(model, attr)).size)
            return 2
        s_dim = max(_sdim(g["model"]) for g in self._g)

        def local(Xs, Ps, Z, L, rel, mask, tmasks):
            pri, dua, states = [], [], []
            for k in range(n_steps):
                phase = k % spk
                if phase == 0 and k > 0:
                    # knot-passage shift (block-local: the shift matrices
                    # are the same on every rank)
                    Xs = tuple(Xg @ g["x_shiftT"]
                               for g, Xg in zip(self._g, Xs))
                    Z = Z @ self.sh_shiftT
                    L = torch.einsum("nks,st->nkt", L, self.sh_shiftT)
                Ps_t = []
                for g, Pg in zip(self._g, Ps):
                    Pg = Pg.clone()
                    Pg[:, g["i_t"]] = phase * dt
                    Ps_t.append(Pg)
                Xs, Z, L, prs, drs = self._mesh_iterations(
                    ms, rel, mask, tmasks, Xs, Ps_t, Z, L, iters_per_update,
                    phase)
                pri.append(prs[-1])
                dua.append(drs[-1])
                # ideal plant update: sample the solved splines one period
                # ahead, write state0/input0 back into the parameters
                Ps_n = []
                out = torch.zeros((Xs[0].shape[0], s_dim),
                                  dtype=Xs[0].dtype, device=Xs[0].device)
                for g, Xg, Pg, tm in zip(self._g, Xs, Ps_t, tmasks):
                    cfs = Xg[:, g["i_spl"]].reshape(
                        (Xg.shape[0],) + g["spl_shape"])
                    Pg_n, st_g = g["model"].update(Pg, cfs, phase + 1,
                                                   self.horizon)
                    Ps_n.append(Pg_n)
                    pad_w = s_dim - st_g.shape[-1]
                    if pad_w:
                        st_g = torch.cat([st_g, st_g.new_zeros(
                            st_g.shape[:-1] + (pad_w,))], dim=-1)
                    out = out + tm[:, None] * st_g
                Ps = tuple(Ps_n)
                states.append(out)
            return (Xs, Z, L), (torch.stack(pri), torch.stack(dua),
                                torch.stack(states, dim=1))
        return self._mesh_run_wrapper(local, ms, out_states=True)

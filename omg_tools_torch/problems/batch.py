"""Batched MPC rollouts on the card (counterpart of
``omg_tools_tpu.problems.batch``).

Thousands of receding-horizon point-to-point scenarios advance in lockstep:
warm-start knot shifts, parameter refresh (vehicle state, obstacle
prediction), the ALM solve and the ideal plant update all run on the
runner's device with an explicit batch axis.  The host precomputation --
AD for row scaling, quadratic detection and the per-phase affine tensors,
then the family compaction and the arrow partition -- runs once in float64
on the CPU and is cached on disk (``utils.cache``, keyed on the problem's
fingerprint, ``runner._cache_key``); its tensors then move to the device.

Scope: FixedT Point2point problems with a vehicle that has a rollout
recipe (``problems/rollout_models.py``: Holonomic, the quadrotors,
HolonomicOrient, Dubins), obstacles with constant-acceleration motion
(their states per scenario, ``make_batch(obstacle_states=)``) or on a
caller-given spline trajectory (re-based one period on by a constant
shift matrix every plant step), ideal plant update, and the JAX
package's solver structures, picked as it picks them:

- ``quadratic``: g = c + A x + x'Q x with Q found by host AD and the
  per-phase affine tensors of c(p), A(p) (``RolloutConsts``); the dense
  Gauss-Newton system goes to K1;
- ``generic``: no Q found (the exact-integral Dubins' cubic rows): J, g
  and the objective's Hessian by ``torch.func`` every Newton step, one
  forward-over-reverse replay of the transcription, on a CUDA card a
  captured CUDA graph (``ops.alm``); K1 solves the dense system;
- ``compact``: the family-compacted tensors (``ops/compact.py``) where no
  block-arrow partition is found; the dense compact system goes to K1;
- ``compact-arrow``: the block-arrow partition, K2 for the tail blocks and
  K1 for the head;
- ``compact-arrow-fused``, in float32: every inner iteration of an outer
  round in one launch of the fused kernel K3 (``ops/fused_alm.py``)
  wherever K3 takes the plan.

``structure`` is derived from ``fused_plan``, ``compact``,
``compact.arrow`` and the detected Q; a caller forces a structure by
clearing them (``runner.fused_plan = None``, ``runner.compact = None`` or
``runner.compact.arrow = None``) and building a new solver
(``runner.solver = runner.make_solver(options)``); ``consts()`` follow.
"""

from __future__ import annotations

import copy
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, jacfwd
from torch.profiler import record_function

from ..ops.basis import Basis
from ..ops.alm import ALMState, ALMOptions, make_alm_solver, \
    detect_quadratic_structure
from ..ops.compact import build_compact, detect_arrow, resolve_phase
from ..ops.fused_alm import FusedPlan
from ..utils import cache as _cache
from .rollout_models import make_rollout_model

__all__ = ["BatchedP2PRunner", "RolloutConsts", "CompactConsts",
           "resolve_device"]


def resolve_device(device=None):
    """The runner's device: ``None`` means CUDA, which must then exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return dev


def pin_full_f32():
    """Full-f32 products: TF32 breaks these ill-conditioned Newton systems
    (the JAX package pins HIGHEST matmul precision for the same reason)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class RolloutConsts(NamedTuple):
    """The rollout's device tensors for the dense structures (quadratic
    and generic).  The affine tensors are restricted to the varying
    parameter columns ``vsel``; they and Q are None where the structure
    has none."""
    Q: Optional[torch.Tensor]      # scaled quadratic tensor (m, n, n)
    c0: Optional[torch.Tensor]     # per-phase affine constraint constants
    C1: Optional[torch.Tensor]
    A0: Optional[torch.Tensor]
    TA: Optional[torch.Tensor]
    f0: Optional[torch.Tensor]
    gf: Optional[torch.Tensor]
    lb: torch.Tensor
    ub: torch.Tensor
    M: torch.Tensor                # shiftoverknot warm-start transform
    vsel: Optional[torch.Tensor] = None   # the varying parameter columns


class CompactConsts(NamedTuple):
    """The rollout's device tensors in family-compacted form."""
    CT: dict                    # CompactStructure.device_tensors()
    lb: torch.Tensor
    ub: torch.Tensor
    M: torch.Tensor             # shiftoverknot warm-start transform
    FS: Optional[dict] = None   # FusedPlan.shared() (fused structure)


def _cA_at(C, phase, p):
    """(c, A, f0, gf) of a batch p (B, n_p) at one phase, in raw units,
    from the per-phase affine tensors over the varying columns."""
    B = p.shape[0]
    pv = p[:, C.vsel]                                        # (B, n_v)
    c = C.c0[phase] + pv @ C.C1[phase].T                     # (B, m)
    TA = C.TA[phase]                                         # (m, n, n_v)
    A = C.A0[phase] + (pv @ TA.reshape(-1, TA.shape[-1]).T).reshape(
        B, *TA.shape[:2])                                    # (B, m, n)
    return (c, A, C.f0[phase].expand(B), C.gf[phase].expand(B, -1))


def _fused_operands(fused_plan, C, phase):
    """One phase's operands of the fused kernel, or None on the
    compact-arrow path; raises when the consts do not match the plan."""
    if (fused_plan is None) != (C.FS is None):
        raise ValueError(
            "the consts carry FS exactly when the runner has a fused plan: "
            "take them from runner.consts() after setting runner.fused_plan")
    return None if fused_plan is None else FusedPlan.slice_phase(C.FS, phase)


class BatchedP2PRunner:

    def __init__(self, problem, dtype=torch.float32, alm_options=None,
                 device=None):
        """problem: an initialized FixedTPoint2point (its transcription is
        reused; the problem object is not mutated).  ``alm_options``:
        optional :class:`ops.alm.ALMOptions` override.  ``device``: None
        means CUDA (raising when there is none); pass "cpu" explicitly for
        the CPU."""
        self.device = resolve_device(device)
        pin_full_f32()
        self.problem = problem
        self.dtype = dtype
        tr = problem.transcription
        self.tr = tr
        p_base = problem.pack_parameters(0.0)
        self._cache_key = getattr(tr, "fingerprint", None) or \
            _cache.problem_fingerprint(tr, p_base)
        hit = _cache.load_tensors(self._cache_key, "quadQ")
        if hit is not None:
            Q = hit["Q"] if hit["has_Q"] else None
        else:
            frozen = []
            try:
                slT, _ = tr.par_slice(problem, "T")
                frozen = list(range(slT.start, slT.stop))
            except KeyError:
                pass
            Q = detect_quadratic_structure(tr.constraints, tr.n_x,
                                           torch.as_tensor(p_base),
                                           f=tr.objective, frozen_idx=frozen)
            _cache.store_tensors(
                self._cache_key, "quadQ",
                {"has_Q": np.asarray(Q is not None),
                 "Q": np.zeros((0,)) if Q is None else np.asarray(Q)})
        self._Q_raw = None if Q is None else np.asarray(Q)
        vehicle = problem.vehicles[0]
        self.vehicle = vehicle
        self.n_x = tr.n_x
        self.n_p = tr.n_p

        self.horizon = problem.options["horizon_time"]
        self.knot_time = problem.knot_time
        self.update_time = 0.1
        self.steps_per_knot = int(round(self.knot_time / self.update_time))
        dev = dict(dtype=dtype, device=self.device)

        # warm-start shift matrix (applied on knot passage)
        self.shift_M = torch.as_tensor(
            tr.spline_shift_matrix(lambda basis: basis.shiftoverknot_T()),
            **dev)

        def idx(child, name):
            sl, shape = tr.par_slice(child, name)
            return np.arange(sl.start, sl.stop), shape

        self.i_t, _ = idx(problem, "t")
        self.obstacle_idx = []
        # spline-trajectory obstacles: a period's propagation re-expresses
        # the trajectory spline one period later, a constant shift matrix
        # on the coefficient parameters
        self.traj_obstacle_idx = []
        for obstacle in problem.environment.obstacles:
            if obstacle.options.get("spline_traj", False):
                ic, cshape = idx(obstacle, "traj_coeffs")
                sp = obstacle.options["spline_params"]
                traj_basis = Basis(np.asarray(sp["knots"], dtype=np.float64),
                                   sp["degree"])
                M_obs = torch.as_tensor(traj_basis.shift_spline_T(
                    self.update_time / self.horizon), **dev)
                self.traj_obstacle_idx.append((ic, cshape, M_obs))
                continue
            try:
                ix, _ = idx(obstacle, "x")
                iv, _ = idx(obstacle, "v")
                ia, _ = idx(obstacle, "a")
                self.obstacle_idx.append((ix, iv, ia))
            except KeyError:
                pass

        sl, shape = tr.var_slice(vehicle, "splines_seg0")
        self.i_splines = np.arange(sl.start, sl.stop)
        self.spline_shape = shape  # (n_coeffs, n_spl)

        self.model = make_rollout_model(self)
        self.i_poseT = self.model.i_goal

        self.lb_np, self.ub_np = tr.bounds(0.0)
        self.lb = torch.as_tensor(self.lb_np, **dev)
        self.ub = torch.as_tensor(self.ub_np, **dev)

        # per-phase affine tensors for c(p), A(p): for each in-knot phase
        # the constraint constants/Jacobian are affine in the varying
        # parameters, so the rollout needs no AD at all
        self._build_affine_cA()

        # family compaction + block-arrow partition
        self.compact = None
        if self.affine_cA and self._Q_raw is not None:
            con_blocks = [(c.offset, c.rows) for c in tr.layout.constraints]
            an = self._affine_np
            self.compact = build_compact(
                con_blocks, self._Q_raw, an["c0"], an["C1"], an["A0"],
                an["TA"], an["f0"], an["gf"],
                row_scale=problem._row_scale, obj_scale=problem._obj_scale,
                p_cols=an["vsel"])
            # head: the smallest contiguous span of the vehicle's variable
            # blocks (from the splines on) whose complement decouples into
            # pairwise-uncoupled tail blocks; cheapest factorization wins
            veh_blocks = sorted(
                (blk for (lbl, _), blk in tr.layout.variables.items()
                 if lbl == vehicle.label), key=lambda b: b.offset)
            lo = int(self.i_splines[0])
            ends = sorted({int(b.offset + b.size) for b in veh_blocks
                           if b.offset + b.size > lo})
            best = None
            for hi in ends:
                arrow = detect_arrow(self.compact.families, tr.n_x,
                                     (lo, hi - lo))
                if arrow is None:
                    continue
                h = arrow.head[1]
                cost = h ** 3 + sum(b ** 3 + 2 * b * b * (h + 1)
                                    for (_, b) in arrow.blocks)
                if best is None or cost < best[0]:
                    best = (cost, arrow)
            if best is not None:
                self.compact.arrow = best[1]

        # the fused inner loop (K3): one kernel launch per outer round, on
        # the compact-arrow structure only; the kernel is float32, so
        # float64 runners keep compact-arrow, and it takes plans within its
        # limits (``FusedPlan.kernel_refusal``: the
        # card's shared memory and the kernel's sizes, where the JAX
        # package gates on the TPU's VMEM).  Decided here, before any
        # launch; a plan that fails to build raises.  The plan is the one
        # selector of the path (see ``structure``): ``runner.fused_plan =
        # None`` turns a built runner to compact-arrow
        self.fused_plan = None
        if self.compact is None:
            self.structure_reason = "no compaction: " + (
                "no quadratic structure" if self._Q_raw is None else
                "the constraints are not affine in the parameters")
        elif self.compact.arrow is None:
            self.structure_reason = "no block-arrow partition"
        elif dtype != torch.float32:
            self.structure_reason = f"{dtype}: K3 is float32"
        elif os.environ.get("OMG_DISABLE_FUSED", "0") == "1":
            self.structure_reason = "OMG_DISABLE_FUSED=1"
        else:
            plan = FusedPlan(self.compact)
            refusal = plan.kernel_refusal()
            if refusal is None:
                self.fused_plan = plan
                self.structure_reason = "K3 takes the plan: " + plan.summary()
            else:
                self.structure_reason = "K3 refuses the plan: " + refusal

        self._alm_options = alm_options if alm_options is not None \
            else ALMOptions()
        self.solver = self.make_solver(self._alm_options)
        self._consts = None

    def to(self, device):
        """This runner on another device, sharing everything the host
        computed (transcription, host AD tensors, compaction, fused plan,
        solver): only the device tensors are made anew."""
        other = copy.copy(self)
        other.device = resolve_device(device)
        dev = dict(dtype=self.dtype, device=other.device)
        other.shift_M = self.shift_M.to(**dev)
        other.lb = self.lb.to(**dev)
        other.ub = self.ub.to(**dev)
        other.traj_obstacle_idx = [(ic, cshape, M.to(**dev)) for
                                   (ic, cshape, M) in self.traj_obstacle_idx]
        other.model = make_rollout_model(other)
        other._consts = None
        return other

    @property
    def structure(self):
        """The solver structure the runner's solves take, derived from
        ``fused_plan``, ``compact``, ``compact.arrow`` and the detected Q:
        ``compact-arrow-fused`` while it has a fused plan, else
        ``compact-arrow`` or ``compact`` with compacted tensors (with or
        without a block-arrow partition), else ``quadratic`` with a Q and
        ``generic`` without.  A fused plan without the arrow it was made
        from raises."""
        if self.compact is not None and self.compact.arrow is not None:
            return "compact-arrow" if self.fused_plan is None \
                else "compact-arrow-fused"
        structure = "compact" if self.compact is not None else \
            "quadratic" if self._Q_raw is not None else "generic"
        if self.fused_plan is not None:
            raise ValueError(
                f"a fused plan on the {structure} structure: set "
                "runner.fused_plan = None as well")
        return structure

    def make_solver(self, alm_options):
        """An ALM solver for the runner's structure with a custom iteration
        budget (phase-adaptive rollouts use one per budget): over the
        compacted tensors, or the dense quadratic form given Q exactly when
        nothing is compacted, or the generic mode (one replay of the
        transcription's joint f and g a Newton step)."""
        self.structure        # a fused plan must match the compaction
        problem = self.problem
        tr = self.tr
        return make_alm_solver(
            tr.objective, tr.constraints, tr.n_x, tr.lb, tr.ub, alm_options,
            row_scale=problem._row_scale, obj_scale=problem._obj_scale,
            quadratic_Q=None if self.compact is not None else self._Q_raw,
            compact=self.compact, fused_plan=self.fused_plan,
            fg=tr.objective_and_constraints)

    def consts(self):
        """The rollout's device tensors for the runner's structure: the
        compacted ones (``FS`` set exactly when the runner has a fused
        plan), or the dense ones (Q exactly when the runner has one, the
        affine tensors exactly when they were found)."""
        if self.compact is None:
            if not isinstance(self._consts, RolloutConsts) or \
                    (self._consts.Q is None) != (self._Q_raw is None) or \
                    (self._consts.c0 is None) == self.affine_cA:
                self._consts = self._dense_consts()
            return self._consts
        if not isinstance(self._consts, CompactConsts):
            self._consts = CompactConsts(
                self.compact.device_tensors(self.dtype, self.device),
                self.lb, self.ub, self.shift_M)
        if (self._consts.FS is None) != (self.fused_plan is None):
            self._consts = self._consts._replace(
                FS=None if self.fused_plan is None else
                self.fused_plan.shared(self.dtype, self.device))
        return self._consts

    def _dense_consts(self):
        """``RolloutConsts`` from the host float64 tensors: Q scaled by the
        row scales (the solver's own scaled Q), the affine tensors as the
        host AD gave them."""
        def dev(a):
            return torch.as_tensor(a, dtype=self.dtype, device=self.device)
        Q = None
        if self._Q_raw is not None:
            Q = dev(np.ascontiguousarray(
                self._Q_raw * np.asarray(self.problem._row_scale,
                                         dtype=np.float64)[:, None, None]))
        cA, vsel = (None,) * 6, None
        if self.affine_cA:
            an = self._affine_np
            cA = tuple(dev(an[k]) for k in ("c0", "C1", "A0", "TA", "f0",
                                            "gf"))
            vsel = torch.as_tensor(np.asarray(an["vsel"], dtype=np.int64),
                                   device=self.device)
        return RolloutConsts(Q, *cA, self.lb, self.ub, self.shift_M, vsel)

    def _operands(self):
        """``operands(C, phase, p)``: the solver's keyword arguments for
        one phase on the structure the runner has now (the fused kernel's
        shared operands, the resolved compact tensors, or the dense Q and
        affine c, A); raises when the consts ``C`` are not that
        structure's."""
        structure = self.structure
        compact, fused_plan = self.compact, self.fused_plan

        def operands(C, phase, p):
            if (compact is None) != isinstance(C, RolloutConsts):
                raise ValueError(
                    f"consts of type {type(C).__name__} on the {structure} "
                    "structure: take them from runner.consts() after "
                    "changing the structure")
            if compact is None:
                if (C.Q is None) != (structure == "generic"):
                    raise ValueError(
                        f"the consts carry Q exactly when the structure is "
                        f"quadratic (it is {structure})")
                cA = None if C.c0 is None else _cA_at(C, phase, p)
                return {"cA": cA, "Q": C.Q}
            fs = _fused_operands(fused_plan, C, phase)
            if fs is not None:
                return {"fshared": fs}
            return {"ct": resolve_phase(compact, C.CT, phase, p)}
        return operands

    def _varying_param_indices(self):
        """Full-p indices of the parameters that change during a rollout
        (vehicle state, goal, obstacle states); t, T and shape data stay
        frozen, so the affine tensors are restricted to these columns."""
        varying = list(self.model.varying_params())
        for (ix, iv, ia) in self.obstacle_idx:
            varying.extend([ix, iv, ia])
        for (ic, _, _) in self.traj_obstacle_idx:
            varying.append(ic)
        return np.unique(np.concatenate(varying))

    def _build_affine_cA(self):
        """Per-phase c0/C1/A0/TA/f0/gf over the varying parameter columns,
        from the cache or by host AD."""
        names = ("c0", "C1", "A0", "TA", "f0", "gf", "vsel")
        hit = _cache.load_tensors(self._cache_key, "affine_v")
        if hit is None:
            self._affine_host_ad()
            arrays = {"ok": np.asarray(self.affine_cA)}
            if self.affine_cA:
                arrays.update(self._affine_np)
            _cache.store_tensors(self._cache_key, "affine_v", arrays)
            return
        self.affine_cA = bool(hit["ok"])
        self._affine_np = None
        if self.affine_cA:
            self._affine_np = {k: hit[k] for k in names}

    def _affine_host_ad(self):
        """Per-phase c0/C1/A0/TA/f0/gf by host AD (float64, CPU) over the
        varying parameter columns, with an affineness check per phase."""
        tr = self.tr
        problem = self.problem
        g_fn = tr.constraints
        f_fn = tr.objective
        n_p = tr.n_p
        spk = self.steps_per_knot
        zero = torch.zeros(tr.n_x, dtype=torch.float64)
        p_base = problem.pack_parameters(0.0)
        varying = self._varying_param_indices()
        n_v = len(varying)
        E = np.zeros((n_p, n_v))
        E[varying, np.arange(n_v)] = 1.0
        Et = torch.as_tensor(E)
        dzero = torch.zeros(n_v, dtype=torch.float64)
        jac_x = jacfwd(g_fn)

        def g_of_dp(dp, pj):
            return g_fn(zero, pj + Et @ dp)

        def jx_of_dp(dp, pj):
            return jacfwd(g_fn)(zero, pj + Et @ dp)

        jac_p_v = jacfwd(g_of_dp)                     # (m, n_v)
        jac_xp_v = jacfwd(jx_of_dp)                   # (m, n, n_v)
        grad_f = grad(f_fn)
        c0s, C1s, A0s, TAs, f0s, gfs = [], [], [], [], [], []
        ok = self._Q_raw is not None              # quadratic constraints
        for ph in range(spk if ok else 0):
            p_ref = p_base.copy()
            p_ref[self.i_t] = ph * self.update_time
            pj = torch.as_tensor(p_ref)
            pv_ref = p_ref[varying]
            C1 = jac_p_v(dzero, pj).numpy()
            c0 = g_fn(zero, pj).numpy() - C1 @ pv_ref
            TA = jac_xp_v(dzero, pj).numpy()
            A0 = jac_x(zero, pj).numpy() - TA @ pv_ref
            gf = grad_f(zero, pj).numpy()
            f0 = float(f_fn(zero, pj))
            # validate affineness in the varying parameters
            rng = np.random.default_rng(ph)
            p_probe = p_ref.copy()
            p_probe[varying] += rng.standard_normal(n_v) * 0.1
            c_pred = c0 + C1 @ p_probe[varying]
            c_direct = g_fn(zero, torch.as_tensor(p_probe)).numpy()
            if np.max(np.abs(c_pred - c_direct)) > 1e-4 * (
                    np.max(np.abs(c_direct)) + 1.0):
                ok = False
                break
            A_pred = A0 + TA @ p_probe[varying]
            A_direct = jac_x(zero, torch.as_tensor(p_probe)).numpy()
            if np.max(np.abs(A_pred - A_direct)) > 1e-4 * (
                    np.max(np.abs(A_direct)) + 1.0):
                ok = False
                break
            c0s.append(c0); C1s.append(C1)
            A0s.append(A0); TAs.append(TA)
            f0s.append(f0); gfs.append(gf)
        self.affine_cA = ok
        self._affine_np = None
        if ok:
            self._affine_np = {"c0": np.stack(c0s), "C1": np.stack(C1s),
                               "A0": np.stack(A0s), "TA": np.stack(TAs),
                               "f0": np.asarray(f0s), "gf": np.stack(gfs),
                               "vsel": varying}

    # -- scenario construction (host) -------------------------------------
    def make_batch(self, starts, goals, obstacle_states=None):
        """Build (x0, p0, state0) device batches from per-scenario
        starts/goals (B, n_dim) and, optionally, obstacle states: a list
        of (pos, vel, acc), each (B, n_dim).  Without them the obstacles
        are at their initial states.  Init guesses: straight-line splines +
        geometric hyperplane warm starts.

        As in the JAX package, ``obstacle_states`` is read two ways: its
        first entries, in order, are the states of the moving obstacles
        (those with x, v, a parameters; spline-trajectory obstacles are
        skipped), while the hyperplane warm start of the obstacle at
        position l of the environment's list reads the position of entry
        l.  With the spline-trajectory obstacles last, one entry per
        obstacle in the environment's order satisfies both."""
        tr = self.tr
        problem = self.problem
        vehicle = self.vehicle
        starts = np.asarray(starts, dtype=np.float64)
        goals = np.asarray(goals, dtype=np.float64)
        B = starts.shape[0]
        n_coef = len(vehicle.basis)

        x0 = np.tile(tr.initial_guess()[None, :], (B, 1))
        x0[:, self.i_splines] = self.model.init_guess(
            starts, goals, n_coef).reshape(B, -1)
        # lifted position splines (Dubins substitution): straight-line
        # coefficient guesses from start to goal per axis
        for ax, name in enumerate(("xs_lift", "ys_lift")):
            try:
                sl, shape = tr.var_slice(vehicle, name)
            except KeyError:
                break
            ramp = np.linspace(0.0, 1.0, shape[0])[None, :]
            x0[:, sl.start:sl.stop] = (
                starts[:, ax:ax + 1] + ramp
                * (goals[:, ax:ax + 1] - starts[:, ax:ax + 1]))

        p0 = np.tile(problem.pack_parameters(0.0)[None, :], (B, 1))
        p0 = self.model.batch_params(p0, starts, goals)
        if obstacle_states is not None:
            for (ix, iv, ia), (pos, vel, acc) in zip(self.obstacle_idx,
                                                     obstacle_states):
                p0[:, ix] = pos
                p0[:, iv] = vel
                p0[:, ia] = acc

        # vectorized geometric hyperplane warm start per (obstacle, scenario)
        for l, obstacle in enumerate(problem.environment.obstacles):
            for name_prefix in ("a", "b"):
                name = f"{name_prefix}_{vehicle.label}_seg0_0{l}"
                try:
                    sl, shape = tr.var_slice(problem.environment, name)
                except KeyError:
                    continue
                if obstacle_states is not None:
                    obs_pos = np.asarray(obstacle_states[l][0])
                else:
                    obs_pos = np.tile(
                        obstacle.signals["position"][:, -1][None, :], (B, 1))
                chck, rad = obstacle.shape.get_checkpoints()
                bbox_lo = chck.min(axis=0)[None, :] + obs_pos
                bbox_hi = chck.max(axis=0)[None, :] + obs_pos
                hyp_basis = problem.environment._hyperplane_basis(vehicle)
                g = hyp_basis.greville()
                pts = self.model.path_points(starts, goals, g)
                nearest = np.clip(pts, bbox_lo[:, None, :], bbox_hi[:, None, :])
                d = pts - nearest
                nrm = np.linalg.norm(d, axis=-1, keepdims=True)
                # fallback perpendicular for on-path obstacles: Gram-Schmidt
                # of the least-aligned axis against the travel direction
                dirvec = goals - starts
                dim = dirvec.shape[-1]
                axis = np.eye(dim)[np.argmin(np.abs(dirvec), axis=-1)]
                d2 = np.maximum(np.sum(dirvec * dirvec, axis=-1,
                                       keepdims=True), 1e-12)
                perp = axis - (np.sum(axis * dirvec, axis=-1,
                                      keepdims=True) / d2) * dirvec
                perp /= np.maximum(np.linalg.norm(perp, axis=-1,
                                                  keepdims=True), 1e-9)
                d = np.where(nrm > 1e-9, d, perp[:, None, :])
                a0 = -d / np.maximum(np.linalg.norm(d, axis=-1,
                                                    keepdims=True), 1e-9)
                support = (np.einsum("cd,bnd->bnc", chck, a0)
                           - rad[None, None, :]).min(axis=-1)
                b0 = support + np.einsum("bnd,bd->bn", a0, obs_pos) - 1e-2
                if name_prefix == "a":
                    x0[:, sl.start:sl.stop] = a0.reshape(B, -1)
                else:
                    x0[:, sl.start:sl.stop] = b0.reshape(B, -1)

        dev = dict(dtype=self.dtype, device=self.device)
        return (torch.as_tensor(x0, **dev), torch.as_tensor(p0, **dev),
                torch.as_tensor(starts, **dev))

    # -- solves and the rollout ---------------------------------------------
    def init_solver_state(self, x0, p0, consts=None):
        """Batched cold solve producing the initial warm state."""
        C = consts if consts is not None else self.consts()
        return self.solver(x0, p0, C.lb, C.ub,
                           **self._operands()(C, 0, p0))

    def rollout_fn(self, n_steps, outer_iter=4, recover_tol=0.3,
                   rescue_lanes=0, rescue_outer=3, rescue_tol=1e-3,
                   budgets=None, streak_tol=8e-3, recover_metric="raw"):
        """Return ``rollout(alm_state, p, state, consts=None) ->
        ((alm_state, p, state), states (B, n_steps, n_dim))`` advancing
        ``n_steps`` MPC periods on the runner's device.

        ``recover_tol``: lanes whose violation exceeds it get a masked
        warm-start reset at the next step (the recipe's fresh guess from
        the current state to the goal, multipliers zeroed, penalty 100); a
        sustained violation above ``streak_tol`` for 2 consecutive steps
        triggers the same reset.

        ``recover_metric``: the violation that drives recovery and rescue.
        ``"raw"`` (the unit-mixing inf-norm, ``feas_raw``) suits problems
        whose raw and scaled violations are commensurate (holonomic);
        ``"scaled"`` (row-scaled, ``feas``) is needed where high-derivative
        rows leave a raw float32 floor above any sensible tolerance
        (SimpleQuadrotor3D: its T^4-scaled rows sit at raw ~0.14).

        ``rescue_lanes``: after each batched solve the worst lanes by
        violation (ties: lower lane index first, as ``lax.top_k``) are
        re-solved with ``rescue_outer`` outer rounds -- diverged ones from a
        fresh guess -- and blended back where the rescue is more feasible.
        0 disables.

        ``budgets``: ``((hard_outer, hard_inner), (easy_outer,
        easy_inner))``; the knot-passage step (k % steps_per_knot == 0,
        k > 0) gets the hard budget.  Overrides ``outer_iter`` when given.

        The returned ``rollout(st, p, state, consts=None, on_step=None)``
        calls ``on_step(k)``, when given, after step k has been issued.

        The solves take the structure the runner has as this function is
        called (the fused kernel while ``self.fused_plan`` is set); the
        consts must be that structure's."""
        spk = self.steps_per_knot
        dt = self.update_time
        solver = self.solver
        operands = self._operands()
        s0, s1 = int(self.i_splines[0]), int(self.i_splines[-1]) + 1
        dev = self.device
        i_poseT = torch.as_tensor(self.i_poseT, device=dev)
        i_t = torch.as_tensor(self.i_t, device=dev)
        model = self.model
        obstacle_idx = [tuple(torch.as_tensor(i, device=dev) for i in ids)
                        for ids in self.obstacle_idx]
        traj_obstacle_idx = [(torch.as_tensor(ic, device=dev), cshape, M)
                             for (ic, cshape, M) in self.traj_obstacle_idx]
        n_coef, n_spl = self.spline_shape
        horizon = self.horizon
        if recover_metric not in ("raw", "scaled"):
            raise ValueError(f"recover_metric {recover_metric!r}: 'raw' or "
                             "'scaled'")

        def trigger_feas(st):
            return st.feas if recover_metric == "scaled" else st.feas_raw

        def bmask(mask, a):
            return mask.reshape((-1,) + (1,) * (a.dim() - 1))

        def with_reset(x, state, goal, mask):
            """x with the spline block replaced by a fresh guess where
            ``mask`` is set."""
            reset = model.reset_guess(state, goal, n_coef, x.dtype)
            x_reset = x.clone()
            x_reset[:, s0:s1] = reset.reshape(x.shape[0], -1)
            return torch.where(mask[:, None], x_reset, x)

        def _solve(solver_fn, C, st_in, x_warm, p, phase, n_outer):
            return solver_fn(x_warm, p, C.lb, C.ub, state0=st_in,
                             outer_iter=n_outer, **operands(C, phase, p))

        def solve_step(solver_fn, n_outer, C, carry, k):
            st, p, state, streak = carry
            phase = k % spk
            # knot passage: shift the warm start
            x_warm = st.x @ C.M.T if (phase == 0 and k > 0) else st.x
            # masked divergence recovery: a hard violation, or a soft one
            # sustained for 2 consecutive steps
            bad = (trigger_feas(st) > recover_tol) | (streak >= 2)
            x_warm = with_reset(x_warm, state, p[:, i_poseT], bad)
            lam_warm = torch.where(bad[:, None], torch.zeros_like(st.lam),
                                   st.lam)
            rho_warm = torch.where(bad, torch.full_like(st.rho, 100.0),
                                   st.rho)
            p = p.clone()
            p[:, i_t] = phase * dt
            inf = torch.full_like(st.feas, float("inf"))
            st_in = st._replace(x=x_warm, lam=lam_warm, rho=rho_warm,
                                feas=inf, stat=inf,
                                n_iter=torch.zeros_like(st.n_iter))
            st = _solve(solver_fn, C, st_in, x_warm, p, phase, n_outer)
            streak = torch.where(bad, torch.zeros_like(streak), streak)
            streak = torch.where(trigger_feas(st) > streak_tol, streak + 1,
                                 torch.zeros_like(streak))
            return st, p, state, streak

        def rescue(C, st, p, state, phase):
            """Re-solve the worst lanes; keep whichever iterate is more
            feasible."""
            tf = trigger_feas(st)
            k_r = min(rescue_lanes, tf.shape[0])
            idx = torch.sort(tf, descending=True, stable=True).indices[:k_r]
            st_r = ALMState(*[a[idx] for a in st])
            p_r, state_r = p[idx], state[idx]
            # lanes beyond recover_tol restart from a fresh guess
            diverged = trigger_feas(st_r) > recover_tol
            x_in = with_reset(st_r.x, state_r, p_r[:, i_poseT], diverged)
            st_in = st_r._replace(
                x=x_in,
                lam=torch.where(diverged[:, None],
                                torch.zeros_like(st_r.lam), st_r.lam),
                rho=torch.where(diverged, torch.full_like(st_r.rho, 100.0),
                                st_r.rho))
            st_r2 = _solve(solver, C, st_in, x_in, p_r, phase, rescue_outer)
            take = (trigger_feas(st_r) > rescue_tol) & \
                (trigger_feas(st_r2) < trigger_feas(st_r))
            out = []
            for a, a_r, a_r2 in zip(st, st_r, st_r2):
                a = a.clone()
                a[idx] = torch.where(bmask(take, a_r), a_r2, a_r)
                out.append(a)
            return ALMState(*out)

        def plant_step(st, p, k):
            """Ideal plant update: the solved splines at the next sample
            instant become the new vehicle state; obstacles advance with
            constant acceleration, or one period along their spline
            trajectory."""
            phase = k % spk
            cfs = st.x[:, s0:s1].reshape(-1, n_coef, n_spl)
            p, state_n = model.update(p, cfs, phase + 1, horizon)
            for (ix, iv, ia) in obstacle_idx:
                pos, vel, acc = p[:, ix], p[:, iv], p[:, ia]
                p[:, ix] = pos + vel * dt + 0.5 * acc * dt * dt
                p[:, iv] = vel + acc * dt
            for (ic, cshape, M_obs) in traj_obstacle_idx:
                cfs_o = p[:, ic].reshape(-1, *cshape)
                p[:, ic] = (M_obs @ cfs_o).reshape(p.shape[0], -1)
            return p, state_n

        if budgets is not None:
            (hard_outer, hard_inner), (easy_outer, easy_inner) = budgets
            hard = (self.make_solver(
                self._alm_options._replace(inner_iter=hard_inner)),
                hard_outer)
            easy = (self.make_solver(
                self._alm_options._replace(inner_iter=easy_inner)),
                easy_outer)

        def rollout(st, p, state, consts: Optional[CompactConsts] = None,
                    on_step=None):
            C = consts if consts is not None else self.consts()
            operands(C, 0, p)                   # the structure's consts
            streak = torch.zeros(st.feas_raw.shape, dtype=torch.int32,
                                 device=st.x.device)
            states = []
            for k in range(n_steps):
                if budgets is None:
                    solver_fn, n_outer = solver, outer_iter
                else:
                    solver_fn, n_outer = hard if (k % spk == 0 and k > 0) \
                        else easy
                with record_function("rollout.solve"):
                    st, p, state, streak = solve_step(
                        solver_fn, n_outer, C, (st, p, state, streak), k)
                if rescue_lanes:
                    with record_function("rollout.rescue"):
                        st = rescue(C, st, p, state, k % spk)
                with record_function("rollout.plant"):
                    p, state = plant_step(st, p, k)
                states.append(state)
                if on_step is not None:
                    on_step(k)
            return (st, p, state), torch.stack(states, dim=1)

        return rollout

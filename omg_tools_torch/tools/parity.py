"""Trajectory parity against the independent CPU reference solver
(counterpart of the JAX package's ``tools/parity.py``).

The port's solvers are held to scipy's SLSQP (``ops/refsolver.py``)
solving the same transcribed NLP in float64 on the CPU:

- ``openloop_parity``: walk the reference rollout and, at every step, solve
  the same (x_warm, p) with the runner's solver, its own multiplier warm
  state carried along; compare the one-period-ahead planned states.  This
  is bench.py's gate.  Unlike the JAX harness, which always solves through
  the compact ``ct`` path, it solves through the runner's own structure:
  K3 (``fshared``) while the runner has a fused plan, K1/K2 (``ct``)
  otherwise -- so the gate judges the path that is timed.

``cached_reference_rollout`` keeps each reference record in the port's
cache (``utils.cache``), keyed on the runner's problem fingerprint and the
scenario.
"""

from __future__ import annotations

import copy
import hashlib

import numpy as np
import torch

__all__ = ["build_p2p_holonomic", "cached_reference_rollout",
           "openloop_parity", "reference_key"]


def build_p2p_holonomic(backend="alm", solver_options=None, start=None,
                        goal=None, options=None):
    """bench.py's p2p_holonomic scene (the README example: two rectangles
    and one circle, fixed 10 s horizon), initialized.  ``options``: more
    problem options, e.g. ``{"device": "cpu"}`` (the default device is
    CUDA) or ``{"exploit_structure": True}``."""
    from omg_tools_torch import (Holonomic, Environment, Obstacle, Rectangle,
                                 Circle, Square, Point2point)
    vehicle = Holonomic()
    vehicle.set_initial_conditions(list(start) if start is not None
                                   else [-1.5, -1.5])
    vehicle.set_terminal_conditions(list(goal) if goal is not None
                                    else [2.0, 2.0])
    environment = Environment(room={"shape": Square(5.0)})
    environment.add_obstacle(Obstacle(
        {"position": [-2.1, -0.5]}, shape=Rectangle(width=3.0, height=0.2)))
    environment.add_obstacle(Obstacle(
        {"position": [1.7, -0.5]}, shape=Rectangle(width=3.0, height=0.2)))
    environment.add_obstacle(Obstacle(
        {"position": [1.5, 0.5]}, shape=Circle(0.4)))
    problem = Point2point(vehicle, environment, freeT=False)
    opts = {"verbose": 0, "solver": backend, **(options or {})}
    if solver_options:
        opts["solver_options"] = solver_options
    problem.set_options(opts)
    problem.init()
    return problem


def _host_model(runner):
    """The runner's rollout recipe in float64 on the CPU (the reference's
    plant update)."""
    from omg_tools_torch.problems.rollout_models import make_rollout_model
    host = copy.copy(runner)
    host.dtype = torch.float64
    host.device = torch.device("cpu")
    return make_rollout_model(host)


def _reference_rollout(runner, x0, p0, n_steps, record_inputs=False):
    """Host replication of the runner's rollout for one scenario with
    every NLP solved by the scipy reference (raw units, float64, CPU): the
    same warm-start shift, ideal plant update (the runner's model recipe)
    and obstacle propagation."""
    from omg_tools_torch.ops.refsolver import make_ref_solver

    tr = runner.tr
    solve = make_ref_solver(tr.objective, tr.constraints, tr.n_x,
                            tr.lb, tr.ub)
    lb, ub = tr.bounds(0.0)
    # the warm-start shift in float64, whatever the runner's dtype
    M = tr.spline_shift_matrix(lambda basis: basis.shiftoverknot_T())
    spk = runner.steps_per_knot
    dt = runner.update_time
    n_coef, n_spl = runner.spline_shape
    model = _host_model(runner)

    x = np.asarray(x0, dtype=np.float64).copy()
    p = np.asarray(p0, dtype=np.float64).copy()
    states, inputs, feas = [], [], []
    x_in, p_in = [], []
    for k in range(n_steps):
        phase = k % spk
        if phase == 0 and k > 0:
            x = M @ x
        p[runner.i_t] = phase * dt
        if record_inputs:
            x_in.append(x.copy())
            p_in.append(p.copy())
        st = solve(x, p, lb, ub)
        x = st.x
        feas.append(float(st.feas))
        cfs = torch.as_tensor(x[runner.i_splines].reshape(1, n_coef, n_spl))
        p_t, state = model.update(torch.as_tensor(p)[None], cfs, phase + 1,
                                  runner.horizon)
        p = p_t[0].numpy().copy()
        states.append(state[0].numpy())
        inputs.append((model.E1[phase + 1] @ cfs[0]).numpy()
                      / runner.horizon)
        for (ix, iv, ia) in runner.obstacle_idx:
            pos, vel, acc = p[ix].copy(), p[iv].copy(), p[ia].copy()
            p[ix] = pos + vel * dt + 0.5 * acc * dt * dt
            p[iv] = vel + acc * dt
    if record_inputs:
        return {"states": np.asarray(states), "inputs": np.asarray(inputs),
                "feas": np.asarray(feas), "x_in": np.asarray(x_in),
                "p_in": np.asarray(p_in)}
    return np.asarray(states), np.asarray(inputs), np.asarray(feas)


def reference_key(runner, x0, p0, n_steps):
    """The cache key of a reference rollout record (name ``refroll``)."""
    h = hashlib.sha256()
    h.update(np.asarray(x0, np.float64).tobytes())
    h.update(np.asarray(p0, np.float64).tobytes())
    h.update(np.asarray([n_steps]).tobytes())
    return f"{runner._cache_key}_parity3_{h.hexdigest()[:12]}"


def cached_reference_rollout(runner, x0, p0, n_steps):
    """The reference rollout record (states and each step's solve inputs),
    from the port's cache or computed and stored there."""
    from omg_tools_torch.utils import cache as _cache

    x0 = np.asarray(x0, np.float64)
    p0 = np.asarray(p0, np.float64)
    key = reference_key(runner, x0, p0, n_steps)
    hit = _cache.load_tensors(key, "refroll")
    if hit is not None:
        return hit
    ref = _reference_rollout(runner, x0, p0, n_steps, record_inputs=True)
    _cache.store_tensors(key, "refroll", ref)
    return ref


def openloop_parity(runner, x0, p0, n_steps, outer_iter=2, budgets=None,
                    ref=None):
    """Per-solve control parity along the reference trajectory.

    The closed-loop deviation compounds and bifurcates at obstacle
    decision boundaries (two optima within solver tolerance), so it cannot
    separate solver error from plan multiplicity.  This metric can: at
    every step of the reference rollout the runner's solver solves the same
    (x_warm, p) -- a batch of one on the runner's device, through the
    runner's own structure -- and the one-period-ahead planned states of
    the two solutions are compared.

    ``ref``: a record of ``cached_reference_rollout``.  Returns a dict with
    per_step (n_steps,) errors, their max and the reference's largest
    violation."""
    from omg_tools_torch.ops.compact import resolve_phase
    from omg_tools_torch.problems.batch import _fused_operands

    if ref is None:
        ref = cached_reference_rollout(runner, x0, p0, n_steps)
    spk = runner.steps_per_knot
    n_coef, n_spl = runner.spline_shape
    s0 = int(runner.i_splines[0])
    model = runner.model
    consts = runner.consts()
    dev = dict(dtype=runner.dtype, device=runner.device)

    def solver_of(solver_fn, n_outer):
        def solve_fn(st_in, x_warm, p, phase):
            fs = _fused_operands(runner.fused_plan, consts, phase)
            if fs is not None:
                return solver_fn(x_warm, p, consts.lb, consts.ub,
                                 state0=st_in, outer_iter=n_outer,
                                 fshared=fs)
            ct = resolve_phase(runner.compact, consts.CT, phase, p)
            return solver_fn(x_warm, p, consts.lb, consts.ub, state0=st_in,
                             outer_iter=n_outer, ct=ct)
        return solve_fn

    if budgets is not None:
        (ho, hi), (eo, ei) = budgets
        hard = solver_of(runner.make_solver(
            runner._alm_options._replace(inner_iter=hi)), ho)
        easy = solver_of(runner.make_solver(
            runner._alm_options._replace(inner_iter=ei)), eo)
    else:
        hard = easy = solver_of(runner.solver, outer_iter)

    # the initial warm state: the converged cold solve the rollout starts
    # from
    st = runner.init_solver_state(torch.as_tensor(x0, **dev)[None],
                                  torch.as_tensor(p0, **dev)[None], consts)
    errs = []
    for k in range(n_steps):
        phase = k % spk
        p_k = torch.as_tensor(ref["p_in"][k], **dev)[None]
        if k > 0:
            # warm start from the reference iterate, the runner's budgets
            x_warm = torch.as_tensor(ref["x_in"][k], **dev)[None]
            inf = torch.full_like(st.feas, float("inf"))
            st_in = st._replace(x=x_warm, feas=inf, stat=inf,
                                n_iter=torch.zeros_like(st.n_iter))
            fn = hard if phase == 0 else easy
            st = fn(st_in, x_warm, p_k, phase)
        # k == 0: the step-0 solution is the cold solve above, exactly
        # what the rollout executes
        cfs = st.x[:, s0:s0 + n_coef * n_spl].reshape(1, n_coef, n_spl)
        _, state_dev = model.update(p_k, cfs, phase + 1, runner.horizon)
        errs.append(float(np.max(np.abs(
            state_dev[0].double().cpu().numpy() - ref["states"][k]))))
    errs = np.asarray(errs)
    return {"per_step": errs, "openloop_max_err": float(errs.max()),
            "ref_feas_max": float(ref["feas"].max())}

"""Problem base class: the build/solve/simulate lifecycle (counterpart of
``omg_tools_tpu.problems.problem``).

- ``init()``: the layout-pass transcription over all children, the
  one-time host precomputation (Ipopt-style gradient row scaling and the
  objective scale, by ``torch.func`` AD in float64 on the CPU, cached on
  disk by ``utils.cache``) and the solver: the ALM (generic, or dense
  quadratic under the ``exploit_structure`` option), the interior-point
  method (``solver="ipm"``, ``ops.solver``) or the scipy reference
  (``solver="scipy"``);
- ``solve()``: warm start, parameter packing, one solve on the problem's
  device, and the failure policy: a failed result (the ALM and scipy: an
  infeasible one; the IPM: a KKT error above 100 tol) triggers a fresh
  guess and one immediate retry, keeping the better iterate (the more
  feasible one; the IPM's lower KKT error);
- ``predict/simulate/sleep`` fan out to the vehicles and the environment.

The problem's options ``device`` (None: CUDA, which must then exist at the
first solve) and ``dtype`` (float64 by default, as in the JAX package)
place the ALM's and the IPM's tensors; the scipy reference always runs
in float64 on the CPU.

A problem over several vehicles (a ``Fleet``) is the distributed
problems' base (``problems.admm``).
"""

from __future__ import annotations

import time as _time
from typing import Dict, List

import numpy as np
import torch
from torch.func import grad, jacfwd

from ..modeling.opti import OptiChild, OptiFather
from ..models.fleet import get_fleet_vehicles
from ..ops.solver import gradient_row_scales
from ..utils import cache as _cache
from ..execution.plotlayer import PlotLayer, mix_with_white
from .batch import pin_full_f32, resolve_device

__all__ = ["Problem"]


class Problem(OptiChild, PlotLayer):

    def __init__(self, fleet, environment, options=None, label="problem"):
        OptiChild.__init__(self, label)
        self.fleet, self.vehicles = get_fleet_vehicles(fleet)
        self.environment = environment
        self.set_default_options()
        self.set_options(options or {})
        self.iteration = 0
        self.update_times: List[float] = []

    # -- options -----------------------------------------------------------
    def set_default_options(self):
        self.options = {
            "verbose": 2,
            "solver": "alm",  # 'alm' (default), 'ipm' or 'scipy'
            "solver_options": {"max_iter": 60, "tol": 1e-4},
            "dtype": "float64",
            "device": None,   # None: CUDA
        }

    def set_options(self, options):
        for key, val in options.items():
            if key == "solver_options":
                self.options["solver_options"].update(val)
            else:
                self.options[key] = val

    # -- build -------------------------------------------------------------
    def init(self):
        backend = self.options.get("solver", "alm")
        self.children = (list(self.vehicles) + self.environment.obstacles
                         + [self.environment, self])
        self.father = OptiFather(self.children)
        t0 = _time.time()
        self.transcription = self.father.transcribe(self.construct)
        tr = self.transcription
        sopts = self.options["solver_options"]
        f = tr.objective
        g = tr.constraints
        # Ipopt-style gradient-based row scaling at the initial guess
        # (one-time host AD in float64, cached on disk)
        x_ref = torch.as_tensor(tr.initial_guess())
        p_base = self.pack_parameters(0.0)
        p_ref = torch.as_tensor(p_base)
        key = _cache.problem_fingerprint(tr, p_base)
        tr.fingerprint = key
        hit = _cache.load_tensors(key, "scales")
        if hit is not None:
            row_scale, grad0 = hit["row_scale"], hit["grad0"]
        else:
            row_scale = gradient_row_scales(jacfwd(g), x_ref, p_ref)
            grad0 = grad(f)(x_ref, p_ref).numpy()
            _cache.store_tensors(key, "scales", {"row_scale": row_scale,
                                                 "grad0": grad0})
        self._row_scale = row_scale
        self._obj_scale = 1.0 / max(1.0, np.max(np.abs(grad0)) / 100.0)
        self._backend = backend
        if backend == "scipy":
            # the independent CPU reference (parity trust anchor), in raw
            # units: its feas compares directly with the 1e-3 failure level
            from ..ops.refsolver import make_ref_solver
            self._solver = make_ref_solver(
                f, g, tr.n_x, tr.lb, tr.ub, tol=sopts.get("tol", 1e-7),
                max_iter=sopts.get("max_iter", 300))
            self._structure = "scipy"
        elif backend == "ipm":
            from ..ops.solver import IPOptions, make_ip_solver
            self._solver = make_ip_solver(
                f, g, tr.n_x, tr.lb, tr.ub,
                IPOptions(max_iter=sopts.get("max_iter", 60),
                          tol=sopts.get("tol", 1e-4)),
                row_scale=row_scale, obj_scale=self._obj_scale,
                fg=tr.objective_and_constraints)
            self._structure = "ipm"
        else:
            from ..ops.alm import (make_alm_solver, ALMOptions,
                                   detect_quadratic_structure)
            alm_options = ALMOptions(
                outer_iter=sopts.get("outer_iter", 20),
                inner_iter=sopts.get("inner_iter", 16),
                tol=sopts.get("tol", 1e-3),
                feas_tol=sopts.get("feas_tol", 1e-5))
            quadratic_Q = None
            if self.options.get("exploit_structure", False):
                try:
                    quadratic_Q = detect_quadratic_structure(
                        g, tr.n_x, p_ref, f=f)
                except (RuntimeError, ValueError):
                    quadratic_Q = None
            self._Q_raw = quadratic_Q
            self._structure = ("quadratic" if quadratic_Q is not None
                               else "generic")
            self._solver = make_alm_solver(
                f, g, tr.n_x, tr.lb, tr.ub, alm_options,
                row_scale=row_scale, obj_scale=self._obj_scale,
                quadratic_Q=quadratic_Q, fg=tr.objective_and_constraints)
        self._shifted = False
        self._x_result = tr.initial_guess()
        self._ip_state = None
        self.init_transformations()
        if self.options["verbose"] >= 2:
            print(f"[{self.label}] transcribed: n_x={tr.n_x} "
                  f"n_g={tr.n_g} n_p={tr.n_p} "
                  f"({_time.time() - t0:.2f}s)")

    def init_transformations(self):
        """Precompute the warm-start shift matrices."""
        self._primal_transform = None
        tf = getattr(self, "init_primal_transform", None)
        if tf is not None:
            self._primal_transform = self.transcription.spline_shift_matrix(tf)

    def reinitialize(self, father=None):
        """Reset the warm start to a fresh guess for the *current*
        conditions: the layout pass re-runs, so that the straight-line
        spline guesses and hyperplane warm starts follow the present vehicle
        prediction and obstacle positions."""
        tr = self.transcription
        tr.relayout()
        self._x_result = tr.initial_guess().copy()
        self._ip_state = None

    # -- solve -------------------------------------------------------------
    def _run_solver(self, parameters, lb, ub, state=None, reslack=False):
        """One solve from ``self._x_result``: the scipy reference on host
        float64 arrays (its state holds numpy values), the ALM or the IPM
        on a batch of one on the problem's device (its state holds device
        tensors).  The IPM warm-starts from ``state`` at x = x_result,
        with its slacks re-centred under ``reslack``."""
        if self._backend == "scipy":
            return self._solver(self._x_result, parameters, lb, ub,
                                state0=state)
        device = resolve_device(self.options.get("device"))
        dtype = getattr(torch, self.options["dtype"])
        pin_full_f32()
        x0 = torch.as_tensor(self._x_result, dtype=dtype,
                             device=device)[None]
        p = torch.as_tensor(parameters, dtype=dtype, device=device)[None]
        if self._backend == "ipm":
            if state is None:
                return self._solver(x0, p, lb, ub)
            return self._solver(x0, p, lb, ub, state0=state._replace(x=x0),
                                reslack=reslack)
        return self._solver(x0, p, lb, ub, state0=state)

    def _accept(self, st):
        """Keep ``st`` as the warm state and its x as the result."""
        self._ip_state = st
        x = st.x[0].cpu().numpy() if isinstance(st.x, torch.Tensor) \
            else st.x
        self._x_result = np.array(x, dtype=np.float64)  # owned copy

    @staticmethod
    def _stats(st, seconds):
        def value(a):
            return float(a.reshape(-1)[0]) if isinstance(a, torch.Tensor) \
                else float(a)
        stats = {"kkt_err": value(st.kkt_err),
                 "iterations": int(value(st.n_iter)), "time": seconds}
        if hasattr(st, "feas"):     # the IPM's state carries no feas
            stats["feas"] = value(st.feas)
        return stats

    def _failed(self, stats):
        """A failed solve: an infeasible result (the ALM and the scipy
        reference: feasibility is the trust anchor), or for the IPM a KKT
        error above 100 tol."""
        if "feas" in stats:
            return stats["feas"] > 1e-3
        tol = self.options["solver_options"].get("tol", 1e-4)
        return stats["kkt_err"] > 100 * tol

    @staticmethod
    def _better(new, old):
        """The retry's result is kept when it is more feasible (the IPM:
        has the lower KKT error)."""
        key = "feas" if "feas" in old else "kkt_err"
        return new[key] < old[key]

    def solve(self, current_time, update_time):
        current_time -= self.start_time  # relative time within the problem
        self.init_step(current_time, update_time)
        parameters = self.pack_parameters(current_time)
        t_sym = self.time_parameter(current_time)
        lb, ub = self.transcription.bounds(t_sym)
        t0 = _time.time()
        # warm start the primal and dual state from the previous MPC step;
        # after a basis shift the IPM re-centres its slacks and bound
        # duals (the ALM has no slacks to re-centre)
        st = self._run_solver(parameters, lb, ub, self._ip_state,
                              reslack=self._shifted)
        self._shifted = False
        self._accept(st)
        t_upd = _time.time() - t0
        self.solver_stats = self._stats(st, t_upd)
        if self._failed(self.solver_stats):
            if self.options["verbose"] >= 1:
                print(f"[{self.label}] solve did not converge "
                      f"(kkt_err={self.solver_stats['kkt_err']:.2e}) -- "
                      "resetting guess")
            self.reinitialize()
            # one immediate retry from the fresh guess, never executing the
            # diverged iterate: keep the better of the two
            st2 = self._run_solver(parameters, lb, ub)
            stats2 = self._stats(st2, _time.time() - t0)
            if self._better(stats2, self.solver_stats):
                self._accept(st2)
                self.solver_stats = stats2
        self.update_times.append(t_upd)
        self.iteration += 1
        if self.options["verbose"] >= 2:
            if (self.iteration - 1) % 20 == 0:
                print("----|------------|------------")
                print("%3s | %10s | %10s " % ("it", "t upd", "kkt err"))
                print("----|------------|------------")
            print("%3d | %.4e | %.4e " % (self.iteration, t_upd,
                                          self.solver_stats["kkt_err"]))

    def pack_parameters(self, current_time) -> np.ndarray:
        values: Dict = {}
        for child in self.children:
            for obj, d in child.set_parameters(current_time).items():
                values[obj] = {**values.get(obj, {}), **d}
        return self.transcription.pack_parameters(values)

    def time_parameter(self, current_time):
        """Value of the 't' parameter used for constraint shutdown."""
        return float(current_time)

    def get_variables(self, child, name, x=None) -> np.ndarray:
        sl, shape = self.transcription.var_slice(child, name)
        x = self._x_result if x is None else x
        return np.asarray(x[sl]).reshape(shape)

    def set_variables(self, value, child, name):
        sl, shape = self.transcription.var_slice(child, name)
        self._x_result[sl] = np.asarray(value, dtype=np.float64).reshape(-1)

    def transform_primal_splines(self, matrix):
        self._x_result = matrix @ self._x_result
        self._shifted = True

    # -- lifecycle hooks ---------------------------------------------------
    def construct(self):
        """Declare shared symbols and let environment/vehicles register.
        Subclasses extend."""
        self.environment.init()

    def init_step(self, current_time, update_time):
        pass

    def initialize(self, current_time):
        self.start_time = current_time

    def predict(self, current_time, predict_time, sample_time, states=None,
                delay=0, enforce_states=False, enforce_inputs=False):
        if states is None:
            states = [None] * len(self.vehicles)
        if not isinstance(states, list):
            states = [states]
        if current_time == self.start_time:
            # first iteration: integrate from the current state
            enforce_states = True
        for k, vehicle in enumerate(self.vehicles):
            vehicle.predict(current_time, predict_time, sample_time,
                            states[k], delay=delay,
                            enforce_states=enforce_states,
                            enforce_inputs=enforce_inputs)

    def simulate(self, current_time, simulation_time, sample_time):
        for vehicle in self.vehicles:
            vehicle.simulate(simulation_time, sample_time)
        self.environment.simulate(simulation_time, sample_time)

    def sleep(self, current_time, sleep_time, sample_time):
        """Hold position for sleep_time (omgtools problem.py:187-207)."""
        for vehicle in self.vehicles:
            spline_values = vehicle.signals["state"][:, -1]
            n = len(vehicle.basis)
            coeffs = np.tile(spline_values[:vehicle.n_spl], (n, 1))
            vehicle.store(current_time, sample_time, [coeffs], sleep_time)
            vehicle.simulate(sleep_time, sample_time)
        self.environment.simulate(sleep_time, sample_time)

    # -- 'scene' plot provider (omgtools problem.py:213-255) ----------------
    def _scene_counts(self):
        env_s, env_l = self.environment.draw(t=-1)
        veh = []
        for vehicle in self.vehicles:
            s = sum(len(shape.draw()[0]) for shape in vehicle.shapes)
            l = sum(len(shape.draw()[1]) for shape in vehicle.shapes)
            veh.append((s, l))
        return len(env_s), len(env_l), veh

    def init_plot(self, argument, **kwargs):
        if argument != "scene":
            return None
        n_env_s, n_env_l, veh = self._scene_counts()
        n_dim = self.environment.n_dim
        lines = [{"color": "0.25"} for _ in range(n_env_s + n_env_l)]
        colors = ["tab:blue", "tab:orange", "tab:green", "tab:red",
                  "tab:purple", "tab:brown", "tab:pink", "tab:olive"]
        for k, (n_s, n_l) in enumerate(veh):
            color = colors[k % len(colors)]
            lines.append({"color": color})                      # past path
            lines.append({"color": mix_with_white(color, 60.0),
                          "linestyle": "--"})                   # predicted
            lines += [{"color": color} for _ in range(n_s + n_l)]  # shape
        ax_info = {"labels": [f"x{k}" for k in range(n_dim)],
                   "lines": lines, "aspect_equal": True}
        if n_dim == 3:
            ax_info["projection"] = "3d"
        room = self.environment.room[0]
        try:
            lims = room["shape"].get_canvas_limits()
        except NotImplementedError:
            return [[ax_info]]
        ax_info["xlim"] = (lims[0][0] + room["position"][0] - 0.2,
                           lims[0][1] + room["position"][0] + 0.2)
        ax_info["ylim"] = (lims[1][0] + room["position"][1] - 0.2,
                           lims[1][1] + room["position"][1] + 0.2)
        return [[ax_info]]

    def update_plot(self, argument, t, **kwargs):
        if argument != "scene":
            return None
        env_s, env_l = self.environment.draw(t)
        lines = [np.asarray(a, dtype=np.float64) for a in env_s + env_l]
        for vehicle in self.vehicles:
            pose = np.atleast_2d(vehicle.signals.get(
                "pose", np.zeros((vehicle.n_dim, 1))))
            end = pose.shape[1] if t in (-1, None) else t + 1
            lines.append(pose[:vehicle.n_dim, :end])
            traj = vehicle._traj_at(t)
            if traj is not None and "pose" in traj:
                lines.append(np.atleast_2d(traj["pose"])[:vehicle.n_dim])
            else:
                lines.append(np.zeros((vehicle.n_dim, 0)))
            if "pose" in vehicle.signals:
                s, l = vehicle.draw(min(t, pose.shape[1] - 1)
                                    if t not in (-1, None) else -1)
            else:
                s, l = [], []
                for shape in vehicle.shapes:
                    ss, ll = shape.draw()
                    s += ss
                    l += ll
            lines += [np.asarray(a, dtype=np.float64) for a in s + l]
        return [[lines]]

    def compute_objective(self):
        raise NotImplementedError

    def stop_criterium(self, current_time, update_time):
        raise NotImplementedError

    def final(self):
        pass

    def store(self, current_time, update_time, sample_time):
        raise NotImplementedError

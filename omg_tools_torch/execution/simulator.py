"""Closed-loop MPC simulation + deployment API (a copy of
``omg_tools_tpu.execution.simulator``; it holds no array code of its own).

Mirrors omgtools' execution/simulator.py and deployer.py: Simulator.run
drives the receding-horizon loop (deployer.update -> problem.simulate ->
stop_criterium) with adaptive final-step timing; Deployer exposes the
real-system update API (predict -> solve -> store).
"""

from __future__ import annotations

import numpy as np

from .plotlayer import PlotLayer

__all__ = ["Simulator", "Deployer"]


class Deployer:

    def __init__(self, problem, sample_time=0.01, update_time=0.1):
        self.problem = problem
        self.sample_time = sample_time
        self.update_time = update_time
        self.current_time = 0.0
        self.iteration0 = True

    def reset(self):
        self.iteration0 = True
        self.problem.reinitialize()

    def update(self, current_time, states=None, inputs=None, dinputs=None,
               update_time=None, enforce_states=False, enforce_inputs=False):
        current_time = float(current_time)
        if update_time is None:
            update_time = self.update_time
        veh = self.problem.vehicles[0]
        traj_time = None if self.iteration0 else \
            getattr(veh, "trajectories", {}).get("time")
        t_end = None if traj_time is None else \
            float(np.asarray(traj_time).ravel()[-1])
        if t_end is not None:
            # omgtools deployer.py:47-55: when less than update_time of
            # stored trajectory remains, shrink update_time to the
            # remainder so predict/store never run past the horizon end
            remaining = t_end - self.current_time
            if remaining > 0 and round(update_time - remaining,
                                       4) >= self.sample_time:
                update_time = remaining
        if self.iteration0:
            self.iteration0 = False
            self.problem.initialize(current_time)
            delay = 0
        else:
            # hardware delay compensation (omgtools deployer.py:43-79):
            # when the caller's clock drifted from the control period
            # since the previous update (a slow solve on a real system),
            # shift the predict window by the measured extra samples --
            # negative drift (early call) shifts backward, as in
            # omgtools, bounded so the window start stays in the stored
            # trajectory
            delay = int(round(
                (current_time - self.current_time - update_time)
                / self.sample_time))
            delay = max(delay, -int(np.round(update_time
                                             / self.sample_time, 6)))
            # if update_time + delay overruns the stored trajectory,
            # leave out the delay (omgtools deployer.py:63-66)
            if t_end is not None and delay != 0:
                n_left = int(np.round(
                    (t_end - self.current_time) / self.sample_time, 6))
                if delay + int(np.round(update_time / self.sample_time,
                                        6)) > n_left:
                    delay = 0
        self.problem.predict(current_time, update_time, self.sample_time,
                             states, delay, enforce_states, enforce_inputs)
        self.problem.solve(current_time, update_time)
        self.problem.store(current_time, update_time, self.sample_time)
        self.current_time = current_time
        self.update_dashboard(current_time)
        return {v: v.trajectories for v in self.problem.vehicles}

    def update_segment(self, current_time, states=None, max_retries=20,
                       feas_tol=1e-3, perturbation=0.05):
        """Segment-wise G-code deployment update with infeasibility
        recovery: on a failed solve, roll the trajectories back, perturb the
        predicted state along the active segment's direction and retry, up
        to ``max_retries`` attempts (omgtools deployer.py:81-239)."""
        problem = self.problem
        vehicles = problem.vehicles
        snapshots = [({k: v.copy() for k, v in veh.trajectories.items()},
                      {k: v.copy() for k, v in veh.prediction.items()})
                     for veh in vehicles]
        direction = None
        segments = getattr(problem, "segments_all", None)
        if segments is not None:
            seg = segments[getattr(problem, "window_start", 0)]
            d = np.asarray(seg["end"], dtype=np.float64) \
                - np.asarray(seg["start"], dtype=np.float64)
            nrm = np.linalg.norm(d)
            direction = d / nrm if nrm > 0 else None
        for attempt in range(max_retries + 1):
            result = self.update(current_time, states=states)
            feas = problem.solver_stats.get(
                "feas", problem.solver_stats.get("kkt_err", 0.0))
            if feas <= feas_tol:
                self.update_dashboard(current_time)
                return result
            # rollback + perturb the prediction along the segment line
            for veh, (traj, pred) in zip(vehicles, snapshots):
                veh.trajectories = {k: v.copy() for k, v in traj.items()}
                veh.prediction = {k: v.copy() for k, v in pred.items()}
                if direction is not None and "state" in veh.prediction:
                    n = min(len(direction), veh.prediction["state"].shape[0])
                    veh.prediction["state"][:n] += (perturbation
                                                    * (attempt + 1)
                                                    * direction[:n])
            problem.reinitialize()
        return None  # infeasible after all retries

    # -- live dashboards (omgtools deployer.py:241-357) -------------------
    def init_dashboard(self, show=False):
        """Per-axis state/velocity/acceleration panels + a scene panel with
        the room outlines and the current planned trajectory, refreshed on
        every (segment) update.  Headless-capable: figures render on the
        Agg canvas unless ``show``."""
        import matplotlib
        if not show:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        self._dash_show = show
        veh = self.problem.vehicles[0]
        n_dim = getattr(veh, "n_dim", 2)
        self._dash = {}
        for name in ("state", "input", "dinput"):
            fig, axes = plt.subplots(n_dim, 1, sharex=True, squeeze=False)
            units = {"state": "m", "input": "m/s", "dinput": "m/s^2"}[name]
            for k in range(n_dim):
                axes[k, 0].plot([], [], zorder=0)
                axes[k, 0].set_ylabel(f"{name}[{k}] [{units}]")
            axes[-1, 0].set_xlabel("t [s]")
            self._dash[name] = (fig, axes)
        fig, ax = plt.subplots(1, 1)
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        ax.set_aspect("equal")
        self._dash["scene"] = (fig, ax)
        return self._dash

    def update_dashboard(self, current_time=None):
        """Refresh the dashboard panels from the stored trajectories."""
        if not hasattr(self, "_dash"):
            return
        import matplotlib.pyplot as plt
        veh = self.problem.vehicles[0]
        traj = veh.trajectories
        t = np.asarray(traj.get("time", np.zeros(0))).reshape(-1)
        for name in ("state", "input", "dinput"):
            if name not in traj or name not in self._dash:
                continue
            fig, axes = self._dash[name]
            data = np.atleast_2d(traj[name])
            n = min(t.size, data.shape[1]) or data.shape[1]
            xs = t[:n] if t.size else np.arange(data.shape[1])
            for k in range(min(data.shape[0], axes.shape[0])):
                axes[k, 0].lines[0].set_data(xs, data[k, :len(xs)])
                axes[k, 0].relim()
                axes[k, 0].autoscale_view()
        fig, ax = self._dash["scene"]
        for ln in list(ax.lines):
            ln.remove()
        for room in self.problem.environment.room:
            lims = room["shape"].get_canvas_limits()
            x0, x1 = lims[0] + room["position"][0]
            y0, y1 = lims[1] + room["position"][1]
            ax.plot([x0, x1, x1, x0, x0], [y0, y0, y1, y1, y0],
                    color="red", linestyle="--", linewidth=1.2, zorder=0)
        if "state" in traj:
            S = np.atleast_2d(traj["state"])
            ax.plot(S[0], S[1], color="gray", linewidth=1.2)
            ax.plot([S[0, -1]], [S[1, -1]], marker="o", color="tab:blue")
        if self._dash_show:
            plt.pause(0.01)
        return self._dash

    def save_results(self, name="results", path="results/"):
        """CSV dump of every vehicle's simulated signals
        (omgtools deployer.py:359-364)."""
        import csv
        import os
        os.makedirs(path, exist_ok=True)
        files = []
        for k, veh in enumerate(self.problem.vehicles):
            target = os.path.join(path, f"{name}_vehicle{k}.csv")
            sig = veh.signals
            keys = [key for key in ("time", "state", "input", "pose")
                    if key in sig]
            rows = np.vstack([np.atleast_2d(sig[key]) for key in keys])
            header = []
            for key in keys:
                n = np.atleast_2d(sig[key]).shape[0]
                header += [key if n == 1 else f"{key}{i}" for i in range(n)]
            with open(target, "w", newline="") as fh:
                writer = csv.writer(fh)
                writer.writerow(header)
                writer.writerows(rows.T)
            files.append(target)
        return files


class Simulator:

    def __init__(self, problem, sample_time=0.01, update_time=0.1):
        self.problem = problem
        self.sample_time = sample_time
        self.update_time = update_time
        self.current_time = 0.0
        self.deployer = Deployer(problem, sample_time, update_time)
        # class-level back-pointer used by plot time indexing
        # (omgtools simulator.py:32)
        PlotLayer.simulator = self

    def set_problem(self, problem):
        self.problem = problem
        self.deployer.problem = problem

    def run(self, init_reset=True, max_steps=10000):
        """Closed MPC loop until the problem's stop criterion fires
        (omgtools simulator.py:39-62)."""
        if init_reset:
            self.deployer.reset()
        self.current_time = 0.0
        stop = False
        steps = 0
        while not stop and steps < max_steps:
            stop = self.update()
            steps += 1
        self.problem.final()
        trajectories, signals = {}, {}
        for vehicle in self.problem.vehicles:
            trajectories[str(vehicle)] = vehicle.trajectories
            signals[str(vehicle)] = vehicle.signals
        return trajectories, signals

    def update(self):
        """One MPC cycle: solve + plant simulation
        (omgtools simulator.py:92-111)."""
        self.deployer.update(self.current_time)
        self.problem.simulate(self.current_time, self.update_time,
                              self.sample_time)
        self.current_time += self.update_time
        return bool(self.problem.stop_criterium(self.current_time,
                                                self.update_time))

    def step(self, update_time=None):
        """Single open cycle returning the new state
        (omgtools simulator.py:64-90)."""
        update_time = update_time or self.update_time
        self.deployer.update(self.current_time)
        self.problem.simulate(self.current_time, update_time,
                              self.sample_time)
        self.current_time += update_time
        return {v: v.signals["state"][:, -1] for v in self.problem.vehicles}

    def run_once(self, simulation_time=None, hard_stop=None):
        """Open-loop: one solve, then simulate the whole horizon
        (omgtools simulator.py:113-143)."""
        self.current_time = 0.0
        self.deployer.reset()
        self.deployer.update(self.current_time)
        if simulation_time is None:
            horizon = np.ravel(self.problem.vehicles[0].trajectories["time"])
            simulation_time = float(horizon[-1] - horizon[0])
        if hard_stop is not None:
            t_stop = hard_stop["time"]
            self.problem.simulate(self.current_time, t_stop, self.sample_time)
            for vehicle in self.problem.vehicles:
                vehicle.overrule_state(hard_stop["state"])
                vehicle.overrule_input(np.zeros_like(
                    vehicle.signals["input"][:, -1]))
        else:
            self.problem.simulate(self.current_time, simulation_time,
                                  self.sample_time)
        self.problem.final()
        trajectories, signals = {}, {}
        for vehicle in self.problem.vehicles:
            trajectories[str(vehicle)] = vehicle.trajectories
            signals[str(vehicle)] = vehicle.signals
        return trajectories, signals

    def sleep(self, sleep_time):
        self.problem.sleep(self.current_time, sleep_time, self.sample_time)
        self.current_time += sleep_time

    def time2index(self, time):
        return int(np.round(time / self.sample_time, 6))

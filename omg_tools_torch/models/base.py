"""Vehicle base class (counterpart of ``omg_tools_tpu.models.base``):
spline knot setup, spline decision variables, the 2D and 3D
separating-hyperplane + room collision constraints, trajectory storage and
the plant's prediction and simulation for the closed loop (host numpy).

Prediction and simulation use a fixed-step RK4 integrator with linear
input interpolation between samples, as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..modeling.opti import OptiChild, BIG
from ..ops.basis import Basis, clamped_knots
from ..ops.spline import BSpline, definite_integral, sample_spline
from ..execution.plotlayer import PlotLayer, mix_with_white

__all__ = ["Vehicle"]


class Vehicle(OptiChild, PlotLayer):

    def __init__(self, n_spl, degree, shapes, options=None):
        OptiChild.__init__(self, "vehicle")
        self.shapes = shapes if isinstance(shapes, list) else [shapes]
        self.n_dim = self.shapes[0].n_dim
        for s in self.shapes:
            if s.n_dim != self.n_dim:
                raise ValueError("all vehicle shapes must share one dimension")
        self.n_spl = n_spl
        self.degree = degree
        self.prediction: Dict[str, np.ndarray] = {}
        self.init_spline_values = None
        self.trajectories: Dict[str, np.ndarray] = {}
        self.signals: Dict[str, np.ndarray] = {}
        # per-update trajectory history for movie replay
        self.traj_storage: List[Dict[str, np.ndarray]] = []
        self.traj_times: List[float] = []
        self.set_default_options()
        self.set_options(options or {})
        self.define_knots(knot_intervals=10)

    # -- options -----------------------------------------------------------
    def set_default_options(self):
        self.options = {
            "safety_distance": 0.0, "safety_weight": 10.0,
            "room_constraints": True, "stop_tol": 1.0e-3,
            "ideal_prediction": False, "ideal_update": False,
            "1storder_delay": False, "time_constant": 0.1,
            "input_disturbance": None,
        }

    def set_options(self, options):
        self.options.update(options)

    # -- spline setup --------------------------------------------------------
    def define_knots(self, knot_intervals=None, knots=None):
        if knot_intervals is not None:
            self.knot_intervals = knot_intervals
            self.knots = clamped_knots(knot_intervals, self.degree)
        if knots is not None:
            self.knots = np.asarray(knots, dtype=np.float64)
            self.knot_intervals = None
        self.basis = Basis(self.knots, self.degree)

    def define_splines(self, n_seg=1):
        self.n_seg = n_seg
        if self.init_spline_values is not None:
            init = self.init_spline_values
        else:
            try:
                init = self.get_init_spline_value()
            except (AttributeError, TypeError):
                init = [None] * n_seg
        if len(init) < n_seg:
            init = list(init) + [init[-1]] * (n_seg - len(init))
        self.splines = [
            self.define_spline_variable(f"splines_seg{k}", self.n_spl,
                                        value=init[k])
            for k in range(n_seg)]
        return self.splines

    def set_init_spline_values(self, values, n_seg=1):
        self.init_spline_values = list(values)

    # -- generic collision constraints ------------------------------------
    def define_collision_constraints_2d(self, hyperplanes, room, positions,
                                        horizon_time, tg_ha=0, offset=0):
        """Separating-hyperplane + room constraints on the position splines,
        polynomial in tg_ha = tan(theta/2) so rotated shapes stay spline-
        transcribable."""
        t = self.problem_t
        safety_distance = self.options["safety_distance"]
        safety_weight = self.options["safety_weight"]
        positions = [positions] if not isinstance(positions[0], list) \
            else positions
        for s, shape in enumerate(self.shapes):
            position = positions[s]
            checkpoints, rad = shape.get_checkpoints()
            checkpoints = [[float(c) for c in chck] for chck in checkpoints]
            rad = [float(r) for r in rad]
            if shape in hyperplanes:
                for k, hyp in enumerate(hyperplanes[shape]):
                    a, b = hyp["a"], hyp["b"]
                    sl = hyp.get("slack", 1)
                    if safety_distance > 0.0:
                        eps = self.define_spline_variable(f"eps_{s}{k}")[0]
                        self.define_objective(
                            safety_weight * definite_integral(
                                eps, t / horizon_time, 1.0))
                        self.define_constraint(eps - safety_distance, -BIG, 0.0)
                        self.define_constraint(-eps, -BIG, 0.0)
                    else:
                        eps = 0.0
                    for l, chck in enumerate(checkpoints):
                        con = (a[0] * chck[0] + a[1] * chck[1]) * (1.0 - tg_ha ** 2) \
                            + (-a[0] * chck[1] + a[1] * chck[0]) * (2 * tg_ha)
                        pos0 = position[0] * (1 + tg_ha ** 2) + offset * (1 - tg_ha ** 2)
                        pos1 = position[1] * (1 + tg_ha ** 2) + offset * (2 * tg_ha)
                        con = con + (a[0] * pos0 + a[1] * pos1)
                        con = con + (-b + sl * rad[l] + safety_distance - eps) \
                            * (1 + tg_ha ** 2)
                        self.define_constraint(con, -BIG, 0.0)
            if self.options["room_constraints"]:
                self._define_room_constraints_2d(room, position, checkpoints,
                                                 rad, tg_ha, offset)

    def _define_room_constraints_2d(self, room, position, checkpoints, rad,
                                    tg_ha, offset):
        from ..environment.shapes import Rectangle, Square, Circle
        if "lims_param" in room:
            # parameter room borders; axis-aligned only
            lo, hi = room["lims_param"]
            room_lims = [[lo[k], hi[k]] for k in range(self.n_dim)]
            for l, chck in enumerate(checkpoints):
                for k in range(self.n_dim):
                    self.define_constraint(
                        -(chck[k] + position[k]) + room_lims[k][0] + rad[0],
                        -BIG, 0.0)
                    self.define_constraint(
                        (chck[k] + position[k]) - room_lims[k][1] + rad[0],
                        -BIG, 0.0)
            return
        lims = room["shape"].get_canvas_limits()
        room_lims = [[float(v) for v in lims[k] + room["position"][k]]
                     for k in range(self.n_dim)]
        axis_aligned = (isinstance(room["shape"], (Rectangle, Square))
                        and room["shape"].orientation == 0.0
                        and isinstance(tg_ha, (int, float)) and tg_ha == 0.0)
        veh_ok = all(isinstance(s, Circle)
                     or (isinstance(s, (Rectangle, Square))
                         and s.orientation == 0.0) for s in self.shapes)
        if axis_aligned and veh_ok:
            for l, chck in enumerate(checkpoints):
                for k in range(self.n_dim):
                    self.define_constraint(
                        -(chck[k] + position[k]) + room_lims[k][0] + rad[0],
                        -BIG, 0.0)
                    self.define_constraint(
                        (chck[k] + position[k]) - room_lims[k][1] + rad[0],
                        -BIG, 0.0)
        else:
            hyp_room = room["shape"].get_hyperplanes(
                position=room["position"])
            for hpp in hyp_room.values():
                hpp["a"] = [float(v) for v in hpp["a"]]
                hpp["b"] = float(hpp["b"])
            for l, chck in enumerate(checkpoints):
                for hpp in hyp_room.values():
                    con = (hpp["a"][0] * chck[0] + hpp["a"][1] * chck[1]) \
                        * (1.0 - tg_ha ** 2) \
                        + (-hpp["a"][0] * chck[1] + hpp["a"][1] * chck[0]) \
                        * (2 * tg_ha)
                    pos0 = position[0] * (1 + tg_ha ** 2) + offset * (1 - tg_ha ** 2)
                    pos1 = position[1] * (1 + tg_ha ** 2) + offset * (2 * tg_ha)
                    con = con + (hpp["a"][0] * pos0 + hpp["a"][1] * pos1)
                    con = con + (-hpp["b"] + rad[l]) * (1 + tg_ha ** 2)
                    self.define_constraint(con, -BIG, 0.0)

    def define_collision_constraints_3d(self, hyperplanes, room, positions,
                                        horizon_time):
        t = self.problem_t
        safety_distance = self.options["safety_distance"]
        safety_weight = self.options["safety_weight"]
        positions = [positions] if not isinstance(positions[0], list) \
            else positions
        for s, shape in enumerate(self.shapes):
            position = positions[s]
            checkpoints, rad = shape.get_checkpoints()
            checkpoints = [[float(c) for c in chck] for chck in checkpoints]
            rad = [float(r) for r in rad]
            if shape in hyperplanes:
                for k, hyp in enumerate(hyperplanes[shape]):
                    a, b = hyp["a"], hyp["b"]
                    if safety_distance > 0.0:
                        eps = self.define_spline_variable(f"eps_{s}{k}")[0]
                        self.define_objective(
                            safety_weight * definite_integral(
                                eps, t / horizon_time, 1.0))
                        self.define_constraint(eps - safety_distance, -BIG, 0.0)
                        self.define_constraint(-eps, -BIG, 0.0)
                    else:
                        eps = 0.0
                    for l, chck in enumerate(checkpoints):
                        con = sum(a[m] * (chck[m] + position[m])
                                  for m in range(3))
                        self.define_constraint(
                            con - b + rad[l] + safety_distance - eps,
                            -BIG, 0.0)
            if self.options["room_constraints"]:
                lims = room["shape"].get_canvas_limits()
                room_lims = [[float(v) for v in lims[k] + room["position"][k]]
                             for k in range(3)]
                for chck in checkpoints:
                    for k in range(3):
                        self.define_constraint(
                            -(chck[k] + position[k]) + room_lims[k][0],
                            -BIG, 0.0)
                        self.define_constraint(
                            (chck[k] + position[k]) - room_lims[k][1],
                            -BIG, 0.0)

    def get_fleet_center(self, splines, rel_pos, substitute=True):
        """The fleet center this vehicle perceives: its position splines
        plus its offset ``rel_pos`` (formation consensus)."""
        center = [s + rp for s, rp in zip(splines, rel_pos)]
        if substitute:
            return self.define_substitute("fleet_center", center)
        return center

    # -- deployment --------------------------------------------------------
    def store(self, current_time, sample_time, spline_segments, segment_times,
              time_axis=None):
        """Turn solved coefficients into sampled state/input trajectories
        (omgtools vehicle.py:250-300)."""
        if not isinstance(segment_times, list):
            segment_times = [segment_times]
        horizon_time = float(np.sum(segment_times))
        if len(spline_segments) == 1:
            # single segment: scale basis [0,1] -> [0, horizon]
            splines = [BSpline(self.basis.scale(segment_times[0]),
                               np.asarray(spline_segments[0])[:, k])
                       for k in range(self.n_spl)]
        else:
            splines = _concat_segments(self, spline_segments, segment_times)
        self.result_splines = splines
        if time_axis is None:
            n_samp = int(round(horizon_time / sample_time, 6)) + 1
            time_axis = np.linspace(0.0, (n_samp - 1) * sample_time, n_samp)
        self.trajectories = self.splines2signals(splines, time_axis)
        if not {"state", "input"}.issubset(self.trajectories):
            raise ValueError("signals must contain at least state and input")
        self.trajectories["time"] = time_axis - time_axis[0] + current_time
        self.trajectories["pose"] = np.apply_along_axis(
            self.state2pose, 0, self.trajectories["state"])
        self.trajectories["splines"] = np.vstack(
            [sample_spline(s, time_axis) for s in splines])
        for key, val in list(self.trajectories.items()):
            if val.ndim == 1:
                self.trajectories[key] = val[None, :]
        self.traj_storage.append({k: v.copy()
                                  for k, v in self.trajectories.items()})
        self.traj_times.append(float(current_time))

    def predict(self, current_time, predict_time, sample_time, state0=None,
                input0=None, dinput0=None, delay=0, enforce_states=False,
                enforce_inputs=False):
        """Predict the plant state one MPC period ahead
        (omgtools vehicle.py:302-337)."""
        if enforce_states:
            if state0 is None and self.signals:
                state0 = self.signals["state"][:, -1]
            if state0 is not None:
                if enforce_inputs:
                    input0 = input0 if input0 is not None else (
                        self.signals["input"][:, -1] if self.signals else None)
                    self.set_initial_conditions(state0, input=input0)
                else:
                    self.set_initial_conditions(state0)
            # else: keep the prediction set by set_initial_conditions
            return
        n_samp = int(np.round(predict_time / sample_time, 6))
        if self.options["ideal_prediction"]:
            for key in self.trajectories:
                self.prediction[key] = self.trajectories[key][:, n_samp + delay]
        else:
            for key in self.trajectories:
                if key not in ("state", "input", "pose"):
                    self.prediction[key] = self.trajectories[key][:, n_samp + delay]
            inputs = self.trajectories["input"][:, delay:]
            if state0 is None:
                state0 = self.signals["state"][:, -n_samp - 1]
            state = self.integrate_plant(state0, inputs, predict_time,
                                         sample_time)
            self.prediction["state"] = state[:, -1]
            self.prediction["input"] = self.trajectories["input"][:, n_samp + delay]
            self.prediction["pose"] = self.state2pose(state[:, -1])

    def simulate(self, simulation_time, sample_time):
        """Advance the simulated plant (omgtools vehicle.py:359-401)."""
        if not self.signals:
            self.signals = {k: v[:, :1].copy()
                            for k, v in self.trajectories.items()}
        n_samp = int(np.round(simulation_time / sample_time, 6))
        if self.options["ideal_update"]:
            for key in self.trajectories:
                self.signals[key] = np.c_[self.signals[key],
                                          self.trajectories[key][:, 1:n_samp + 1]]
        else:
            for key in self.trajectories:
                if key not in ("state", "input", "pose"):
                    self.signals[key] = np.c_[
                        self.signals[key],
                        self.trajectories[key][:, 1:n_samp + 1]]
            inputs = self.trajectories["input"]
            if self.options["input_disturbance"] is not None:
                inputs = self.add_disturbance(inputs)
            if self.options["1storder_delay"]:
                tau = self.options["time_constant"]
                inputs = self.integrate_plant(
                    self.signals["input"][:, -1], inputs, simulation_time,
                    sample_time,
                    ode=lambda s, u: (u - s) / tau)
            state0 = self.signals["state"][:, -1]
            state = self.integrate_plant(state0, inputs, simulation_time,
                                         sample_time)
            self.signals["input"] = np.c_[self.signals["input"],
                                          inputs[:, 1:n_samp + 1]]
            self.signals["state"] = np.c_[self.signals["state"],
                                          state[:, 1:n_samp + 1]]
            pose = np.apply_along_axis(self.state2pose, 0,
                                       state[:, 1:n_samp + 1]) \
                if n_samp else np.zeros((len(self.state2pose(state0)), 0))
            self.signals["pose"] = np.c_[self.signals["pose"], pose]

    def add_disturbance(self, inputs):
        dist = self.options["input_disturbance"]
        if dist is None:
            return inputs
        from scipy.signal import filtfilt, butter
        fc, stdev = dist["fc"], np.asarray(dist["stdev"])
        mean = np.asarray(dist.get("mean", np.zeros_like(stdev)))
        filt = butter(3, fc, "low")
        noise = np.vstack([
            filtfilt(filt[0], filt[1],
                     np.random.normal(mean[k], stdev[k], inputs.shape[1]))
            for k in range(inputs.shape[0])])
        return inputs + noise

    def overrule_state(self, state):
        state = np.asarray(state, dtype=np.float64)
        self.signals["state"][:, -1] = state
        self.signals["pose"][:, -1] = self.state2pose(state)
        self.prediction["state"] = state
        self.prediction["pose"] = self.state2pose(state)

    def overrule_input(self, inp, dinput=None):
        inp = np.asarray(inp, dtype=np.float64)
        self.signals["input"][:, -1] = inp
        self.prediction["input"] = inp
        if dinput is not None:
            self.prediction["dinput"] = np.asarray(dinput)

    # -- integrators -------------------------------------------------------
    def integrate_plant(self, state0, inputs, integration_time, sample_time,
                        ode=None):
        """Fixed-step RK4 with linear input interpolation between samples."""
        ode = ode or self.ode
        n_samp = int(np.round(integration_time / sample_time, 6)) + 1
        inputs = np.atleast_2d(np.asarray(inputs, dtype=np.float64))
        state = np.zeros((len(np.atleast_1d(state0)), n_samp))
        state[:, 0] = np.atleast_1d(state0)
        n_in = inputs.shape[1]

        def u_at(i_float):
            i0 = min(int(np.floor(i_float)), n_in - 1)
            i1 = min(i0 + 1, n_in - 1)
            w = i_float - i0
            return (1 - w) * inputs[:, i0] + w * inputs[:, i1]

        h = sample_time
        for i in range(n_samp - 1):
            y = state[:, i]
            k1 = np.asarray(ode(y, u_at(i)))
            k2 = np.asarray(ode(y + 0.5 * h * k1, u_at(i + 0.5)))
            k3 = np.asarray(ode(y + 0.5 * h * k2, u_at(i + 0.5)))
            k4 = np.asarray(ode(y + h * k3, u_at(i + 1.0)))
            state[:, i + 1] = y + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        return state

    def draw(self, t=-1):
        surf, lines = [], []
        for shape in self.shapes:
            s, l = shape.draw(self.signals["pose"][:, t])
            surf += s
            lines += l
        return surf, lines

    # -- plot providers (omgtools vehicle.py:470-525) ----------------------
    def _traj_at(self, t):
        """Latest stored trajectory active at sample index ``t``."""
        if not self.traj_storage:
            return None
        if t in (-1, None) or "time" not in self.signals:
            return self.traj_storage[-1]
        tm = float(self.signals["time"][0, t]
                   if self.signals["time"].ndim > 1
                   else self.signals["time"][t])
        idx = int(np.searchsorted(np.asarray(self.traj_times), tm + 1e-9)) - 1
        return self.traj_storage[max(idx, 0)]

    def init_plot(self, argument, **kwargs):
        source = self.signals or self.trajectories
        if argument not in source:
            return None
        n_rows = np.atleast_2d(source[argument]).shape[0]
        labels = kwargs.get(
            "labels", [f"{argument}[{k}]" for k in range(n_rows)])
        color = kwargs.get("color", "tab:blue")
        info = []
        for k in range(n_rows):
            lines = [{"color": color},
                     {"color": mix_with_white(color, 60.0),
                      "linestyle": "--"}]
            if kwargs.get("knots"):
                lines.append({"color": color, "linestyle": "none",
                              "marker": "x"})
            if kwargs.get("prediction"):
                lines.append({"color": color, "linestyle": "none",
                              "marker": "o"})
            info.append([{"labels": ["t (s)", labels[k]], "lines": lines}])
        return info

    def update_plot(self, argument, t, **kwargs):
        source = self.signals or self.trajectories
        if argument not in source:
            return None
        sig = np.atleast_2d(source[argument])
        time = np.atleast_2d(source.get("time", np.arange(sig.shape[1])))[0]
        end = sig.shape[1] if t in (-1, None) else t + 1
        traj = self._traj_at(t)
        data = []
        for k in range(sig.shape[0]):
            lines = [np.vstack([time[:end], sig[k, :end]])]
            if traj is not None and argument in traj:
                tr = np.atleast_2d(traj[argument])
                tr_t = np.atleast_2d(traj["time"])[0]
                lines.append(np.vstack([tr_t, tr[k]]))
            else:
                lines.append(np.zeros((2, 0)))
            if kwargs.get("knots"):
                lines.append(self._knot_points(argument, traj, k))
            if kwargs.get("prediction") and traj is not None:
                tr = np.atleast_2d(traj[argument])
                tr_t = np.atleast_2d(traj["time"])[0]
                lines.append(np.array([[tr_t[0]], [tr[k, 0]]]))
            data.append([lines])
        return data

    def _knot_points(self, argument, traj, k):
        if traj is None or argument not in traj:
            return np.zeros((2, 0))
        tr_t = np.atleast_2d(traj["time"])[0]
        horizon = tr_t[-1] - tr_t[0]
        interior = np.unique(self.knots)[1:-1]
        knot_times = tr_t[0] + interior * horizon
        tr = np.atleast_2d(traj[argument])
        vals = np.interp(knot_times, tr_t, tr[k])
        return np.vstack([knot_times, vals])

    # -- hooks required from concrete vehicles -----------------------------
    def init(self):
        pass

    def set_parameters(self, current_time):
        return {self: {}}

    def define_trajectory_constraints(self, splines, horizon_time):
        raise NotImplementedError

    def get_initial_constraints(self, splines, horizon_time):
        raise NotImplementedError

    def get_terminal_constraints(self, splines, horizon_time=None):
        raise NotImplementedError

    def check_terminal_conditions(self):
        raise NotImplementedError

    def splines2signals(self, splines, time):
        raise NotImplementedError

    def state2pose(self, state):
        raise NotImplementedError

    def ode(self, state, input):
        raise NotImplementedError


def _concat_segments(vehicle, spline_segments, segment_times,
                     continuity=None):
    """Concatenate per-segment splines into one spline over the full horizon
    via collocation on a union knot vector (omgtools
    spline_extra.py:308-404).  Multi-frame solutions are C^(degree-1)
    continuous at the joints (connection constraints), so a single knot per
    joint suffices; the least-squares fallback in solve_collocation absorbs
    small continuity residuals."""
    degree = vehicle.degree
    n_spl = vehicle.n_spl
    if continuity is None:
        continuity = degree - 1
    mult = degree + 1 - continuity - 1  # knots to insert at each joint
    mult = max(mult, 1)
    out = []
    for k in range(n_spl):
        shift = 0.0
        segs = []
        interior = []
        joints = []
        for seg, T in zip(spline_segments, segment_times):
            b = vehicle.basis.scale(T, shift)
            segs.append((b, np.asarray(seg)[:, k]))
            interior.append(b.knots[degree + 1:-(degree + 1)])
            shift += T
            joints.append(shift)
        lo = 0.0
        knots = [np.full(degree + 1, lo)]
        for kn, joint in zip(interior, joints):
            knots.append(kn)
            if joint < shift:  # interior joint
                knots.append(np.full(mult, joint))
        knots.append(np.full(degree + 1, shift))
        union = Basis(np.concatenate(knots), degree)

        def rhs(g):
            vals = np.zeros(len(g))
            done = np.zeros(len(g), dtype=bool)
            for b, c in segs:
                blo, bhi = b.domain
                m = (g >= blo) & (g <= bhi) & ~done
                if m.any():
                    vals[m] = b.eval(g[m]) @ c
                    done |= m
            return vals

        coeffs = union.solve_collocation(rhs)
        out.append(BSpline(union, coeffs))
    return out

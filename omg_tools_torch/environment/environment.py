"""Environment: rooms, obstacles, separating-hyperplane collision setup
(counterpart of ``omg_tools_tpu.environment.environment``).

For every (vehicle shape x obstacle) pair a separating hyperplane
a(tau).p = b(tau) is introduced as degree-1 spline variables on the
vehicle's knot lattice with ||a||^2 <= 1, and both parties (vehicle +
obstacle) receive their half-space constraints.  Inter-vehicle avoidance
shares one plane (a, b) / (-a, -b) between two vehicles, on the union of
their knots.  The host simulation advances the obstacles and reflects
bouncing ones off other obstacles and the room borders.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..modeling.opti import OptiChild, BIG
from ..ops.basis import Basis
from .obstacle import Obstacle

__all__ = ["Environment"]


class Environment(OptiChild):

    def __init__(self, room, obstacles=None):
        OptiChild.__init__(self, "environment")
        self.room = room if isinstance(room, list) else [room]
        self.n_dim = self.room[0]["shape"].n_dim
        for room_ in self.room:
            if room_["shape"].n_dim != self.n_dim:
                raise ValueError("rooms of different dimension")
            room_.setdefault("position", [0.0] * self.n_dim)
            room_.setdefault("orientation",
                             0.0 if self.n_dim == 2 else [0.0, 0.0, 0.0])
            room_.setdefault("draw", False)
        self.obstacles: List[Obstacle] = []
        self.n_obs = 0
        for obstacle in (obstacles or []):
            self.add_obstacle(obstacle)

    def copy(self):
        obstacles = [Obstacle(o.initial, o.shape, o.simulation, dict(o.options))
                     for o in self.obstacles]
        return Environment(
            [dict(r) for r in self.room], obstacles)

    def add_obstacle(self, obstacle):
        if isinstance(obstacle, list):
            for o in obstacle:
                self.add_obstacle(o)
            return
        if obstacle.n_dim == 3 and self.n_dim == 2:
            raise ValueError("cannot put a 3D obstacle in a 2D environment")
        self.obstacles.append(obstacle)
        self.n_obs += 1

    def fill_room(self, room, obstacles):
        idx = self.room.index(room)
        self.room[idx]["obstacles"] = obstacles
        for o in obstacles:
            if o not in self.obstacles:
                self.obstacles.append(o)

    # -- modeling ----------------------------------------------------------
    def _hyperplane_basis(self, vehicle):
        degree = 1
        knots = np.r_[np.zeros(degree),
                      vehicle.knots[vehicle.degree:-vehicle.degree],
                      np.ones(degree)]
        return Basis(knots, degree)

    def init(self, horizon_times=None):
        for obstacle in self.obstacles:
            obstacle.init(horizon_times=horizon_times)

    def define_collision_constraints(self, vehicle, splines, horizon_times):
        if vehicle.n_dim != self.n_dim:
            raise ValueError("vehicle/environment dimension mismatch")
        if not isinstance(horizon_times, list):
            horizon_times = [horizon_times] * getattr(vehicle, "n_seg", 1)
        basis = self._hyperplane_basis(vehicle)
        for idx in range(vehicle.n_seg):
            room = self.room[idx]
            if room.get("parametric", False):
                lo = self.define_parameter(f"room_lo_{idx}", self.n_dim)
                hi = self.define_parameter(f"room_hi_{idx}", self.n_dim)
                room["lims_param"] = (lo, hi)
            hyp_veh: Dict = {}
            obs_to_add = room.get("obstacles", self.obstacles)
            for k, shape in enumerate(vehicle.shapes):
                hyp_veh[shape] = []
                for l, obstacle in enumerate(obs_to_add):
                    obstacle.problem_t = vehicle.problem_t
                    obstacle.problem_T = getattr(vehicle, "problem_T", None)
                    obstacle.init(horizon_times=horizon_times[:idx + 1])
                    if not obstacle.options["avoid"]:
                        continue
                    tag = f"{vehicle.label}_seg{idx}_{k}{l}"
                    a_init, b_init = self._initial_hyperplane(
                        vehicle, obstacle, basis)
                    a = self.define_spline_variable(
                        "a_" + tag, obstacle.n_dim, basis=basis,
                        value=a_init)
                    b = self.define_spline_variable(
                        "b_" + tag, 1, basis=basis, value=b_init)[0]
                    self.define_constraint(
                        sum(a[p] * a[p] for p in range(obstacle.n_dim)) - 1,
                        -BIG, 0.0)
                    hyp_veh[shape].append({"a": a, "b": b})
                    obstacle.define_collision_constraints([{"a": a, "b": b}])
            vehicle.define_collision_constraints(hyp_veh, room, splines[idx],
                                                 horizon_times[idx])

    def _initial_hyperplane(self, vehicle, obstacle, basis):
        """Geometric warm start for the separating-plane spline variables:
        for every Greville abscissa of the hyperplane basis the plane normal
        points along (init-path point - nearest obstacle point), with the
        offset b from the obstacle's support function."""
        nd = obstacle.n_dim
        try:
            def _pad(vec):
                v = np.asarray(vec, dtype=np.float64).ravel()[:nd]
                return np.r_[v, np.zeros(nd - v.size)] if v.size < nd else v
            p0 = _pad(vehicle.prediction["state"])
            pT = _pad(vehicle.poseT)
            obs = obstacle.signals["position"][:nd, -1]
        except (KeyError, AttributeError, IndexError):
            return None, None
        chck, rad = obstacle.shape.get_checkpoints()
        bbox_lo = np.min(chck, axis=0) + obs
        bbox_hi = np.max(chck, axis=0) + obs
        path_dir = pT - p0
        if nd >= 2:
            perp = np.r_[-path_dir[1], path_dir[0], np.zeros(nd - 2)][:nd]
        else:
            perp = np.ones(1)
        if np.linalg.norm(perp) < 1e-9:
            perp = np.r_[1.0, np.zeros(nd - 1)]
        g = basis.greville()
        a_init = np.zeros((len(basis), nd))
        b_init = np.zeros((len(basis), 1))
        for i, tau in enumerate(g):
            pt = p0 + tau * path_dir
            nearest = np.clip(pt, bbox_lo, bbox_hi)  # bbox approximation
            d = pt - nearest
            if np.linalg.norm(d) < 1e-9:
                d = perp
            # vehicle on a.x <= b, obstacle on a.x >= b: the normal points
            # from the path toward the obstacle
            a0 = -d / np.linalg.norm(d)
            b0 = float(np.min(chck @ a0 - rad)) + a0 @ obs - 1e-2
            a_init[i] = a0
            b_init[i, 0] = b0
        return a_init, b_init

    def define_intervehicle_collision_constraints(self, vehicles,
                                                  horizon_times):
        """A separating hyperplane between every pair of vehicle shapes, in
        every segment: degree-1 spline variables a, b on the union of the
        two vehicles' inner knots with ||a||^2 <= 1; the first vehicle
        keeps a.p <= b, the second the mirrored plane (-a, -b)."""
        if not isinstance(horizon_times, list):
            horizon_times = [horizon_times] * vehicles[0].n_seg
        for idx in range(vehicles[0].n_seg):
            hyp_veh = {veh: {sh: [] for sh in veh.shapes} for veh in vehicles}
            for k in range(len(vehicles)):
                for l in range(k + 1, len(vehicles)):
                    veh1, veh2 = vehicles[k], vehicles[l]
                    if veh1.n_dim != veh2.n_dim:
                        raise ValueError("vehicle dimension mismatch")
                    degree = 1
                    knots = np.r_[np.zeros(degree), np.union1d(
                        veh1.knots[veh1.degree:-veh1.degree],
                        veh2.knots[veh2.degree:-veh2.degree]),
                        np.ones(degree)]
                    basis = Basis(knots, degree)
                    for kk, shape1 in enumerate(veh1.shapes):
                        for ll, shape2 in enumerate(veh2.shapes):
                            tag = (f"{veh1.label}_seg{idx}_{kk}_"
                                   f"{veh2.label}_{ll}")
                            a = self.define_spline_variable(
                                "a_" + tag, self.n_dim, basis=basis)
                            b = self.define_spline_variable(
                                "b_" + tag, 1, basis=basis)[0]
                            self.define_constraint(
                                sum(a[p] * a[p] for p in range(self.n_dim))
                                - 1, -BIG, 0.0)
                            hyp_veh[veh1][shape1].append({"a": a, "b": b})
                            hyp_veh[veh2][shape2].append(
                                {"a": [-ai for ai in a], "b": -1 * b})
            for vehicle in vehicles:
                vehicle.define_collision_constraints(
                    hyp_veh[vehicle], self.room[idx], vehicle.splines[idx],
                    horizon_times[idx])

    # -- simulation --------------------------------------------------------
    def simulate(self, simulation_time, sample_time):
        for obstacle in self.obstacles:
            if obstacle.options["bounce"]:
                self._bounce(obstacle)
            obstacle.simulate(simulation_time, sample_time)

    def _bounce(self, obstacle):
        """Reflect a moving obstacle off other obstacles / room borders
        (omgtools environment.py:190-331, simplified to velocity
        reflection along the blocked axis)."""
        vel = obstacle.signals["velocity"][:, -1]
        if not np.any(vel):
            return
        for obs in self.obstacles:
            if obs is obstacle:
                continue
            if obstacle.overlaps_with(obs):
                obstacle.signals["velocity"][:, -1] = \
                    self._reflect(obstacle, vel,
                                  lambda: obstacle.overlaps_with(obs))
                return
        if obstacle.is_outside_of(self.room[0]):
            obstacle.signals["velocity"][:, -1] = \
                self._reflect(obstacle, vel,
                              lambda: obstacle.is_outside_of(self.room[0]))

    def _reflect(self, obstacle, vel, still_colliding):
        if np.any(vel == 0):
            return -vel
        # diagonal motion: probe which axis is blocked by shifting the
        # obstacle slightly along the candidate new direction
        pos = obstacle.signals["position"][:, -1].copy()
        probe = np.array([0.15 * np.sign(vel[0]), -0.15 * np.sign(vel[1])])
        obstacle.signals["position"][:, -1] = pos + probe
        flipped_y = not still_colliding()
        obstacle.signals["position"][:, -1] = pos
        if flipped_y:
            return np.array([vel[0], -vel[1]])
        return np.array([-vel[0], vel[1]])

    def draw(self, t=-1):
        surfaces, lines = [], []
        for room in self.room:
            if room["draw"]:
                s, l = room["shape"].draw(
                    np.r_[room["position"],
                          np.atleast_1d(room["orientation"])])
                surfaces += s
                lines += l
        for obstacle in self.obstacles:
            s, l = obstacle.draw(t)
            surfaces += s
            lines += l
        return surfaces, lines

    def set_parameters(self, current_time):
        parameters = {self: {}}
        for idx, room in enumerate(self.room):
            if room.get("parametric", False):
                lims = room["shape"].get_canvas_limits()
                lo = [lims[k][0] + room["position"][k]
                      for k in range(self.n_dim)]
                hi = [lims[k][1] + room["position"][k]
                      for k in range(self.n_dim)]
                parameters[self][f"room_lo_{idx}"] = np.asarray(lo)
                parameters[self][f"room_hi_{idx}"] = np.asarray(hi)
        return parameters

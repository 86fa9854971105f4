"""Scheduler problem: receding-frame orchestration for vast environments
(counterpart of ``omg_tools_tpu.problems.schedulerproblem``, after omgtools
problems/schedulerproblem.py): an A* global path, then moving frames, then
local problems.

- ``n_frames >= 2``: local problems are :class:`MultiFrameProblem`s over
  the frame rooms with free per-segment motion times and overlap hand-off
  (omgtools :700-730);
- frame switching by OVERLAP-REGION MEMBERSHIP: when the vehicle enters
  the overlap of frame 0 and frame 1, frame 0 is dropped and a new last
  frame is appended (omgtools check_frames :409-431);
- moving-obstacle membership is re-checked every period; a change rebuilds
  the frames (omgtools solve :138-209);
- init guesses: global-path waypoint interpolation at the Greville points
  for new frames with motion-time estimate path_length/(vmax/2) (omgtools
  get_init_guess_new_frame :563-658, :589-591), segment hand-down plus
  combined-frame re-projection when frames shift (omgtools
  get_init_guess_combined_frame :660-698);
- CorridorFrame L-shape splitting (omgtools frame.py:777) via
  ``frame_type='corridor', n_frames=2``.

Where omgtools rebuilds its NLP at every frame switch
(schedulerproblem.py:726), local problems here are built with PARAMETRIC
room borders and obstacle SLOTS (padded per checkpoint-count class) and
cached by structural signature: a frame switch is a parameter update on a
built problem, not a rebuild.  On the card a cached problem keeps its
solver, and with it the CUDA graphs of its Newton step
(``ops.alm.CapturedCall``): the new room borders and slot parameters are
copied into the graphs' static inputs at the next solve, nothing is
captured again.  The local problems take the scheduler's ``device`` and
``dtype`` options.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .globalplanner import AStarPlanner
from .multiframeproblem import MultiFrameProblem
from .point2point import FreeTPoint2point
from .problem import Problem
from ..environment.environment import Environment
from ..environment.obstacle import Obstacle
from ..environment.frame import (ShiftFrame, CorridorFrame, create_l_shape)
from ..environment.shapes import Circle, Rectangle

__all__ = ["SchedulerProblem"]


class SchedulerProblem(Problem):

    def __init__(self, fleet, environment, options=None, **kwargs):
        Problem.__init__(self, fleet, environment, options,
                         label="schedulerproblem")
        if len(self.vehicles) > 1:
            raise NotImplementedError("scheduler supports one vehicle")
        self.vehicle = self.vehicles[0]
        opt = self.options
        self.frame_type = kwargs.get("frame_type", opt.get("frame_type",
                                                           "shift_frame"))
        self.n_frames = int(kwargs.get("n_frames", opt.get("n_frames", 1)))
        self.frame_size = kwargs.get("frame_size", 2.5)
        self.n_cells = kwargs.get("n_cells", [20, 20])
        # obstacle slots are padded to multiples of this per checkpoint
        # class, so frame layouts with similar obstacle counts share one
        # built problem
        self.slot_quantum = int(kwargs.get("slot_quantum", 1))
        self.start_time = 0.0
        self._problem_cache: Dict = {}
        self.cnt_frame_switches = 0
        self.cnt_problem_builds = 0

    def set_default_options(self):
        Problem.set_default_options(self)
        self.options["frame_type"] = "shift_frame"
        self.options["n_frames"] = 1

    # -- build -------------------------------------------------------------
    def init(self):
        self.goal = np.asarray(self.vehicle.poseT[:2], dtype=np.float64)
        # the user's FULL terminal pose: frame goals are 2-D positions, so
        # pose-based vehicles (Dubins, HolonomicOrient) need the original
        # heading restored (global goal) or synthesized from the path
        # direction (intermediate frame goals) -- omgtools schedulerproblem.py
        # :528-551 does the same angle append for Dubins
        self._goal_pose = np.asarray(self.vehicle.poseT,
                                     dtype=np.float64).copy()
        self.curr_state = np.asarray(self.vehicle.prediction["state"][:2],
                                     dtype=np.float64)
        veh_size = getattr(self.vehicle.shapes[0], "radius", 0.2)
        self.veh_size = veh_size
        self.planner = AStarPlanner(self.environment, self.n_cells,
                                    self.curr_state, self.goal,
                                    vehicle_size=veh_size)
        self._create_frames()
        self._generate_problem(guess="waypoints")

    def _global_path(self):
        path = self.planner.get_path(self.curr_state, self.goal)
        if path is None:
            raise RuntimeError("global planner found no path")
        return [np.asarray(p, dtype=np.float64) for p in path]

    def _single_frame(self, start, path):
        if self.frame_type == "corridor":
            frame = CorridorFrame(self.environment, start, self.goal,
                                  global_path=path)
        else:
            frame = ShiftFrame(self.environment, start, self.goal,
                               self.frame_size, global_path=path)
        return frame

    def _create_frames(self):
        path = self._global_path()
        horizon = 10.0
        if self.frame_type == "corridor" and self.n_frames >= 2:
            frames = create_l_shape(self.environment, self.curr_state,
                                    self.goal, path)
        else:
            frames = []
            start = self.curr_state
            for _ in range(self.n_frames):
                frame = self._single_frame(start, path)
                frames.append(frame)
                if frame.point_in_frame(self.goal):
                    break
                start = frame.goal
                # path tail beyond the new start
                dists = [np.linalg.norm(np.asarray(p) - start) for p in path]
                path = path[int(np.argmin(dists)):] or path
        for frame in frames:
            frame.fill_obstacles(horizon_time=horizon)
            frame.fix_endpoint_reachability(self.veh_size)
        self.frames = frames
        self._moving_ids = [f.moving_ids() for f in frames]
        self.cnt_frame_switches += 1

    # -- obstacle slots + signature -----------------------------------------
    @staticmethod
    def _obs_class(obstacle):
        chck, _ = obstacle.shape.get_checkpoints()
        return (len(chck), getattr(obstacle, "cos", None) is not None,
                bool(obstacle.options.get("spline_traj", False)))

    def _env_class_counts(self):
        """Environment-wide obstacle count per checkpoint class: the UNIFORM
        slot layout every frame is padded to, so every frame shares one
        structural signature and one built local problem (instead of
        omgtools' per-switch NLP rebuild, :700-730)."""
        counts: Dict = {}
        for obs in self.environment.obstacles:
            if not obs.options.get("avoid", True):
                continue
            cls = self._obs_class(obs)
            counts[cls] = counts.get(cls, 0) + 1
        return counts

    def _frame_slots(self, frame):
        """In-frame obstacles padded per checkpoint class to the
        environment-wide class counts (rounded up to slot quanta):
        (class -> [obstacles + dummies]).  Out-of-frame slots are parked
        far away (still avoided -- trivially satisfied constraints)."""
        q = self.slot_quantum
        classes: Dict = {}
        for obs in frame.stationary_obstacles + frame.moving_obstacles:
            classes.setdefault(self._obs_class(obs), []).append(obs)
        slots: Dict = {}
        # park dummies just OUTSIDE the frame: far enough never to bind
        # (vehicle stays inside the frame room), close enough to keep the
        # hyperplane offsets at the problem's length scale -- a 1000x-away
        # slot makes b ~ 1000 and stalls both ALM and the scipy reference
        far = frame.center + np.array([0.5 * frame.width + 2.0, 0.0])
        for cls, total in self._env_class_counts().items():
            members = classes.get(cls, [])
            n_slots = max(total, len(members))
            n_slots += (-n_slots) % q
            dummies = []
            for _ in range(n_slots - len(members)):
                n_chck = cls[0]
                shape = Circle(0.05) if n_chck == 1 else \
                    Rectangle(width=0.1, height=0.1)
                dummies.append(Obstacle({"position": list(far)}, shape=shape,
                                        options={"avoid": True}))
            slots[cls] = members + dummies
        for cls, members in classes.items():
            if cls not in slots:
                slots[cls] = members
        return slots

    def _signature(self):
        sig = [len(self.frames)]
        for frame in self.frames:
            slots = self._frame_slots(frame)
            sig.append(tuple(sorted((cls, len(members))
                             for cls, members in slots.items())))
        return tuple(sig)

    def _frame_goal(self, frame):
        """Terminal condition for the last frame: the 2-D frame goal, plus
        -- for pose-based vehicles -- the user's terminal heading when the
        frame reaches the global goal, else the direction of the global-path
        segment arriving at the frame goal (omgtools schedulerproblem.py
        :528-551)."""
        goal = [float(v) for v in np.asarray(frame.goal, dtype=np.float64)]
        full = getattr(self, "_goal_pose", None)
        if full is None or len(full) <= len(goal):
            return goal
        if np.linalg.norm(np.asarray(goal) - full[:len(goal)]) < 1e-6:
            return goal + [float(v) for v in full[len(goal):]]
        gp = [np.asarray(w, dtype=np.float64)
              for w in (frame.global_path or [])]
        angle = 0.0
        if len(gp) >= 2:
            k = int(np.argmin([np.linalg.norm(w - np.asarray(goal))
                               for w in gp]))
            a, b = (gp[k - 1], gp[k]) if k > 0 else (gp[0], gp[1])
            if np.linalg.norm(b - a) > 1e-9:
                angle = float(np.arctan2(b[1] - a[1], b[0] - a[0]))
        return goal + [angle] + [0.0] * (len(full) - len(goal) - 1)

    # -- local problem construction / reuse ---------------------------------
    def _generate_problem(self, guess="waypoints", handdown=None):
        """Build or re-target the local problem for the current frames
        (omgtools generate_problem :700-730; here a cache keyed by the
        structural signature, where a hit is a pure parameter update)."""
        frames = self.frames
        sig = self._signature()
        self.vehicle.set_terminal_conditions(self._frame_goal(frames[-1]))
        if sig in self._problem_cache:
            problem = self._problem_cache[sig]
            self._retarget(problem)
        else:
            rooms = []
            local_obstacles = []
            for frame in frames:
                room = frame.room()
                room["parametric"] = True
                slots = self._frame_slots(frame)
                room_obs = []
                for members in slots.values():
                    for obs in members:
                        tmpl = Obstacle(dict(obs.initial), obs.shape,
                                        options=dict(obs.options))
                        tmpl.source = obs
                        room_obs.append(tmpl)
                room["obstacles"] = room_obs
                local_obstacles += room_obs
                rooms.append(room)
            local_env = Environment(room=rooms)
            local_env.obstacles = local_obstacles
            local_env.n_obs = len(local_obstacles)
            options = {"verbose": 0, "device": self.options["device"],
                       "dtype": self.options["dtype"]}
            if len(frames) == 1:
                problem = FreeTPoint2point(self.vehicle, local_env, options)
            else:
                problem = MultiFrameProblem(self.vehicle, local_env,
                                            n_frames=len(frames),
                                            options=options)
            problem.init()
            self._problem_cache[sig] = problem
            self.cnt_problem_builds += 1
            self._retarget(problem, structure_fresh=True)
        self.local_problem = problem
        self._set_init_guess(guess=guess, handdown=handdown)
        self.local_problem.initialize(0.0)

    def _retarget(self, problem, structure_fresh=False):
        """Point a (possibly cached) local problem at the current frames:
        update the parametric room borders and re-source every obstacle
        slot.  No transcription rebuild happens here."""
        frames = self.frames
        env = problem.environment
        for idx, frame in enumerate(frames):
            room = env.room[idx]
            new_room = frame.room()
            room["shape"] = new_room["shape"]
            room["position"] = new_room["position"]
            slots = self._frame_slots(frame)
            flat = [obs for members in slots.values() for obs in members]
            tmpl_list = room.get("obstacles", env.obstacles)
            far = frame.center + np.array([0.5 * frame.width + 2.0, 0.0])
            for tmpl, src in zip(tmpl_list, flat + [None] * max(
                    0, len(tmpl_list) - len(flat))):
                if structure_fresh and getattr(tmpl, "source", None) is not None:
                    continue  # fresh build already wired the sources
                if src is not None:
                    tmpl.source = src
                else:
                    tmpl.source = Obstacle({"position": list(far)},
                                           shape=tmpl.shape)
        problem.reinitialize()

    # -- init guesses (omgtools :563-698) ----------------------------------
    def _waypoint_guess(self, frame):
        """Linear arc-length interpolation of the in-frame global-path
        waypoints, evaluated at the vehicle basis' Greville abscissae
        (omgtools get_init_guess_new_frame :563-658).  Returns
        (coeffs (n_c, 2), motion_time_estimate)."""
        basis = self.vehicle.basis
        pts = [np.asarray(frame.start, dtype=np.float64)]
        pts += [np.asarray(w) for w in
                frame.waypoints_in_frame(frame.global_path or [])]
        pts += [np.asarray(frame.goal, dtype=np.float64)]
        pts = np.asarray(pts)
        seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
        cum = np.r_[0.0, np.cumsum(seg)]
        length = max(cum[-1], 1e-9)
        g = basis.greville()
        coeffs = np.stack([np.interp(g * length, cum, pts[:, k])
                           for k in range(2)], axis=1)
        motion_time = length / max(0.5 * self._vehicle_vmax(), 1e-6)
        return coeffs, motion_time

    def _vehicle_vmax(self):
        """Velocity bound for motion-time estimates (omgtools :589-591).
        Holonomic exposes vmax (norm_2) or vxmax/vymax (norm_inf)."""
        v = getattr(self.vehicle, "vmax", None)
        if v is None:
            vx = getattr(self.vehicle, "vxmax", None)
            vy = getattr(self.vehicle, "vymax", None)
            if vx is not None:
                v = min(vx, vy) if vy is not None else vx
        return float(v) if v else 0.5

    def _set_init_guess(self, guess="waypoints", handdown=None):
        """Install init guesses into the local problem's warm start:
        ``handdown`` carries (coeffs, T) per already-solved frame from the
        previous problem (frame-shift hand-off); remaining frames get
        waypoint-interpolation guesses."""
        problem = self.local_problem
        tr = problem.transcription
        n_seg = problem.n_frames if isinstance(problem, MultiFrameProblem) \
            else 1
        for k in range(min(n_seg, len(self.frames))):
            if handdown is not None and k < len(handdown):
                coeffs, T_k = handdown[k]
            else:
                coeffs, T_k = self._waypoint_guess(self.frames[k])
            sl, shape = tr.var_slice(self.vehicle, f"splines_seg{k}")
            buf = np.zeros(shape)
            buf[:, :coeffs.shape[1]] = coeffs
            problem._x_result[sl] = buf.reshape(-1)
            name = f"T{k}" if n_seg > 1 else "T"
            try:
                problem.set_variables(np.asarray([T_k]), problem, name)
            except KeyError:
                pass

    # -- frame management ----------------------------------------------------
    def _membership_changed(self):
        """Moving-obstacle membership re-check (omgtools :138-209)."""
        for frame, ids in zip(self.frames, self._moving_ids):
            current = set()
            for obstacle in self.environment.obstacles:
                if not obstacle.options.get("avoid", True):
                    continue
                inside, moving = frame.obstacle_in_frame(obstacle,
                                                         horizon_time=10.0)
                if inside and moving:
                    current.add(id(obstacle))
            if current != ids:
                return True
        return False

    def _check_frames(self):
        """True while the current frames stay valid (omgtools :409-431):
        multi-frame -> switch when the vehicle enters the overlap region;
        single frame -> valid while the goal is inside or the vehicle is
        still far from the frame endpoint."""
        if self.frames[-1].point_in_frame(self.goal) and \
                len(self.frames) == 1:
            return True
        if len(self.frames) >= 2:
            in0 = self.frames[0].point_in_frame(self.curr_state)
            in1 = self.frames[1].point_in_frame(self.curr_state)
            if in0 and in1:
                return False     # inside the overlap: hand off
            if not in0:
                return False     # passed beyond frame 0 entirely
            return True
        dist = np.linalg.norm(self.curr_state - self.frames[0].goal)
        return dist > 0.25 * max(self.frames[0].width,
                                 self.frames[0].height) * 0.5

    def _shift_frames(self):
        """Frame switch: recreate the frames FROM THE CURRENT VEHICLE STATE
        (omgtools update_frames :433-479 calls create_frames(), which
        anchors frame 0 at curr_state).  Chaining the new frame 0 off the
        old frame-1 boundary instead leaves the init constraint
        (spline_seg0(t0) == curr_state) inconsistent with the hand-down
        guess -- the solver then diverges and the vehicle executes the
        infeasible iterate.  A recreate keeps guess and constraint
        consistent; the structural cache still makes this a parameter
        update, not a rebuild."""
        self._create_frames()
        self._generate_problem(guess="waypoints")

    # -- lifecycle ---------------------------------------------------------
    def initialize(self, current_time):
        self.start_time = current_time
        self.local_problem.initialize(current_time)

    def reinitialize(self, father=None):
        self.local_problem.reinitialize()

    def predict(self, current_time, predict_time, sample_time, states=None,
                delay=0, enforce_states=False, enforce_inputs=False):
        self.local_problem.predict(current_time, predict_time, sample_time,
                                   states, delay, enforce_states,
                                   enforce_inputs)

    def solve(self, current_time, update_time):
        self.curr_state = np.asarray(self.vehicle.prediction["state"][:2],
                                     dtype=np.float64)
        if self._membership_changed():
            self._create_frames()
            self._generate_problem(guess="waypoints")
            self.local_problem.initialize(current_time)
            # carry the measured input too: enforce_states alone zeroes
            # the input prediction and the init constraint would brake the
            # vehicle to a stop at every frame switch
            self.local_problem.predict(current_time, update_time, 0.01,
                                       enforce_states=True,
                                       enforce_inputs=True)
        elif not self._check_frames():
            if len(self.frames) >= 2:
                self._shift_frames()
            else:
                self._create_frames()
                self._generate_problem(guess="waypoints")
            self.local_problem.initialize(current_time)
            # carry the measured input too: enforce_states alone zeroes
            # the input prediction and the init constraint would brake the
            # vehicle to a stop at every frame switch
            self.local_problem.predict(current_time, update_time, 0.01,
                                       enforce_states=True,
                                       enforce_inputs=True)
        self.local_problem.solve(current_time, update_time)
        self.solver_stats = self.local_problem.solver_stats
        self.update_times = self.local_problem.update_times
        self.iteration = self.local_problem.iteration

    def store(self, current_time, update_time, sample_time):
        self.local_problem.store(current_time, update_time, sample_time)

    def simulate(self, current_time, simulation_time, sample_time):
        # the local problem simulates the vehicle (its template obstacles
        # are slot proxies); the GLOBAL environment is the obstacle truth
        self.local_problem.simulate(current_time, simulation_time,
                                    sample_time)
        self.environment.simulate(simulation_time, sample_time)

    def stop_criterium(self, current_time, update_time):
        if not self.frames[-1].point_in_frame(self.goal):
            return False
        return self.local_problem.stop_criterium(current_time, update_time)

    def sleep(self, current_time, sleep_time, sample_time):
        self.local_problem.sleep(current_time, sleep_time, sample_time)

    def compute_objective(self):
        return self.local_problem.compute_objective()

    def final(self):
        if self.options["verbose"] >= 1:
            print("\nWe reached our target!")
            print("%-18s %d" % ("Frame switches:", self.cnt_frame_switches))
            print("%-18s %d" % ("Problem builds:", self.cnt_problem_builds))
        self.local_problem.final()

"""Moving-window frames for vast environments (host numpy; a copy of
``omg_tools_tpu.environment.frame``, after omgtools environment/frame.py).

A frame is a rectangular sub-environment around (part of) the global path;
only in-frame obstacles enter the local NLP.  Two variants:

- ShiftFrame: fixed-size rectangle shifted toward the movement direction,
  limited by ``move_limit`` and clipped to the room borders;
- CorridorFrame: rectangle grown around the path until obstacles block it
  (axis-aligned sweep), optionally split into two overlapping L-shape
  frames.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .shapes import Circle, Rectangle, Square
from ..utils.geometry import rectangles_overlap

__all__ = ["Frame", "ShiftFrame", "CorridorFrame", "create_l_shape"]


class Frame:
    """Axis-aligned rectangular window [xmin, ymin, xmax, ymax]."""

    def __init__(self, environment, border, global_path=None, options=None):
        self.environment = environment
        self.border = list(map(float, border))   # xmin, ymin, xmax, ymax
        self.global_path = global_path
        self.options = options or {}
        self.stationary_obstacles: List = []
        self.moving_obstacles: List = []

    @property
    def center(self):
        b = self.border
        return np.array([0.5 * (b[0] + b[2]), 0.5 * (b[1] + b[3])])

    @property
    def width(self):
        return self.border[2] - self.border[0]

    @property
    def height(self):
        return self.border[3] - self.border[1]

    def shape(self):
        return Rectangle(width=self.width, height=self.height)

    def room(self):
        return {"shape": self.shape(), "position": list(self.center),
                "draw": True}

    def point_in_frame(self, point, margin=0.0, border=None):
        b = border if border is not None else self.border
        return (b[0] - margin <= point[0] <= b[2] + margin and
                b[1] - margin <= point[1] <= b[3] + margin)

    def obstacle_in_frame(self, obstacle, horizon_time=None,
                          sample_time=0.5):
        """Stationary obstacles: geometric overlap.  Moving obstacles: check
        the predicted positions over the horizon (omgtools
        frame.py:118-166)."""
        pos = obstacle.signals["position"][:2, -1]
        vel = obstacle.signals["velocity"][:2, -1]
        moving = bool(np.any(np.abs(vel) > 1e-9))
        positions = [pos]
        if moving and horizon_time is not None:
            acc = obstacle.signals["acceleration"][:2, -1]
            ts = np.arange(0.0, horizon_time + 1e-9, sample_time)
            positions = [pos + vel * t + 0.5 * acc * t * t for t in ts]
        for p in positions:
            if self._shape_overlaps(obstacle.shape, p):
                return True, moving
        return False, moving

    def _shape_overlaps(self, shape, pos):
        b = self.border
        if isinstance(shape, Circle):
            cx = np.clip(pos[0], b[0], b[2])
            cy = np.clip(pos[1], b[1], b[3])
            return np.hypot(pos[0] - cx, pos[1] - cy) <= shape.radius
        if isinstance(shape, (Rectangle, Square)):
            return rectangles_overlap(pos, shape.width, shape.height,
                                      self.center, self.width, self.height)
        chck, rad = shape.get_checkpoints()
        verts = (np.asarray(chck) + np.asarray(pos)[:2]).T
        for v in verts.T:
            if self.point_in_frame(v, margin=float(np.max(rad))):
                return True
        return False

    def fill_obstacles(self, horizon_time=None):
        self.stationary_obstacles, self.moving_obstacles = [], []
        for obstacle in self.environment.obstacles:
            if not obstacle.options.get("avoid", True):
                continue
            inside, moving = self.obstacle_in_frame(obstacle, horizon_time)
            if inside:
                (self.moving_obstacles if moving
                 else self.stationary_obstacles).append(obstacle)

    def waypoints_in_frame(self, path):
        return [p for p in path if self.point_in_frame(p)]

    def moving_ids(self):
        """Identity set of the in-frame moving obstacles (used to detect
        membership changes that force a frame rebuild, omgtools
        schedulerproblem.py:138-209)."""
        return set(id(o) for o in self.moving_obstacles)

    def overlap_with(self, other: "Frame"):
        """Overlap rectangle [xmin, ymin, xmax, ymax] with another frame, or
        None (the frame-switch region, omgtools schedulerproblem.py:409-431)."""
        b1, b2 = self.border, other.border
        xmin, ymin = max(b1[0], b2[0]), max(b1[1], b2[1])
        xmax, ymax = min(b1[2], b2[2]), min(b1[3], b2[3])
        if xmin >= xmax or ymin >= ymax:
            return None
        return [xmin, ymin, xmax, ymax]

    def fix_endpoint_reachability(self, vehicle_size=0.2, margin=0.1):
        """Make the frame's local goal reachable (omgtools frame.py:212+
        'last waypoint reachability fixes'): (1) clamp it at least
        vehicle_size + margin inside the frame border -- the local problem's
        room constraint keeps the vehicle CENTER that far inside, so a goal
        closer to the border makes the terminal equality structurally
        infeasible; (2) move it back along the global path until it is not
        inside (the inflation of) any in-frame obstacle."""
        if not hasattr(self, "goal"):
            return
        b = self.border
        m = vehicle_size + 0.5 * margin
        if b[2] - b[0] > 2 * m and b[3] - b[1] > 2 * m:
            self.goal = np.clip(np.asarray(self.goal, dtype=np.float64),
                                [b[0] + m, b[1] + m], [b[2] - m, b[3] - m])
        obstacles = self.stationary_obstacles + self.moving_obstacles \
            or self.environment.obstacles

        def blocked(p):
            for obs in obstacles:
                pos = obs.signals["position"][:2, -1]
                chck, rad = obs.shape.get_checkpoints()
                infl = float(np.max(rad)) + vehicle_size + margin
                lo = np.min(np.asarray(chck), axis=0) + pos - infl
                hi = np.max(np.asarray(chck), axis=0) + pos + infl
                if np.all(p >= lo[:2]) and np.all(p <= hi[:2]):
                    return True
            return False

        if not blocked(self.goal):
            return
        candidates = []
        if self.global_path is not None:
            candidates = [np.asarray(w, dtype=np.float64)
                          for w in self.waypoints_in_frame(self.global_path)]
        for w in reversed(candidates):
            if not blocked(w):
                self.goal = w
                return
        # fall back: walk from the endpoint toward the frame start
        start = getattr(self, "start", self.center)
        for alpha in np.linspace(0.1, 1.0, 10):
            p = (1 - alpha) * np.asarray(self.goal) + alpha * np.asarray(start)
            if not blocked(p):
                self.goal = p
                return


class ShiftFrame(Frame):
    """Fixed-size frame centered near the vehicle, shifted toward the next
    goal direction, clipped to the room (omgtools frame.py:366-518)."""

    def __init__(self, environment, start, goal, frame_size, move_limit=0.5,
                 global_path=None, options=None):
        room = environment.room[0]
        lims = room["shape"].get_canvas_limits()
        xlim = lims[0] + room["position"][0]
        ylim = lims[1] + room["position"][1]
        w = h = float(frame_size)
        start = np.asarray(start, dtype=np.float64)
        goal = np.asarray(goal, dtype=np.float64)
        direction = goal - start
        nrm = np.linalg.norm(direction)
        if nrm > 1e-9:
            direction = direction / nrm
        shift = min(move_limit, 0.375 * w) * direction
        center = start + shift
        cx = np.clip(center[0], xlim[0] + w / 2, xlim[1] - w / 2)
        cy = np.clip(center[1], ylim[0] + h / 2, ylim[1] - h / 2)
        border = [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
        Frame.__init__(self, environment, border, global_path, options)
        self.start = start
        self.goal = self._endpoint(goal)

    def _endpoint(self, goal):
        """Local goal: the global goal if inside the frame, else the last
        global-path waypoint inside the frame (or the border projection)."""
        if self.point_in_frame(goal):
            return np.asarray(goal, dtype=np.float64)
        if self.global_path is not None:
            inside = self.waypoints_in_frame(self.global_path)
            if inside:
                return np.asarray(inside[-1], dtype=np.float64)
        b = self.border
        return np.array([np.clip(goal[0], b[0], b[2]),
                         np.clip(goal[1], b[1], b[3])])


class CorridorFrame(Frame):
    """Corridor built with omgtools' two-stage algorithm
    (frame.py:520-918): (1) a BASE FRAME grown by including successive
    global-path waypoints until a stationary obstacle would fall inside
    (create_corridor_base_frame) -- so the corridor extends ALONG the
    path, not just around the start; (2) per-side scale-up until the room
    border or an obstacle blocks further growth (scale_up_frame)."""

    def __init__(self, environment, start, goal, global_path=None,
                 margin=0.2, step=0.1, options=None):
        room = environment.room[0]
        lims = room["shape"].get_canvas_limits()
        xlim = lims[0] + room["position"][0]
        ylim = lims[1] + room["position"][1]
        start = np.asarray(start, dtype=np.float64)
        border = [start[0] - margin, start[1] - margin,
                  start[0] + margin, start[1] + margin]
        obstacles = [o for o in environment.obstacles
                     if o.options.get("avoid", True)]

        def blocked(cand):
            probe = Frame(environment, cand)
            for obs in obstacles:
                pos = obs.signals["position"][:2, -1]
                if probe._shape_overlaps(obs.shape, pos):
                    return True
            return False

        def include(cand_border, pt):
            c = [min(cand_border[0], pt[0] - margin),
                 min(cand_border[1], pt[1] - margin),
                 max(cand_border[2], pt[0] + margin),
                 max(cand_border[3], pt[1] + margin)]
            return [max(c[0], xlim[0]), max(c[1], ylim[0]),
                    min(c[2], xlim[1]), min(c[3], ylim[1])]

        # stage 1 (omgtools create_corridor_base_frame): walk the path
        # from the waypoint nearest the start, absorbing waypoints while
        # the obstacle-free property holds; try the endpoint first
        path = [np.asarray(p, dtype=np.float64) for p in (global_path or [])]
        if path:
            dists = [np.linalg.norm(p - start) for p in path]
            path = path[int(np.argmin(dists)):]
            cand = include(border, path[-1])
            if not blocked(cand):
                border = cand
            else:
                for pt in path:
                    cand = include(border, pt)
                    if blocked(cand):
                        break
                    border = cand

        # stage 2 (omgtools scale_up_frame): per-side growth until blocked
        grow = [True, True, True, True]   # xmin, ymin, xmax, ymax
        for _ in range(int(max(xlim[1] - xlim[0], ylim[1] - ylim[0]) / step)
                       * 4):
            if not any(grow):
                break
            for k in range(4):
                if not grow[k]:
                    continue
                cand = list(border)
                cand[k] += step if k >= 2 else -step
                limit = [xlim[0], ylim[0], xlim[1], ylim[1]][k]
                if (k < 2 and cand[k] < limit) or (k >= 2 and cand[k] > limit):
                    grow[k] = False
                    continue
                if blocked(cand):
                    grow[k] = False
                else:
                    border = cand
        Frame.__init__(self, environment, border, global_path, options)
        self.start = start
        goal = np.asarray(goal, dtype=np.float64)
        self.goal = goal if self.point_in_frame(goal) else \
            ShiftFrame._endpoint(self, goal)


def create_l_shape(environment, start, goal, global_path, margin=0.2,
                   step=0.1):
    """Two overlapping corridor frames covering an L-shaped path piece
    (omgtools frame.py:777 ``create_l_shape``): the first corridor grows
    around the path start; if the global path exits it before reaching the
    goal (the corridor hit a corner), a second corridor grows from the exit
    waypoint along the remaining path.  Returns [frame] or [frame1, frame2].
    """
    path = [np.asarray(p, dtype=np.float64) for p in (global_path or [])]

    def first_exit(frame):
        # first waypoint OUTSIDE the frame marks the corner
        for k, p in enumerate(path):
            if not frame.point_in_frame(p):
                return k
        return None

    frame1 = CorridorFrame(environment, start, goal,
                           global_path=global_path, margin=margin, step=step)
    if frame1.point_in_frame(goal):
        return [frame1]
    exit_idx = first_exit(frame1)
    if exit_idx is not None and exit_idx <= 1 and len(path) > 1:
        # Degenerate corridor: the frame contains no forward path.  This
        # happens when the vehicle hugs an obstacle corner -- the start
        # box (start +/- margin) touches the obstacle band, so absorbing
        # the next waypoint is "blocked" and the scale-up then grows the
        # corridor ORTHOGONAL to the route (e.g. back down through an
        # already-traversed gap).  Rebuild the corridor from the next
        # waypoint so it tracks the path; keep it only if the vehicle is
        # inside (the local problem's initial state must be coverable).
        # retry from successive later waypoints: the first rebuild can land
        # on the same degenerate corner geometry (it neither contains the
        # start nor overlaps frame1), in which case a corridor seeded one
        # waypoint further usually clears the obstacle band
        for k in range(1, min(len(path), 4)):
            cand = CorridorFrame(environment, path[k], goal,
                                 global_path=path[k:], margin=margin,
                                 step=step)
            if cand.point_in_frame(start):
                frame1 = cand
                if frame1.point_in_frame(goal):
                    return [frame1]
                exit_idx = first_exit(frame1)
                break
            if frame1.overlap_with(cand) is not None:
                return [frame1, cand]
    if exit_idx is None or exit_idx == 0:
        return [frame1]
    corner = path[exit_idx - 1]
    frame2 = CorridorFrame(environment, corner, goal,
                           global_path=path[exit_idx - 1:],
                           margin=margin, step=step)
    if frame1.overlap_with(frame2) is None:
        # disjoint corridors can't hand off; grow frame2 from inside frame1
        frame2 = CorridorFrame(environment,
                               0.5 * (corner + np.asarray(frame1.center)),
                               goal, global_path=path[max(exit_idx - 2, 0):],
                               margin=margin, step=step)
        if frame1.overlap_with(frame2) is None:
            return [frame1]
    return [frame1, frame2]

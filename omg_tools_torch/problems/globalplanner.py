"""Occupancy-grid A* global planner (a copy of
``omg_tools_tpu.problems.globalplanner``, after omgtools
problems/globalplanner.py): a grid with obstacle inflation by vehicle size,
8-connected neighbors with the diagonal-blocking rule, waypoint
extraction.  Host-side numpy (the planner is not on the hot path; it
reseeds local problems at frame switches).
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np

from ..environment.shapes import Circle, Rectangle, Square
from ..utils.geometry import circle_polyhedron_intersect

__all__ = ["GlobalPlanner", "QuadmapPlanner", "AStarPlanner", "Grid"]


class Grid:
    """Regular occupancy grid over a rectangular region."""

    def __init__(self, width, height, position, n_cells):
        self.width = float(width)
        self.height = float(height)
        self.position = np.asarray(position, dtype=np.float64)
        self.n_cells = [int(n_cells[0]), int(n_cells[1])]
        self.cell_w = self.width / self.n_cells[0]
        self.cell_h = self.height / self.n_cells[1]
        self.occupied = np.zeros(self.n_cells, dtype=bool)

    def cell_center(self, ij) -> np.ndarray:
        i, j = ij
        x = self.position[0] - 0.5 * self.width + (i + 0.5) * self.cell_w
        y = self.position[1] - 0.5 * self.height + (j + 0.5) * self.cell_h
        return np.array([x, y])

    def point_to_cell(self, point) -> Tuple[int, int]:
        p = np.asarray(point, dtype=np.float64)
        i = int((p[0] - self.position[0] + 0.5 * self.width) // self.cell_w)
        j = int((p[1] - self.position[1] + 0.5 * self.height) // self.cell_h)
        return (min(max(i, 0), self.n_cells[0] - 1),
                min(max(j, 0), self.n_cells[1] - 1))

    def in_bounds(self, ij) -> bool:
        return 0 <= ij[0] < self.n_cells[0] and 0 <= ij[1] < self.n_cells[1]

    def free(self, ij) -> bool:
        return self.in_bounds(ij) and not self.occupied[ij[0], ij[1]]

    def block(self, ij):
        if self.in_bounds(ij):
            self.occupied[ij[0], ij[1]] = True

    def mark_obstacle(self, obstacle, inflation=0.0):
        """Mark every cell whose center is within the inflated obstacle
        (omgtools globalplanner.py:428-522)."""
        pos = obstacle.signals["position"][:, -1] \
            if hasattr(obstacle, "signals") else obstacle["position"]
        shape = obstacle.shape if hasattr(obstacle, "shape") \
            else obstacle["shape"]
        for i in range(self.n_cells[0]):
            for j in range(self.n_cells[1]):
                c = self.cell_center((i, j))
                r_cell = 0.5 * np.hypot(self.cell_w, self.cell_h)
                if isinstance(shape, Circle):
                    if np.linalg.norm(c - pos[:2]) <= (shape.radius
                                                       + inflation + r_cell):
                        self.occupied[i, j] = True
                elif isinstance(shape, (Rectangle, Square)):
                    if (abs(c[0] - pos[0]) <= 0.5 * shape.width + inflation
                            + r_cell
                            and abs(c[1] - pos[1]) <= 0.5 * shape.height
                            + inflation + r_cell):
                        self.occupied[i, j] = True
                else:
                    chck, rad = shape.get_checkpoints()
                    verts = (np.asarray(chck) + pos[:2]).T
                    if circle_polyhedron_intersect(c, inflation + r_cell
                                                   + float(np.max(rad)),
                                                   verts):
                        self.occupied[i, j] = True

    def move_to_free(self, ij):
        """Snap a blocked cell to the nearest free one
        (omgtools globalplanner.py:354-404)."""
        if self.free(ij):
            return ij
        best, best_d = None, np.inf
        for r in range(1, max(self.n_cells)):
            for di in range(-r, r + 1):
                for dj in (-r, r):
                    for cand in [(ij[0] + di, ij[1] + dj),
                                 (ij[0] + dj, ij[1] + di)]:
                        if self.free(cand):
                            d = di * di + dj * dj
                            if d < best_d:
                                best, best_d = cand, d
            if best is not None:
                return best
        raise RuntimeError("no free cell found")


class GlobalPlanner:
    """Planner interface (omgtools globalplanner.py:27-37)."""

    def __init__(self, environment):
        self.environment = environment

    def get_path(self, curr_state, goal_state):
        raise NotImplementedError


class QuadmapPlanner(GlobalPlanner):
    """Quadtree-map planner: declared but not implemented, in omgtools
    as well (globalplanner.py:39-46)."""

    def __init__(self, environment):
        GlobalPlanner.__init__(self, environment)
        raise NotImplementedError("QuadmapPlanner is not implemented; "
                                  "use AStarPlanner")


class AStarPlanner(GlobalPlanner):
    """8-connected A* with diagonal blocking
    (omgtools globalplanner.py:147-227,319-352)."""

    def __init__(self, environment, n_cells, start, goal, options=None,
                 vehicle_size=0.0):
        room = environment.room[0]
        lims = room["shape"].get_canvas_limits()
        width = float(lims[0][1] - lims[0][0])
        height = float(lims[1][1] - lims[1][0])
        self.grid = Grid(width, height, room["position"][:2], n_cells)
        self.environment = environment
        self.vehicle_size = vehicle_size
        for obstacle in environment.obstacles:
            if obstacle.options.get("avoid", True):
                self.grid.mark_obstacle(obstacle, inflation=vehicle_size)
        self.start = np.asarray(start, dtype=np.float64)
        self.goal = np.asarray(goal, dtype=np.float64)

    def set_start(self, start):
        self.start = np.asarray(start, dtype=np.float64)

    def set_goal(self, goal):
        self.goal = np.asarray(goal, dtype=np.float64)

    def _neighbors(self, ij):
        i, j = ij
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                if di == 0 and dj == 0:
                    continue
                cand = (i + di, j + dj)
                if not self.grid.free(cand):
                    continue
                if di != 0 and dj != 0:
                    # diagonal move only if both orthogonal cells free
                    if not (self.grid.free((i + di, j))
                            and self.grid.free((i, j + dj))):
                        continue
                yield cand, np.hypot(di * self.grid.cell_w,
                                     dj * self.grid.cell_h)

    def get_path(self, start=None, goal=None) -> Optional[List[np.ndarray]]:
        if start is not None:
            self.set_start(start)
        if goal is not None:
            self.set_goal(goal)
        s = self.grid.move_to_free(self.grid.point_to_cell(self.start))
        g = self.grid.move_to_free(self.grid.point_to_cell(self.goal))

        def h(ij):
            return np.linalg.norm(self.grid.cell_center(ij)
                                  - self.grid.cell_center(g))

        open_set = [(h(s), 0.0, s)]
        came: dict = {}
        cost = {s: 0.0}
        closed = set()
        while open_set:
            _, c, cur = heapq.heappop(open_set)
            if cur == g:
                path = [cur]
                while cur in came:
                    cur = came[cur]
                    path.append(cur)
                path.reverse()
                pts = [self.grid.cell_center(ij) for ij in path]
                pts[0] = self.start.copy()
                pts[-1] = self.goal.copy()
                return pts
            if cur in closed:
                continue
            closed.add(cur)
            for nxt, step in self._neighbors(cur):
                nc = c + step
                if nc < cost.get(nxt, np.inf):
                    cost[nxt] = nc
                    came[nxt] = cur
                    heapq.heappush(open_set, (nc + h(nxt), nc, nxt))
        return None

    def grid_path_to_waypoints(self, path, spacing=None):
        """Optionally thin the waypoint list (omgtools
        globalplanner.py:239-249)."""
        if path is None:
            return None
        if spacing is None:
            return path
        out = [path[0]]
        for p in path[1:-1]:
            if np.linalg.norm(p - out[-1]) >= spacing:
                out.append(p)
        out.append(path[-1])
        return out


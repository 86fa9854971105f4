"""Shape library: vehicle/obstacle/room geometry.

Host-side numpy.  Each shape exposes the three interfaces the optimization
layers consume (mirroring omgtools' basics/shape.py).  A copy of
``omg_tools_tpu.environment.shapes``, kept here so the port imports nothing
of the JAX package:

- ``get_checkpoints() -> (points (k, n_dim), radii (k,))`` -- the points (in
  body frame) whose inflated positions must satisfy separating-hyperplane
  collision constraints;
- ``get_hyperplanes(position)`` -- outward half-space description a.x <= b of
  a convex 2D shape (used for room constraints);
- ``get_canvas_limits() -> per-axis (min, max)``.

``draw(pose)`` returns polyline vertex arrays for plotting (no matplotlib
dependency here).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "Shape", "Shape2D", "Circle", "Cylinder", "Ring", "Polyhedron", "Beam",
    "RegularPolyhedron", "Rectangle", "Square", "UFO",
    "Shape3D", "Sphere", "Polyhedron3D", "RegularPrisma", "Cuboid", "Cube",
    "Plate",
]


def _rot2(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def _rot3(euler):
    """Roll-pitch-yaw (x, y, z) rotation matrix."""
    rx, ry, rz = euler
    cx, sx, cy, sy, cz, sz = (np.cos(rx), np.sin(rx), np.cos(ry),
                              np.sin(ry), np.cos(rz), np.sin(rz))
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


class Shape:
    n_dim = None

    def get_checkpoints(self):
        raise NotImplementedError

    def get_canvas_limits(self):
        raise NotImplementedError

    def draw(self, pose=None):
        return [], []


class Shape2D(Shape):
    n_dim = 2

    def __init__(self, outlines):
        self.outlines = outlines  # list of (2, k) vertex arrays

    def draw(self, pose=None):
        pose = np.zeros(3) if pose is None else np.asarray(pose, dtype=np.float64)
        R = _rot2(pose[2] if len(pose) > 2 else 0.0)
        return ([pose[:2, None] + R @ o for o in self.outlines], [])


class Circle(Shape2D):
    def __init__(self, radius):
        self.radius = float(radius)
        s = np.linspace(0, 2 * np.pi, 60)
        Shape2D.__init__(self, [np.vstack((radius * np.cos(s),
                                           radius * np.sin(s)))])

    def get_checkpoints(self):
        return np.zeros((1, 2)), np.array([self.radius])

    def get_canvas_limits(self):
        r = self.radius
        return [np.array([-r, r]), np.array([-r, r])]


class Cylinder(Circle):
    """2D footprint of a cylinder (matches reference shape.py:70-76)."""


class Ring(Shape2D):
    """Arc annulus between radius_in and radius_out from angle start to end
    (used as G-code G02/G03 tolerance tube; reference shape.py:79-127)."""

    def __init__(self, radius_in, radius_out, start, end, direction="CW"):
        self.radius_in = float(radius_in)
        self.radius_out = float(radius_out)
        self.start = float(start)
        self.end = float(end)
        self.direction = direction
        s = self._angles(60)
        Shape2D.__init__(self, [
            np.vstack((radius_in * np.cos(s), radius_in * np.sin(s))),
            np.vstack((radius_out * np.cos(s), radius_out * np.sin(s)))])

    def _angles(self, n):
        start, end = self.start, self.end
        if self.direction == "CW":
            if end > start:
                end -= 2 * np.pi
        else:
            if end < start:
                end += 2 * np.pi
        return np.linspace(start, end, n)

    def get_canvas_limits(self):
        s = self._angles(120)
        x = self.radius_out * np.cos(s)
        y = self.radius_out * np.sin(s)
        return [np.array([x.min(), x.max()]), np.array([y.min(), y.max()])]


class Polyhedron(Shape2D):
    def __init__(self, vertices, orientation=0.0, radius=1e-3):
        vertices = np.asarray(vertices, dtype=np.float64)
        if vertices.shape[0] != 2:
            vertices = vertices.T
        self.orientation = float(orientation)
        self.vertices = _rot2(self.orientation) @ vertices  # (2, n_vert)
        self.n_vert = self.vertices.shape[1]
        # small inflation so polyhedron-polyhedron avoidance is well-posed
        self.radius = float(radius)
        Shape2D.__init__(self, [np.c_[self.vertices, self.vertices[:, :1]]])

    def get_checkpoints(self):
        return self.vertices.T.copy(), np.full(self.n_vert, self.radius)

    def get_canvas_limits(self):
        mn, mx = self.vertices.min(axis=1), self.vertices.max(axis=1)
        return [np.array([mn[0], mx[0]]), np.array([mn[1], mx[1]])]

    def get_hyperplanes(self, position=(0.0, 0.0)):
        """Outward edge normals: a.x <= b describes the inside."""
        v = np.c_[self.vertices, self.vertices[:, :1]]
        planes = {}
        for k in range(self.n_vert):
            edge = v[:, k + 1] - v[:, k]
            normal = np.array([-edge[1], edge[0]]) / np.linalg.norm(edge)
            b = normal @ (v[:, k + 1] + np.asarray(position))
            planes[k] = {"a": normal, "b": b}
        return planes


class Beam(Polyhedron):
    """Line segment of given width inflated by height/2 (capsule)."""

    def __init__(self, width, height, orientation=0.0):
        self.width = float(width)
        self.height = float(height)
        Polyhedron.__init__(self, np.c_[[0.5 * width, 0.0], [-0.5 * width, 0.0]],
                            orientation=orientation, radius=0.5 * height)


class RegularPolyhedron(Polyhedron):
    def __init__(self, radius, n_vert, orientation=0.0):
        # radius = circumradius
        angles = 2 * np.pi * (np.arange(n_vert) + 0.5) / n_vert
        vertices = radius * np.vstack((np.sin(angles), np.cos(angles)))
        Polyhedron.__init__(self, vertices, orientation)
        self.radius_circum = float(radius)


class Rectangle(Polyhedron):
    def __init__(self, width, height, orientation=0.0):
        self.width = float(width)
        self.height = float(height)
        w, h = 0.5 * width, 0.5 * height
        Polyhedron.__init__(self, np.array([[w, w, -w, -w], [h, -h, -h, h]]),
                            orientation)


class Square(Rectangle):
    def __init__(self, side, orientation=0.0):
        Rectangle.__init__(self, side, side, orientation)


class UFO(Rectangle):
    """Rectangle collision model with a fancy drawing (reference
    shape.py:245-257)."""

    def __init__(self, width, height, orientation=0.0):
        Rectangle.__init__(self, width, height, orientation)
        w, h = width, height
        px = np.array([-0.5, -0.2, 0.2, 0.5, 0.2, 0.15, -0.15, -0.2, -0.5]) * w
        py = np.array([-0.15, -0.5, -0.5, -0.15, 0.2, 0.5, 0.5, 0.2, -0.15]) * h
        self.outlines = [np.vstack((px, py))]


class Shape3D(Shape):
    n_dim = 3

    def __init__(self, outlines):
        self.outlines = outlines  # list of (3, k)

    def draw(self, pose=None):
        pose = np.zeros(6) if pose is None else np.asarray(pose, dtype=np.float64)
        R = _rot3(pose[3:6])
        return ([pose[:3, None] + R @ o for o in self.outlines], [])


class Sphere(Shape3D):
    def __init__(self, radius):
        self.radius = float(radius)
        s = np.linspace(0, 2 * np.pi, 40)
        rings = []
        for phi in np.linspace(-np.pi / 3, np.pi / 3, 5):
            r, z = radius * np.cos(phi), radius * np.sin(phi)
            rings.append(np.vstack((r * np.cos(s), r * np.sin(s),
                                    np.full_like(s, z))))
        Shape3D.__init__(self, rings)

    def get_checkpoints(self):
        return np.zeros((1, 3)), np.array([self.radius])

    def get_canvas_limits(self):
        r = self.radius
        return [np.array([-r, r])] * 3


class Polyhedron3D(Shape3D):
    def __init__(self, vertices, orientation=(0, 0, 0), radius=1e-3):
        vertices = np.asarray(vertices, dtype=np.float64)
        if vertices.shape[0] != 3:
            vertices = vertices.T
        self.vertices = _rot3(orientation) @ vertices  # (3, n)
        self.n_vert = self.vertices.shape[1]
        self.radius = float(radius)
        Shape3D.__init__(self, [np.c_[self.vertices, self.vertices[:, :1]]])

    def get_checkpoints(self):
        return self.vertices.T.copy(), np.full(self.n_vert, self.radius)

    def get_canvas_limits(self):
        mn, mx = self.vertices.min(axis=1), self.vertices.max(axis=1)
        return [np.array([mn[k], mx[k]]) for k in range(3)]


class RegularPrisma(Polyhedron3D):
    def __init__(self, radius, height, n_faces, orientation=(0, 0, 0)):
        angles = 2 * np.pi * np.arange(n_faces) / n_faces
        ring = radius * np.vstack((np.cos(angles), np.sin(angles)))
        bottom = np.vstack((ring, np.full(n_faces, -0.5 * height)))
        top = np.vstack((ring, np.full(n_faces, 0.5 * height)))
        Polyhedron3D.__init__(self, np.c_[bottom, top], orientation)


class Cuboid(Polyhedron3D):
    def __init__(self, width, depth, height, orientation=(0, 0, 0)):
        self.width, self.depth, self.height = (float(width), float(depth),
                                               float(height))
        w, d, h = 0.5 * width, 0.5 * depth, 0.5 * height
        sign = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                         for sz in (-1, 1)], dtype=np.float64)
        Polyhedron3D.__init__(self, (sign * np.array([w, d, h])).T, orientation)

    def get_canvas_limits(self):
        w, d, h = 0.5 * self.width, 0.5 * self.depth, 0.5 * self.height
        return [np.array([-w, w]), np.array([-d, d]), np.array([-h, h])]


class Cube(Cuboid):
    def __init__(self, side, orientation=(0, 0, 0)):
        Cuboid.__init__(self, side, side, side, orientation)


class Plate(Polyhedron3D):
    """2D shape extruded over a (small) height (reference shape.py:188+)."""

    def __init__(self, shape2d, height, orientation=(0, 0, 0)):
        self.shape2d = shape2d
        self.height = float(height)
        chck, rad = shape2d.get_checkpoints()
        pts = []
        for z in (-0.5 * height, 0.5 * height):
            for c in chck:
                pts.append([c[0], c[1], z])
        Polyhedron3D.__init__(self, np.asarray(pts).T, orientation,
                              radius=float(np.max(rad)))

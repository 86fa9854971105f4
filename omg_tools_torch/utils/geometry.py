"""2D geometry predicates (host-side numpy).

A copy of ``omg_tools_tpu.utils.geometry``.  Covers omgtools' geometry
toolbox (basics/geometry.py): distances, orientation tests,
segment/line intersections, containment, and overlap predicates used by the
frame/scheduler machinery and obstacle bounce simulation.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "distance_between_points", "distance_to_segment", "ccw", "orientation",
    "segments_intersect", "line_segment_intersection",
    "point_in_polyhedron", "point_in_rectangle", "circle_polyhedron_intersect",
    "rectangles_overlap", "overlap_region",
]


def distance_between_points(p, q):
    return float(np.linalg.norm(np.asarray(p, dtype=np.float64) -
                                np.asarray(q, dtype=np.float64)))


def distance_to_segment(p, a, b):
    """Distance from point p to segment [a, b]."""
    p, a, b = (np.asarray(v, dtype=np.float64) for v in (p, a, b))
    d = b - a
    L2 = d @ d
    if L2 == 0.0:
        return float(np.linalg.norm(p - a))
    t = np.clip((p - a) @ d / L2, 0.0, 1.0)
    return float(np.linalg.norm(p - (a + t * d)))


def ccw(a, b, c):
    """Twice the signed area of triangle abc (>0: counterclockwise)."""
    a, b, c = (np.asarray(v, dtype=np.float64) for v in (a, b, c))
    return float((b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0]))


def orientation(a, b, c, tol=1e-12):
    v = ccw(a, b, c)
    return 0 if abs(v) < tol else (1 if v > 0 else -1)


def segments_intersect(p1, p2, q1, q2):
    """True if segments [p1,p2] and [q1,q2] intersect (incl. endpoints)."""
    o1, o2 = orientation(p1, p2, q1), orientation(p1, p2, q2)
    o3, o4 = orientation(q1, q2, p1), orientation(q1, q2, p2)
    if o1 != o2 and o3 != o4:
        return True

    def on_seg(a, b, c):
        return (min(a[0], b[0]) - 1e-12 <= c[0] <= max(a[0], b[0]) + 1e-12 and
                min(a[1], b[1]) - 1e-12 <= c[1] <= max(a[1], b[1]) + 1e-12)
    if o1 == 0 and on_seg(p1, p2, q1):
        return True
    if o2 == 0 and on_seg(p1, p2, q2):
        return True
    if o3 == 0 and on_seg(q1, q2, p1):
        return True
    if o4 == 0 and on_seg(q1, q2, p2):
        return True
    return False


def line_segment_intersection(p1, p2, q1, q2):
    """Intersection point of lines through the segments, or None if
    parallel."""
    p1, p2, q1, q2 = (np.asarray(v, dtype=np.float64)
                      for v in (p1, p2, q1, q2))
    d1, d2 = p2 - p1, q2 - q1
    denom = d1[0] * d2[1] - d1[1] * d2[0]
    if abs(denom) < 1e-14:
        return None
    t = ((q1[0] - p1[0]) * d2[1] - (q1[1] - p1[1]) * d2[0]) / denom
    return p1 + t * d1


def point_in_polyhedron(p, vertices, margin=0.0):
    """p inside convex polygon given by (2, n) counterclockwise-or-clockwise
    vertex matrix (works for either winding)."""
    v = np.asarray(vertices, dtype=np.float64)
    if v.shape[0] != 2:
        v = v.T
    n = v.shape[1]
    signs = []
    for k in range(n):
        a, b = v[:, k], v[:, (k + 1) % n]
        signs.append(ccw(a, b, p))
    signs = np.array(signs)
    return bool(np.all(signs >= -margin) or np.all(signs <= margin))


def point_in_rectangle(p, center, width, height, orientation_angle=0.0,
                       margin=0.0):
    p = np.asarray(p, dtype=np.float64) - np.asarray(center, dtype=np.float64)
    c, s = np.cos(-orientation_angle), np.sin(-orientation_angle)
    local = np.array([c * p[0] - s * p[1], s * p[0] + c * p[1]])
    return (abs(local[0]) <= 0.5 * width + margin and
            abs(local[1]) <= 0.5 * height + margin)


def circle_polyhedron_intersect(center, radius, vertices):
    """Circle overlaps convex polygon (vertices (2, n))."""
    v = np.asarray(vertices, dtype=np.float64)
    if v.shape[0] != 2:
        v = v.T
    if point_in_polyhedron(center, v):
        return True
    n = v.shape[1]
    for k in range(n):
        if distance_to_segment(center, v[:, k], v[:, (k + 1) % n]) <= radius:
            return True
    return False


def rectangles_overlap(c1, w1, h1, c2, w2, h2):
    """Axis-aligned rectangle overlap."""
    c1, c2 = np.asarray(c1, dtype=np.float64), np.asarray(c2, dtype=np.float64)
    return (abs(c1[0] - c2[0]) <= 0.5 * (w1 + w2) and
            abs(c1[1] - c2[1]) <= 0.5 * (h1 + h2))


def overlap_region(c1, w1, h1, c2, w2, h2):
    """Center/size of the overlap of two axis-aligned rectangles, or None."""
    lo = np.maximum(np.asarray(c1) - [0.5 * w1, 0.5 * h1],
                    np.asarray(c2) - [0.5 * w2, 0.5 * h2])
    hi = np.minimum(np.asarray(c1) + [0.5 * w1, 0.5 * h1],
                    np.asarray(c2) + [0.5 * w2, 0.5 * h2])
    if np.any(hi <= lo):
        return None
    return 0.5 * (lo + hi), hi[0] - lo[0], hi[1] - lo[1]

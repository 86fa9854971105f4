"""SVG parsing into environment descriptions / G-code outlines.

A copy of ``omg_tools_tpu.gui.svg_reader`` (host numpy and
``xml.etree``), after omgtools' gui/svg_reader.py:6-340: read an SVG file,
extract basic shapes (<rect>, <circle>, <ellipse>), path elements (M/C/L
commands, classifying axis-aligned rectangles and circles from their Bezier
control points), and <line> elements; convert pixel coordinates to world
coordinates; and emit either an environment description (consumed by
EnvironmentGUI.build_environment) or a G-code segment list.

Everything stays in memory (omgtools writes intermediate
'environment.txt' files).
"""

from __future__ import annotations

import re
from xml.etree import ElementTree

import numpy as np

__all__ = ["SVGReader"]

_SVG_NS = "http://www.w3.org/2000/svg"


def _strip_unit(text):
    m = re.match(r"([0-9.eE+-]+)\s*([a-z%]*)", text.strip())
    return float(m.group(1)), m.group(2)


def _tokenize_path(d):
    """Yield (command, [floats]) for an SVG path 'd' string."""
    for cmd, body in re.findall(r"([MmLlCcZzHhVvSs])([^MmLlCcZzHhVvSs]*)", d):
        nums = [float(x) for x in
                re.findall(r"[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?", body)]
        yield cmd, nums


class SVGReader:

    def __init__(self):
        self.tree = None
        self.obstacles = []
        self.lines = []
        self.position = [0.0, 0.0]
        self.meter_to_pixel = 1.0

    # -- loading -------------------------------------------------------------
    def init(self, data):
        """Parse the file (path or file object) and read canvas geometry."""
        self.data = data
        self.tree = ElementTree.parse(data).getroot()
        width = self.tree.get("width")
        viewbox = self.tree.get("viewBox")
        if width is not None:
            w_val, w_unit = _strip_unit(width)
            h_val, _ = _strip_unit(self.tree.get("height", width))
            if viewbox is not None:
                xmin, ymin, xmax, ymax = [float(v) for v in
                                          re.split(r"[ ,]+", viewbox.strip())]
                self.width_px = xmax - xmin
                self.height_px = ymax - ymin
                if w_unit == "mm":
                    self.meter_to_pixel = self.width_px / (w_val * 1e-3)
                elif w_unit in ("px", ""):
                    self.meter_to_pixel = 1.0
            else:
                self.width_px, self.height_px = w_val, h_val
        elif viewbox is not None:
            xmin, ymin, xmax, ymax = [float(v) for v in
                                      re.split(r"[ ,]+", viewbox.strip())]
            self.width_px = xmax - xmin
            self.height_px = ymax - ymin
        else:
            raise ValueError("svg has neither width/height nor viewBox")
        self.obstacles = []
        self.lines = []

    def set_world_size(self, width_m, height_m, position=(0.0, 0.0)):
        """Map the pixel canvas onto a width_m x height_m world room."""
        self.meter_to_pixel = self.width_px / float(width_m)
        self.position = list(position)

    # -- element extraction ----------------------------------------------------
    def _iter(self, tag):
        return self.tree.iter(f"{{{_SVG_NS}}}{tag}")

    def convert_basic_shapes(self):
        """<rect>, <circle>, <ellipse> -> obstacle dicts (pixel coords,
        omgtools svg_reader.py:84-143)."""
        for el in self._iter("rect"):
            w = float(el.get("width")), float(el.get("height"))
            x0 = float(el.get("x", 0.0)), float(el.get("y", 0.0))
            self.obstacles.append({
                "shape": "rectangle", "width": w[0], "height": w[1],
                "pos": [x0[0] + 0.5 * w[0], x0[1] + 0.5 * w[1]]})
        for el in self._iter("circle"):
            self.obstacles.append({
                "shape": "circle", "radius": float(el.get("r")),
                "pos": [float(el.get("cx", 0.0)), float(el.get("cy", 0.0))]})
        for el in self._iter("ellipse"):
            rx, ry = float(el.get("rx")), float(el.get("ry"))
            # approximate ellipse by its bounding rectangle (omgtools
            # supports only rect/circle obstacles)
            self.obstacles.append({
                "shape": "rectangle", "width": 2 * rx, "height": 2 * ry,
                "pos": [float(el.get("cx", 0.0)), float(el.get("cy", 0.0))]})
        return self.obstacles

    def convert_path_to_points(self):
        """Path elements -> per-path absolute point lists
        (omgtools svg_reader.py:34-82)."""
        paths = []
        for el in self._iter("path"):
            pts = []
            cur = np.zeros(2)
            start = np.zeros(2)
            has_curves = False
            for cmd, nums in _tokenize_path(el.get("d", "")):
                rel = cmd.islower()
                if cmd in "Mm":
                    for k in range(0, len(nums), 2):
                        p = np.array(nums[k:k + 2])
                        cur = cur + p if (rel and pts) else p
                        pts.append(cur.copy())
                    start = pts[0]
                elif cmd in "Ll":
                    for k in range(0, len(nums), 2):
                        p = np.array(nums[k:k + 2])
                        cur = cur + p if rel else p
                        pts.append(cur.copy())
                elif cmd in "HhVv":
                    for v in nums:
                        if cmd in "Hh":
                            cur = np.array([cur[0] + v if rel else v, cur[1]])
                        else:
                            cur = np.array([cur[0], cur[1] + v if rel else v])
                        pts.append(cur.copy())
                elif cmd in "CcSs":
                    has_curves = True
                    stride = 6 if cmd in "Cc" else 4
                    for k in range(0, len(nums), stride):
                        seg = np.array(nums[k:k + stride]).reshape(-1, 2)
                        if rel:
                            seg = seg + cur
                        pts.extend(seg[:-1])
                        cur = seg[-1]
                        pts.append(cur.copy())
                elif cmd in "Zz":
                    cur = start
                    pts.append(cur.copy())
            if pts:
                paths.append((np.array(pts), has_curves))
        return paths

    def classify_paths(self):
        """Classify closed paths into rectangle/circle obstacles by their
        control-point geometry (omgtools svg_reader.py:34-143 heuristics)."""
        for pts, has_curves in self.convert_path_to_points():
            if len(pts) < 3:
                continue
            lo, hi = pts.min(axis=0), pts.max(axis=0)
            size = hi - lo
            center = 0.5 * (lo + hi)
            radii = np.linalg.norm(pts - center, axis=1)
            # straight-line polygons are rectangles (bbox); only
            # Bezier-described paths with near-constant radius are circles
            if has_curves and \
                    radii.std() < 0.05 * max(radii.mean(), 1e-9):
                self.obstacles.append({
                    "shape": "circle", "radius": float(radii.mean()),
                    "pos": center.tolist()})
            else:
                self.obstacles.append({
                    "shape": "rectangle", "width": float(size[0]),
                    "height": float(size[1]), "pos": center.tolist()})
        return self.obstacles

    def convert_lines(self):
        """<line>/<polyline>/<polygon> -> segment list (used for G-code
        outlines; omgtools svg_reader.py:145-258)."""
        for el in self._iter("line"):
            self.lines.append((
                [float(el.get("x1", 0)), float(el.get("y1", 0))],
                [float(el.get("x2", 0)), float(el.get("y2", 0))]))
        for tag in ("polyline", "polygon"):
            for el in self._iter(tag):
                nums = [float(v) for v in
                        re.findall(r"[-+]?[0-9]*\.?[0-9]+", el.get("points"))]
                pts = np.array(nums).reshape(-1, 2)
                for k in range(len(pts) - 1):
                    self.lines.append((pts[k].tolist(), pts[k + 1].tolist()))
                if tag == "polygon" and len(pts) > 2:
                    self.lines.append((pts[-1].tolist(), pts[0].tolist()))
        return self.lines

    # -- output ---------------------------------------------------------------
    def _to_world(self, p):
        """Pixel -> world: scale and flip y (SVG y grows downward)."""
        scale = 1.0 / self.meter_to_pixel
        return [self.position[0] + p[0] * scale,
                self.position[1] + (self.height_px - p[1]) * scale]

    def build_environment(self):
        """Environment description dict in world coordinates (consumed by
        EnvironmentGUI; omgtools svg_reader.py:312-324)."""
        self.convert_basic_shapes()
        self.classify_paths()
        scale = 1.0 / self.meter_to_pixel
        obstacles = []
        for obs in self.obstacles:
            out = dict(obs)
            out["pos"] = self._to_world(obs["pos"])
            for key in ("width", "height", "radius"):
                if key in out:
                    out[key] = out[key] * scale
            out.setdefault("velocity", [0.0, 0.0])
            out.setdefault("bounce", False)
            obstacles.append(out)
        # description "position" is the room CENTER (the EnvironmentGUI /
        # Environment convention); obstacle coordinates are world-absolute
        # with the SVG's lower-left corner at self.position
        return {"position": [self.position[0] + 0.5 * self.width_px * scale,
                             self.position[1] + 0.5 * self.height_px * scale],
                "width": self.width_px * scale,
                "height": self.height_px * scale,
                "obstacles": obstacles}

    def get_gcode_description(self):
        """Line segments as G01 command strings (world mm coordinates;
        omgtools svg_reader.py:326-340)."""
        self.convert_lines()
        commands = []
        for start, end in self.lines:
            s, e = self._to_world(start), self._to_world(end)
            commands.append(
                f"G01 X{e[0]:.6f} Y{e[1]:.6f}"
                if commands else
                f"G00 X{s[0]:.6f} Y{s[1]:.6f}")
            if not commands[-1].startswith("G01"):
                commands.append(f"G01 X{e[0]:.6f} Y{e[1]:.6f}")
        return commands

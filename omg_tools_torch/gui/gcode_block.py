"""G-code block objects (G00 rapid, G01 linear, G02/G03 circular arcs):
a copy of ``omg_tools_tpu.gui.gcode_block`` (host numpy), after omgtools'
gui/gcode_block.py.  Each block carries start/end (and arc center/radius)
in mm plus feedrate info; ``sample()`` returns points along the segment
for plotting and containment checks.
"""

from __future__ import annotations

import numpy as np

__all__ = ["GCodeBlock", "G00", "G01", "G02", "G03", "make_block"]


class GCodeBlock:
    default_F = 444.0      # feedrate [mm/min]
    default_S = 30000.0    # spindle speed [rev/min]

    def __init__(self, command, number, prev_block=None, start_pos=None):
        if prev_block is not None:
            start = list(prev_block.end)
        elif start_pos is not None:
            start = list(start_pos)
        else:
            start = [0.0, 0.0, 0.0]
        self.X0, self.Y0, self.Z0 = start
        self.X1 = command.get("X", self.X0)
        self.Y1 = command.get("Y", self.Y0)
        self.Z1 = command.get("Z", self.Z0)
        self.start = [self.X0, self.Y0, self.Z0]
        self.end = [self.X1, self.Y1, self.Z1]
        self.F = command.get("F", self.default_F)
        self.S = command.get("S", self.default_S)
        self.number = number

    def length(self):
        return float(np.linalg.norm(np.asarray(self.end)
                                    - np.asarray(self.start)))

    def sample(self, n=20):
        return np.linspace(self.start, self.end, n)

    def get_coordinates(self):
        return [self.start, self.end]


class G00(GCodeBlock):
    type = "G00"


class G01(GCodeBlock):
    type = "G01"


class _Arc(GCodeBlock):
    """Arc in the XY plane; center from I/J offsets."""

    clockwise = True

    def __init__(self, command, number, prev_block=None, start_pos=None):
        GCodeBlock.__init__(self, command, number, prev_block, start_pos)
        self.center = [self.X0 + command.get("I", 0.0),
                       self.Y0 + command.get("J", 0.0),
                       self.Z0 + command.get("K", 0.0)]
        self.radius = float(np.hypot(self.X0 - self.center[0],
                                     self.Y0 - self.center[1]))

    def angles(self):
        a0 = np.arctan2(self.Y0 - self.center[1], self.X0 - self.center[0])
        a1 = np.arctan2(self.Y1 - self.center[1], self.X1 - self.center[0])
        if self.clockwise:
            if a1 >= a0 - 1e-12:
                a1 -= 2 * np.pi
        else:
            if a1 <= a0 + 1e-12:
                a1 += 2 * np.pi
        return a0, a1

    def arc_angle(self):
        a0, a1 = self.angles()
        return abs(a1 - a0)

    def length(self):
        return self.radius * self.arc_angle()

    def sample(self, n=20):
        a0, a1 = self.angles()
        ang = np.linspace(a0, a1, n)
        z = np.linspace(self.Z0, self.Z1, n)
        return np.stack([self.center[0] + self.radius * np.cos(ang),
                         self.center[1] + self.radius * np.sin(ang), z],
                        axis=1)

    def get_coordinates(self):
        return [list(p) for p in self.sample(20)]


class G02(_Arc):
    type = "G02"
    clockwise = True


class G03(_Arc):
    type = "G03"
    clockwise = False


_TYPES = {"G00": G00, "G0": G00, "G01": G01, "G1": G01,
          "G02": G02, "G2": G02, "G03": G03, "G3": G03}


def make_block(gtype, command, number, prev_block=None, start_pos=None):
    cls = _TYPES.get(gtype)
    if cls is None:
        return None
    return cls(command, number, prev_block, start_pos)

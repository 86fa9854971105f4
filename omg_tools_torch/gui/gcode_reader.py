"""G-code (.nc) file reader: a copy of ``omg_tools_tpu.gui.gcode_reader``
(host numpy), after omgtools' gui/gcode_reader.py.  It parses commands
into GCodeBlock objects (a modal G-state; comment lines skipped), gives
the connections of consecutive blocks, and converts units (mm -> m).
File dialogs are replaced by explicit paths (headless).
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from .gcode_block import GCodeBlock, make_block

__all__ = ["GCodeReader"]

_WORD = re.compile(r"([A-Za-z])\s*(-?\d+\.?\d*)")


class GCodeReader:

    def __init__(self, filename: Optional[str] = None):
        self.filename = filename
        self.blocks: List[GCodeBlock] = []
        self.commands: List[str] = []

    # -- parsing -----------------------------------------------------------
    def load_file(self, filename: str):
        self.filename = filename
        with open(filename) as f:
            self.commands = [line.strip() for line in f
                             if line.strip() and not line.strip().startswith(
                                 ("%", "(", ";"))]
        return self.commands

    def parse(self, lines: Optional[List[str]] = None, start_pos=None):
        """Turn command lines into connected GCodeBlock objects."""
        lines = lines if lines is not None else self.commands
        self.blocks = []
        prev: Optional[GCodeBlock] = None
        number = 0
        modal = None   # modal G-state (a bare "X.. Y.." continues the last G)
        for line in lines:
            words = dict()
            gtype = None
            for letter, value in _WORD.findall(line):
                letter = letter.upper()
                if letter == "G":
                    gtype = f"G{int(float(value)):02d}"
                elif letter in "XYZIJKFS":
                    words[letter] = float(value)
                elif letter in ("N", "M", "T"):
                    continue
            if gtype is None:
                gtype = modal
            if gtype is None or not words:
                continue
            block = make_block(gtype, words, number, prev_block=prev,
                               start_pos=start_pos)
            if block is None:
                continue
            modal = gtype
            self.blocks.append(block)
            prev = block
            number += 1
        return self.blocks

    def read(self, filename: Optional[str] = None, start_pos=None):
        if filename is not None:
            self.load_file(filename)
        return self.parse(start_pos=start_pos)

    # -- utilities ---------------------------------------------------------
    def convert(self, blocks=None, scale=1e-3):
        """Scale coordinates (default: mm -> m), in place."""
        blocks = blocks if blocks is not None else self.blocks
        for b in blocks:
            for attr in ("X0", "Y0", "Z0", "X1", "Y1", "Z1"):
                setattr(b, attr, getattr(b, attr) * scale)
            b.start = [b.X0, b.Y0, b.Z0]
            b.end = [b.X1, b.Y1, b.Z1]
            if hasattr(b, "center"):
                b.center = [c * scale for c in b.center]
                b.radius = b.radius * scale
        return blocks

    def get_gcode(self, filename: Optional[str] = None, scale=1e-3,
                  start_pos=None):
        """One-call convenience: read + unit conversion."""
        blocks = self.read(filename, start_pos=start_pos)
        if scale != 1.0:
            blocks = self.convert(blocks, scale)
        return blocks

    def get_connections(self):
        """Start/end points of consecutive blocks (for plotting)."""
        return [(b.start, b.end) for b in self.blocks]

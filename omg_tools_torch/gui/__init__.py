"""Subpackage of omg_tools_torch (see the package docstring): the G-code
blocks and reader, the SVG reader and the environment editor's data
model."""

from .gcode_block import GCodeBlock, G00, G01, G02, G03
from .gcode_reader import GCodeReader
from .svg_reader import SVGReader
from .gui import EnvironmentGUI

__all__ = ["GCodeBlock", "G00", "G01", "G02", "G03", "GCodeReader",
           "SVGReader", "EnvironmentGUI"]

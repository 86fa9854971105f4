"""G-code machining: a tool follows a small part program inside tolerance
tubes: the JAX package's examples/gcode_example.py on omg_tools_torch
(omgtools' examples/GCode_examples).  The local GCodeProblems run the
default generic ALM mode on the card."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..'))  # repo-root import
from omg_tools_torch import Tool, GCodeReader, GCodeSchedulerProblem, Simulator
from _smoke import run

GCODE = """G00 X0 Y0 Z0
G01 X10 Y0 Z0
G01 X10 Y5 Z0
G01 X0 Y5 Z0
"""

reader = GCodeReader()
blocks = reader.parse(GCODE.strip().splitlines())
tool = Tool(tolerance=0.2)
tool.define_knots(knot_intervals=5)
tool.set_initial_conditions(blocks[0].start)
problem = GCodeSchedulerProblem(tool, blocks, n_segments=2)
problem.set_options({"verbose": 0})
problem.init()
run(problem, Simulator(problem, sample_time=0.001, update_time=0.01))
print("gcode: final", tool.signals["pose"][:3, -1])

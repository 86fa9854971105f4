"""Machine a rounded slot: linear moves joined by G02/G03 arcs -- ring
segments are split and followed inside ring-sector tolerance rooms: the JAX package's
examples/GCode_examples/gcodeproblem_rounded_slot.py on omg_tools_torch.  The
local GCodeProblems run the default generic ALM mode on the card."""
import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))  # repo-root import
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..'))
from omg_tools_torch import Tool, GCodeReader, GCodeSchedulerProblem, Simulator
from _smoke import run

# the part programs are the JAX package's, read where they lie
GCODE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..',
                         '..', 'examples', 'GCode_examples')

reader = GCodeReader()
reader.load_file(os.path.join(GCODE_DIR, "rounded_slot.nc"))
blocks = reader.parse()
tool = Tool(tolerance=0.25)
tool.define_knots(knot_intervals=5)
tool.set_initial_conditions(blocks[0].start)
problem = GCodeSchedulerProblem(tool, blocks, n_segments=2)
problem.set_options({"verbose": 0})
problem.init()
run(problem, Simulator(problem, sample_time=0.002, update_time=0.02))
print("gcode rounded slot: final", tool.signals["pose"][:3, -1],
      "segments:", len(blocks))

"""Rounded slot machined at three Z depths: G01 plunge moves between
planes: the JAX package's
examples/GCode_examples/gcodeproblem_multi_z.py on omg_tools_torch.  The
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
reader.load_file(os.path.join(GCODE_DIR, "multi_z.nc"))
blocks = reader.parse()
tool = Tool(tolerance=0.4)
tool.define_knots(knot_intervals=5)
tool.set_initial_conditions(blocks[0].start)
problem = GCodeSchedulerProblem(tool, blocks, n_segments=2)
problem.set_options({"verbose": 0})
problem.init()
run(problem, Simulator(problem, sample_time=0.002, update_time=0.02))
print("gcode multi_z: final", tool.signals["pose"][:3, -1],
      "blocks:", len(blocks))

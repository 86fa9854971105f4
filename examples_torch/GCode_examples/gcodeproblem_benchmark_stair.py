"""Benchmark: stair profile with tightened velocity/acceleration/jerk
bounds; prints the total machining (motion) time: the JAX package's
examples/GCode_examples/gcodeproblem_benchmark_stair.py on omg_tools_torch.  The
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
reader.load_file(os.path.join(GCODE_DIR, "stair.nc"))
blocks = reader.parse()
import time as _time
tool = Tool(tolerance=0.3,
            bounds={"vmax": 0.8, "amax": 2.0, "jmax": 20.0, "jmin": -20.0})
tool.define_knots(knot_intervals=5)
tool.set_initial_conditions(blocks[0].start)
problem = GCodeSchedulerProblem(tool, blocks, n_segments=2)
_t0 = _time.time()
problem.set_options({"verbose": 0})
problem.init()
run(problem, Simulator(problem, sample_time=0.002, update_time=0.02))
print("gcode benchmark_stair: final", tool.signals["pose"][:3, -1],
      "blocks:", len(blocks))
import time as _time2
print("wall time: %.2f s" % (_time2.time() - _t0))

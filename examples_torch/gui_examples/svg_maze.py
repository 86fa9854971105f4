"""SVG-built vast environment: a serpentine wall maze imported from an SVG
drawing through SVGReader -> EnvironmentGUI -> SchedulerProblem: the JAX
package's examples/gui_examples/svg_maze.py on omg_tools_torch (omgtools'
gui/svg_reader.py and gui.py:478-565).  The drawing is the JAX package's
examples/gui_examples/svg/maze_gen.svg, read where it lies; the local
problems run the default generic ALM mode on the card."""
import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', '..'))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..'))

from omg_tools_torch import (Holonomic, Circle, EnvironmentGUI,  # noqa: E402
                             SchedulerProblem, Simulator)
from _smoke import run  # noqa: E402

SVG = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..', '..',
                   'examples', 'gui_examples', 'svg', 'maze_gen.svg')

gui = EnvironmentGUI(display=False)
gui.load_svg(SVG, world_width=20.0)
environment = gui.get_environment()

veh_size = 0.5
vehicle = Holonomic(shapes=Circle(radius=veh_size),
                    options={"syslimit": "norm_2"},
                    bounds={"vmax": 1.5, "vmin": -1.5,
                            "amax": 8.0, "amin": -8.0})
# world frame: the SVG's lower-left corner is at (0, 0), room 20 x 12 m
vehicle.set_initial_conditions([1.0, 1.0])
vehicle.set_terminal_conditions([19.0, 11.0])

problem = SchedulerProblem(vehicle, environment, frame_type="corridor",
                           n_frames=2, n_cells=[40, 24], slot_quantum=4)
problem.set_options({"verbose": 0})
problem.init()
run(problem, Simulator(problem), n_smoke_steps=2)
print("svg_maze: final", vehicle.signals["pose"][:2, -1],
      "obstacles:", len(environment.obstacles))

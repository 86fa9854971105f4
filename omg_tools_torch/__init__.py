"""omg_tools_torch -- the PyTorch/CUDA port of omg_tools_tpu.

Spline-MPC motion planning: trajectories as B-spline coefficient vectors,
dynamics and separating-hyperplane collision constraints transcribed on
spline coefficients, warm-started receding-horizon ALM solves batched over
thousands of scenarios on one NVIDIA H100.

The port imports torch and numpy, never JAX nor anything of the JAX
package.  Its entry points run on CUDA unless the caller passes
``device="cpu"`` (a problem: the ``device`` option).  So far it covers
the Quick Start closed loop (``Point2point``, ``Simulator``, ``Deployer``)
with fixed or free motion time (``FreeTPoint2point``) and free end
points (``FreeEndPoint2point``), moving, rotating and spline-trajectory
obstacles, the distributed layer on one card (``Fleet``, the ADMM
formation ``FormationPoint2point`` and its device loop
``omg_tools_torch.parallel.FleetRunner``, the rendezvous ``RendezVous``,
dual decomposition ``DDProblem`` and
``FormationPoint2pointDualDecomposition``, and ``GenericADMMProblem``
over a user-defined shared quantity), the
vast-environment planner (``SchedulerProblem``: an ``AStarPlanner`` path,
moving frames, local ``FreeTPoint2point`` or ``MultiFrameProblem``s) with
``EnvironmentGUI``'s headless data model and its SVG import
(``SVGReader``), the centralized formation (``FormationPoint2pointCentral``),
G-code machining (``GCodeReader`` and the ``GCodeBlock``s, the ``Tool``
vehicle, ``GCodeProblem`` and the rolling window ``GCodeSchedulerProblem``),
the Holonomic, Holonomic1D, Holonomic3D, HolonomicOrient, Dubins, Bicycle,
AGV, Trailer, Quadrotor, Quadrotor3D and SimpleQuadrotor3D vehicles, the
batched rollouts of bench.py's p2p_holonomic, p2p_3dquadrotor and
p2p_dubins configurations (with per-scenario obstacle states), and the
solver backends: the ALM, the interior-point method (``solver="ipm"``,
``make_ip_solver``) and the scipy reference, the batched runner's
structures (``quadratic``, ``generic``, ``compact``, ``compact-arrow`` and
``compact-arrow-fused``), and the embedded C++ runtime's export
(``ExportP2P``, ``ExportFormation``, ``ExportRendezVous``);
``ROADMAP.md`` lists what is still to port.
"""

__version__ = "0.1.0"

from .ops.basis import Basis, clamped_basis, clamped_knots
from .ops.spline import (BSpline, Nurbs, TensorBSpline, circle_arc_splines,
                         evalspline, running_integral, definite_integral,
                         sample_spline)
from .environment.shapes import (Circle, Cylinder, Ring, Polyhedron, Beam,
                                 RegularPolyhedron, Rectangle, Square, UFO,
                                 Sphere, Polyhedron3D, RegularPrisma, Cuboid,
                                 Cube, Plate)
from .environment.environment import Environment
from .environment.obstacle import Obstacle
from .models.base import Vehicle
from .models.fleet import Fleet
from .models.holonomic import Holonomic
from .models.holonomic1d import Holonomic1D
from .models.holonomic3d import Holonomic3D
from .models.holonomicorient import HolonomicOrient
from .models.dubins import Dubins
from .models.bicycle import Bicycle
from .models.agv import AGV
from .models.trailer import Trailer
from .models.quadrotor import Quadrotor
from .models.quadrotor3d import Quadrotor3D, SimpleQuadrotor3D
from .models.tool import Tool
from .problems.problem import Problem
from .problems.point2point import (Point2point, Point2pointProblem,
                                   FixedTPoint2point, FreeTPoint2point,
                                   FreeEndPoint2point)
from .problems.batch import BatchedP2PRunner
from .problems.admm import ADMMProblem, DistributedProblem
from .problems.formation import FormationPoint2point
from .problems.formation_central import FormationPoint2pointCentral
from .problems.rendezvous import RendezVous
from .problems.dualdecomposition import (DDProblem,
                                         FormationPoint2pointDualDecomposition)
from .problems.generic_admm import GenericADMMProblem
from .problems.multiframeproblem import MultiFrameProblem
from .problems.schedulerproblem import SchedulerProblem
from .problems.gcodeproblem import GCodeProblem, GCodeSchedulerProblem
from .problems.globalplanner import AStarPlanner, Grid
from .environment.frame import Frame, ShiftFrame, CorridorFrame
from .execution.simulator import Simulator, Deployer
from .execution.plotlayer import PlotLayer
from .gui.gcode_reader import GCodeReader
from .gui.gcode_block import GCodeBlock
from .gui.svg_reader import SVGReader
from .gui.gui import EnvironmentGUI
from .ops.alm import ALMOptions, ALMState
from .ops.solver import IPOptions, IPState, make_ip_solver
from .export.export_p2p import ExportP2P
from .export.export_formation import ExportFormation, ExportADMM
from .export.export_rendezvous import ExportRendezVous

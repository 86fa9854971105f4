"""The torch port stands alone: it imports neither JAX nor the JAX package,
and its entry points run on CUDA unless the caller asks for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import omg_tools_torch as T
from omg_tools_torch.interop import batch_from_numpy, state_from_numpy
from omg_tools_torch.problems.batch import resolve_device

pytestmark = pytest.mark.fast

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "omg_tools_torch"
BANNED = ("jax", "jaxlib", "omg_tools_tpu")
# the port's other programs: the example copies (in subdirectories too)
# and the card's smoke run
PROGRAMS = sorted((ROOT / "examples_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]

# runs in a fresh interpreter: any import of a banned package raises
_CHILD = r"""
import importlib.abc, sys
BANNED = %r
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("omg_tools_torch imported " + name)
sys.meta_path.insert(0, Block())
import omg_tools_torch as T
vehicle = T.Holonomic()
vehicle.set_initial_conditions([-1.5, -1.5])
vehicle.set_terminal_conditions([2.0, 2.0])
env = T.Environment(room={"shape": T.Square(5.0)})
env.add_obstacle(T.Obstacle({"position": [-2.1, -0.5]},
                            shape=T.Rectangle(width=3.0, height=0.2)))
env.add_obstacle(T.Obstacle({"position": [1.5, 0.5]}, shape=T.Circle(0.4)))
problem = T.Point2point(vehicle, env, freeT=False)
problem.set_options({"verbose": 0})
problem.init()
assert problem.transcription.n_x > 0
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not loaded, loaded
print("OK")
"""


def test_subprocess_builds_bench_problem_without_jax():
    out = subprocess.run([sys.executable, "-c", _CHILD % (BANNED,)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("OK")


# bench.py's other scenes and every ported vehicle, in a fresh interpreter
_CHILD_VEHICLES = r"""
import importlib.abc, sys
BANNED = %r
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("omg_tools_torch imported " + name)
sys.meta_path.insert(0, Block())
import omg_tools_torch as T
sys.path.insert(0, ".")
import chip_smoke
for config in ("p2p_3dquadrotor", "p2p_dubins"):
    assert chip_smoke.build_problem(T, config).transcription.n_x > 0
for cls in (T.Holonomic1D, T.Holonomic3D, T.HolonomicOrient, T.Quadrotor,
            T.Quadrotor3D, T.SimpleQuadrotor3D, T.Dubins):
    assert cls().n_spl > 0
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not loaded, loaded
print("OK")
"""


# bench.py's formation_holonomic: the fleet, the consensus-ADMM template
# and one FleetRunner iteration, in a fresh interpreter
_CHILD_FLEET = r"""
import importlib.abc, sys
BANNED = %r
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("omg_tools_torch imported " + name)
sys.meta_path.insert(0, Block())
import numpy as np
import torch
import omg_tools_torch as T
from omg_tools_torch.environment.shapes import RegularPolyhedron
from omg_tools_torch.parallel import FleetRunner
vehicles = [T.Holonomic() for _ in range(4)]
fleet = T.Fleet(vehicles)
conf = RegularPolyhedron(0.2, 4, np.pi / 4).vertices.T
fleet.set_configuration(conf.tolist())
fleet.set_initial_conditions((np.array([-1.5, -1.5]) + conf).tolist())
fleet.set_terminal_conditions((np.array([2.0, 2.0]) + conf).tolist())
env = T.Environment(room={"shape": T.Square(5.0)})
env.add_obstacle(T.Obstacle({"position": [1.5, 0.5]}, shape=T.Circle(0.4)))
problem = T.FormationPoint2point(fleet, env, options={
    "horizon_time": 10, "verbose": 0, "rho": 0.5, "device": "cpu",
    "solver_options": {"outer_iter": 1, "inner_iter": 1}})
problem.init()
runner = FleetRunner(problem, dtype=torch.float64, device="cpu",
                     outer_iter=1)
carry, (pri, dua) = runner.iterate_fn(1)(runner.make_state(0.0))
assert pri.shape == (1,) and bool(torch.isfinite(pri).all())
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not loaded, loaded
print("OK")
"""


def test_subprocess_runs_the_formation_without_jax():
    out = subprocess.run([sys.executable, "-c", _CHILD_FLEET % (BANNED,)],
                         cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "OMP_NUM_THREADS": "1"},
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("OK")


# the mesh path: its modules and the launcher import, and one rank of gloo
# runs a mesh iteration of the formation, in a fresh interpreter
_CHILD_MESH = r"""
import importlib.abc, sys
BANNED = %r
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("omg_tools_torch imported " + name)
sys.meta_path.insert(0, Block())
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
import omg_tools_torch as T
from omg_tools_torch.parallel import fleet_mesh, multihost
from omg_tools_torch.parallel import FleetRunner
from omg_tools_torch.tools import multihost_launch
from omg_tools_torch.environment.shapes import RegularPolyhedron
vehicles = [T.Holonomic() for _ in range(4)]
fleet = T.Fleet(vehicles)
conf = RegularPolyhedron(0.2, 4, np.pi / 4).vertices.T
fleet.set_configuration(conf.tolist())
fleet.set_initial_conditions((np.array([-1.5, -1.5]) + conf).tolist())
fleet.set_terminal_conditions((np.array([2.0, 2.0]) + conf).tolist())
env = T.Environment(room={"shape": T.Square(5.0)})
env.add_obstacle(T.Obstacle({"position": [1.5, 0.5]}, shape=T.Circle(0.4)))
problem = T.FormationPoint2point(fleet, env, options={
    "horizon_time": 10, "verbose": 0, "rho": 0.5, "device": "cpu",
    "solver_options": {"outer_iter": 2, "inner_iter": 4}})
problem.init()
assert fleet_mesh.one_rank_group("cpu")
mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("fleet",))
runner = FleetRunner(problem, dtype=torch.float64, device="cpu", mesh=mesh)
g = problem.groups[0]
(X, Z, L), (pri, dua) = runner.mesh_iterate_fn(1)(
    g.X, problem._pack_params(g, 0.0), problem.Z, problem.L)
assert X.shape == g.X.shape and bool(torch.isfinite(pri).all())
assert fleet_mesh.collectives["all_reduce"] == 1
dist.destroy_process_group()
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not loaded, loaded
print("OK")
"""


def test_subprocess_runs_a_mesh_iteration_without_jax():
    out = subprocess.run([sys.executable, "-c", _CHILD_MESH % (BANNED,)],
                         cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "OMP_NUM_THREADS": "1"},
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("OK")


def test_subprocess_builds_other_bench_problems_without_jax():
    out = subprocess.run([sys.executable, "-c",
                          _CHILD_VEHICLES % (BANNED,)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("OK")


# phase 16's scenes (free time, a rotating obstacle, a spline trajectory),
# the AGV, the Trailer and a free end point, built as on the card's machine
_CHILD_SCENES = r"""
import importlib.abc, sys
BANNED = %r
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("omg_tools_torch imported " + name)
sys.meta_path.insert(0, Block())
import numpy as np
import omg_tools_torch as T
import chip_smoke
problems = [chip_smoke.build_scene(T, s, {"device": "cpu"}) for s in
            ("p2p_dubins", "p2p_bicycle", "revolving_door", "obstraj")]
agv = T.AGV()
agv.set_initial_conditions([0.0, 0.0, 0.0, 0.0])
agv.set_terminal_conditions([3.0, 3.0, 0.0])
lead = T.Dubins(T.Circle(0.2))
lead.set_initial_conditions([0.0, 0.0, 0.0])
lead.set_terminal_conditions([2.5, 2.5, 0.0])
trailer = T.Trailer(lead_veh=lead, l_hitch=0.4)
trailer.set_initial_conditions([0.0])
trailer.set_terminal_conditions([0.0])
for veh in (agv, trailer):
    veh.define_knots(knot_intervals=5)
    env = T.Environment(room={"shape": T.Square(5.0)})
    problems.append(T.Point2point(veh, env, {"device": "cpu"}, freeT=True))
veh = T.Holonomic()
veh.set_initial_conditions([-1.5, -1.5])
veh.set_terminal_conditions([2.0, 2.0])
problems.append(T.FreeEndPoint2point(
    veh, T.Environment(room={"shape": T.Square(5.0)}), {"device": "cpu"}))
for problem in problems:
    problem.set_options({"verbose": 0})
    problem.init()
    assert problem.transcription.n_x > 0
assert [type(p).__name__ for p in problems] == (
    ["FreeTPoint2point"] * 2 + ["FixedTPoint2point"] * 2
    + ["FreeTPoint2point"] * 2 + ["FreeEndPoint2point"])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not loaded, loaded
print("OK")
"""


def test_subprocess_builds_the_new_scenes_without_jax():
    out = subprocess.run([sys.executable, "-c", _CHILD_SCENES % (BANNED,)],
                         cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "OMP_NUM_THREADS": "1"},
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("OK")


# the vast-environment planner (frames, A*, the multi-frame and scheduler
# problems, the GUI's headless data model) as on the card's machine: JAX
# and tkinter are not imported
_CHILD_VAST = r"""
import importlib.abc, sys
BANNED = %r
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("omg_tools_torch imported " + name)
sys.meta_path.insert(0, Block())
import omg_tools_torch as T
import chip_smoke
for scene in chip_smoke.VAST_SCENES:
    problem = chip_smoke.build_scene(T, scene, {"device": "cpu"})
    problem.init()
    local = getattr(problem, "local_problem", problem)
    assert local.transcription.n_x > 0
gui = T.EnvironmentGUI(width=8.0, height=8.0, display=False)
gui.on_click((100, 100), "circle")
env = gui.build_environment()
assert len(env.obstacles) == 1
planner = T.AStarPlanner(env, [16, 16], [-3.0, -3.0], [3.0, 3.0])
assert len(planner.get_path()) > 2
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not loaded, loaded
print("OK")
"""


def test_subprocess_builds_the_vast_scenes_without_jax_or_tkinter():
    banned = BANNED + ("tkinter",)
    out = subprocess.run([sys.executable, "-c", _CHILD_VAST % (banned,)],
                         cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "OMP_NUM_THREADS": "1",
                              "DISPLAY": ""},
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("OK")


# G-code machining (the reader, the Tool, the rolling window over each of
# the nine part programs, phase 18's two G-code scenes built), the SVG
# import and the central formation, as on the card's machine: JAX and
# tkinter are not imported
_CHILD_GCODE = r"""
import glob, importlib.abc, os, sys
BANNED = %r
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("omg_tools_torch imported " + name)
sys.meta_path.insert(0, Block())
import omg_tools_torch as T
from omg_tools_torch.gui import G00, G01, G02, G03
import chip_smoke
for path in sorted(glob.glob("examples/GCode_examples/*.nc")):
    reader = T.GCodeReader()
    reader.load_file(path)
    blocks = reader.parse()
    assert all(isinstance(b, (G00, G01, G02, G03)) for b in blocks)
    tool = T.Tool(tolerance=0.3)
    tool.define_knots(knot_intervals=5)
    tool.set_initial_conditions(blocks[0].start)
    problem = T.GCodeSchedulerProblem(tool, blocks, n_segments=2)
    assert len(problem.segments_all) >= len(blocks)
for scene, n_x in (("gcode_slot_multi", 50), ("gcode_rsq5", 50),
                   ("formation_central", 203)):
    problem = chip_smoke.build_scene(T, scene, {"device": "cpu"})
    problem.init()
    local = getattr(problem, "local_problem", problem)
    assert local.transcription.n_x == n_x, (scene, local.transcription.n_x)
gui = T.EnvironmentGUI(display=False)
gui.load_svg("examples/gui_examples/svg/maze_gen.svg", world_width=20.0)
assert len(gui.get_environment().obstacles) == 6
reader = T.SVGReader()
reader.init("examples/gui_examples/svg/maze_gen.svg")
assert reader.build_environment()["obstacles"]
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not loaded, loaded
print("OK")
"""


def test_subprocess_builds_gcode_svg_and_central_formation_without_jax():
    banned = BANNED + ("tkinter",)
    out = subprocess.run([sys.executable, "-c", _CHILD_GCODE % (banned,)],
                         cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "OMP_NUM_THREADS": "1",
                              "DISPLAY": ""},
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("OK")


# the export path as on the card's machine: ExportP2P of a small scene
# written (host float64, no card), and the five example copies of the
# batched runner and the exports imported (their work is in ``main()``)
_CHILD_EXPORT = r"""
import importlib.abc, importlib.util, json, os, sys, tempfile
BANNED = %r
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("omg_tools_torch imported " + name)
sys.meta_path.insert(0, Block())
import omg_tools_torch as T
vehicle = T.Holonomic()
vehicle.set_initial_conditions([-1.5, -1.5])
vehicle.set_terminal_conditions([2.0, 2.0])
problem = T.Point2point(vehicle, T.Environment(room={"shape": T.Square(5.0)}),
                        freeT=False)
problem.set_options({"verbose": 0})
problem.init()
with tempfile.TemporaryDirectory() as out:
    problem.export({"directory": out}).run()
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["scalars"]["n_x"] == problem.transcription.n_x
    assert os.path.exists(os.path.join(out, "Makefile"))
for name in ("batched_p2p_tpu", "p2p_holonomic_export",
             "p2p_holonomic_obstraj_export", "formation_holonomic_export",
             "rendezvous_holonomic_export"):
    spec = importlib.util.spec_from_file_location(
        "example_" + name, os.path.join("examples_torch", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert callable(module.main)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not loaded, loaded
print("OK")
"""


def test_subprocess_exports_without_jax():
    out = subprocess.run([sys.executable, "-c", _CHILD_EXPORT % (BANNED,)],
                         cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "OMP_NUM_THREADS": "1"},
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("OK")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_no_jax_import_in_source(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", PROGRAMS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_the_port_programs(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path} imports {bad}"


# the closed loop as on the card's machine, which has neither JAX nor
# matplotlib: any import of those raises
_CLOSED_LOOP = r"""
import importlib.abc, sys
BANNED = %r
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("the closed loop imported " + name)
sys.meta_path.insert(0, Block())
import omg_tools_torch as T
from omg_tools_torch.tools.parity import build_p2p_holonomic
problem = build_p2p_holonomic(
    solver_options={"outer_iter": 1, "inner_iter": 2},
    options={"device": "cpu"})
simulator = T.Simulator(problem)
for _ in range(2):
    simulator.update()
assert problem.vehicles[0].signals["state"].shape == (2, 21)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not loaded, loaded
print("OK")
"""


def test_closed_loop_runs_without_matplotlib_or_jax():
    banned = BANNED + ("matplotlib",)
    out = subprocess.run([sys.executable, "-c", _CLOSED_LOOP % (banned,)],
                         cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "OMP_NUM_THREADS": "1"},
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("OK")


def test_default_device_needs_cuda(monkeypatch):
    """device=None means CUDA: without a card the runner raises before any
    work instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.BatchedP2PRunner(problem=None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_interop_default_device_needs_cuda(monkeypatch):
    """The interop constructors follow the same rule as the runner."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((2, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_from_numpy(x, x, x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_numpy({"x": x})
    x0, _, _ = batch_from_numpy(x, x, x, device="cpu")
    assert x0.device == torch.device("cpu")
    st = state_from_numpy({"x": x, "n_iter": np.zeros(2)}, device="cpu")
    assert st.x.device == torch.device("cpu")
    assert st.n_iter.dtype == torch.int32

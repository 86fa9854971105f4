"""The vast-environment planner's host modules of the port held to the JAX
package (numpy in both, so equal exactly or to 1e-12): the frames
(``environment/frame.py``: Frame, ShiftFrame, CorridorFrame,
create_l_shape), the A* global planner (``problems/globalplanner.py``) and
the environment editor's headless data model (``gui/gui.py``, with its SVG
import).

Scenes: tests/test_schedulers.py's environments, the schedulers of
examples/schedulerproblem_example1.py, _example2.py and _dubins.py
(``chip_smoke.build_vast_scene``), and the maze and halls of
examples/gui_examples/_environments.py.  The JAX package is imported
inside fixtures.
"""

import os
import sys

import numpy as np
import pytest

import omg_tools_torch as T
from omg_tools_torch.environment.frame import create_l_shape
import chip_smoke

pytestmark = pytest.mark.fast

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12


@pytest.fixture(scope="module")
def J():
    """The JAX package (float64)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    return pytest.importorskip("omg_tools_tpu")


@pytest.fixture(scope="module")
def gui_scenes(J):
    """examples/gui_examples/_environments.py (it builds through the JAX
    package's EnvironmentGUI)."""
    sys.path.insert(0, os.path.join(ROOT, "examples", "gui_examples"))
    try:
        import _environments
    finally:
        sys.path.pop(0)
    return _environments


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(1.0, np.abs(want).max()))


def _wall_env(m):
    env = m.Environment(room={"shape": m.Square(10.0)})
    env.add_obstacle(m.Obstacle({"position": [0.0, 0.0]},
                                shape=m.Rectangle(width=0.5, height=6.0)))
    return env


def _scheduler_env(m, scene):
    """A scheduler scene's environment, start and goal."""
    problem = chip_smoke.build_vast_scene(m, scene)
    vehicle = problem.vehicles[0]
    return (problem.environment, np.asarray(vehicle.prediction["state"][:2],
                                            np.float64),
            np.asarray(vehicle.poseT[:2], np.float64))


def _members(frame, env):
    """Indices in the environment of a frame's in-frame obstacles."""
    return ([env.obstacles.index(o) for o in frame.stationary_obstacles],
            [env.obstacles.index(o) for o in frame.moving_obstacles])


def _same_frames(tf, jf, tenv, jenv):
    assert len(tf) == len(jf)
    for a, b in zip(tf, jf):
        assert type(a).__name__ == type(b).__name__
        _close(a.border, b.border)
        _close(a.goal, b.goal)
        _close(a.start, b.start)
        assert _members(a, tenv) == _members(b, jenv)


@pytest.mark.parametrize("scene", ["scheduler1", "scheduler2",
                                   "scheduler_dubins"])
def test_astar_and_frames_match_jax(J, scene):
    """The A* path, then ShiftFrame / CorridorFrame / create_l_shape from
    it, filled with the (moving) obstacles over a 10 s horizon and made
    reachable: borders, goals, starts and member obstacles."""
    (tenv, start, goal), (jenv, _, _) = (_scheduler_env(m, scene)
                                         for m in (T, J))
    paths = [m.AStarPlanner(env, [20, 20], start, goal, vehicle_size=0.2)
             .get_path() for m, env in ((T, tenv), (J, jenv))]
    assert len(paths[0]) == len(paths[1]) > 2
    _close(paths[0], paths[1])
    frames = []
    for m, env, path in ((T, tenv, paths[0]), (J, jenv, paths[1])):
        if scene == "scheduler1":
            fr = [m.ShiftFrame(env, start, goal, 4.0, global_path=path)]
        else:
            mod = sys.modules[m.CorridorFrame.__module__]
            fr = [m.CorridorFrame(env, start, goal, global_path=path)] \
                + mod.create_l_shape(env, start, goal, path)
        for f in fr:
            f.fill_obstacles(horizon_time=10.0)
            f.fix_endpoint_reachability(0.2)
        frames.append(fr)
    _same_frames(frames[0], frames[1], tenv, jenv)
    for a, b in zip(*frames):
        assert a.overlap_with(frames[0][0]) == b.overlap_with(frames[1][0])
        assert a.moving_ids() == {id(o) for o in a.moving_obstacles}
        assert a.point_in_frame(goal) == b.point_in_frame(goal)
        _close(a.center, b.center)


def test_astar_avoids_the_wall_like_jax(J):
    """tests/test_schedulers.py's wall: the same waypoints, and (as the
    JAX test asks) none of them on the wall."""
    paths = [m.AStarPlanner(_wall_env(m), [25, 25], [-4.0, 0.0], [4.0, 0.0],
                            vehicle_size=0.2).get_path([-4.0, 0.0],
                                                       [4.0, 0.0])
             for m in (T, J)]
    _close(paths[0], paths[1])
    path = np.asarray(paths[0])
    assert not ((np.abs(path[:, 0]) < 0.25)
                & (np.abs(path[:, 1]) < 3.0)).any()
    grid_t = T.AStarPlanner(_wall_env(T), [25, 25], [-4, 0], [4, 0],
                            vehicle_size=0.2).grid
    grid_j = J.AStarPlanner(_wall_env(J), [25, 25], [-4, 0], [4, 0],
                            vehicle_size=0.2).grid
    np.testing.assert_array_equal(grid_t.occupied, grid_j.occupied)
    assert grid_t.move_to_free((12, 12)) == grid_j.move_to_free((12, 12))


@pytest.mark.parametrize("builder", ["example1_gui", "example2_gui",
                                     "maze_gui"])
def test_gui_environments_and_astar_match_jax(J, gui_scenes, builder,
                                              tmp_path):
    """The GUI examples' scenes: the JAX package's EnvironmentGUI pickles
    its description, the port's loads it; both build the same environment
    (rooms, shapes, positions) and the same clicked positions; A* through
    each maze gives the same waypoints, and the port's own pickle loads
    back in the JAX package."""
    kwargs = {"scale": 0.4, "n_walls": 3} if builder == "maze_gui" else {}
    jgui = getattr(gui_scenes, builder)(**kwargs)
    path = tmp_path / "env.pickle"
    jgui.save_environment(str(path))
    tgui = T.EnvironmentGUI(display=False)
    tgui.load_environment(str(path))
    tgui.clicked_positions = list(jgui.clicked_positions)
    assert tgui.obstacles == jgui.obstacles
    for margin in (None, 0.2):
        assert tgui.get_clicked_positions(margin) == \
            jgui.get_clicked_positions(margin)
    envs = [g.get_environment() for g in (tgui, jgui)]
    for a, b in zip(envs[0].room, envs[1].room):
        _close(a["position"], b["position"])
        _close(a["shape"].get_canvas_limits(), b["shape"].get_canvas_limits())
    assert len(envs[0].obstacles) == len(envs[1].obstacles)
    for a, b in zip(envs[0].obstacles, envs[1].obstacles):
        assert type(a.shape).__name__ == type(b.shape).__name__
        _close(a.shape.get_checkpoints()[0], b.shape.get_checkpoints()[0])
        for key in ("position", "velocity"):
            _close(a.signals[key], b.signals[key])
        assert a.options["bounce"] == b.options["bounce"]
    start, goal = jgui.get_clicked_positions(margin=0.2)
    paths = [m.AStarPlanner(env, [30, 30], start, goal, vehicle_size=0.2)
             .get_path() for m, env in ((T, envs[0]), (J, envs[1]))]
    _close(paths[0], paths[1])
    # and back: the port's pickle in the JAX package
    tgui.save_environment(str(path))
    back = J.EnvironmentGUI(display=False)
    back.load_environment(str(path))
    assert back.obstacles == tgui.obstacles


def test_gui_clicks_and_transforms_match_jax(J):
    """Clicks placed through the pixel transforms and the snap-to-grid,
    then an SVG import, give the same obstacles and clicked positions in
    both packages."""
    guis = [m.EnvironmentGUI(width=6.0, height=4.0, position=[1.0, -0.5],
                             options={"cell_size": 0.5}, display=False)
            for m in (T, J)]
    for gui in guis:
        gui.on_click((40, 60), "rectangle", velocity=[0.1, 0.0])
        gui.on_click((212, 33), "circle", bounce=True)
        gui.move_obstacle(0, [0.5, 0.5])
        gui.on_click((150, 150), "rectangle", width=1.0, height=0.25)
        gui.remove_obstacle(1)
    assert guis[0].obstacles == guis[1].obstacles
    assert guis[0].clicked_positions == guis[1].clicked_positions
    for px in ((0, 0), (123, 77)):
        assert guis[0].pixel_to_world(px) == guis[1].pixel_to_world(px)
        w = guis[0].pixel_to_world(px)
        assert guis[0].world_to_pixel(w) == guis[1].world_to_pixel(w)
    # the SVG import: examples/gui_examples/svg/maze_gen.svg, placed at
    # each editor's room, gives the same obstacles in both packages
    svg = os.path.join(ROOT, "examples", "gui_examples", "svg",
                       "maze_gen.svg")
    for gui in guis:
        gui.load_svg(svg, world_width=20.0)
    assert len(guis[0].obstacles) == 2 + 6
    assert guis[0].obstacles == guis[1].obstacles
    assert (guis[0].position, guis[0].width, guis[0].height) == \
        (guis[1].position, guis[1].width, guis[1].height)


def test_l_shape_is_one_frame_when_the_goal_is_in_view(J):
    """create_l_shape returns one corridor when the first holds the goal
    (an open room), in both packages."""
    out = []
    for m in (T, J):
        env = m.Environment(room={"shape": m.Square(10.0)})
        path = [np.array([-4.0, -4.0]), np.array([0.0, 0.0]),
                np.array([4.0, 4.0])]
        mod = sys.modules[m.CorridorFrame.__module__]
        out.append(mod.create_l_shape(env, path[0], path[-1], path))
    assert len(out[0]) == len(out[1]) == 1
    _close(out[0][0].border, out[1][0].border)
    assert create_l_shape is sys.modules[
        T.CorridorFrame.__module__].create_l_shape

"""The port's SVG reader (``gui/svg_reader.py``) and ``EnvironmentGUI``'s
SVG import held to the JAX package (numpy and ``xml.etree`` in both, so
equal exactly): tests/test_gui_tools.py's inline SVG (a rect, a circle, a
line and a closed straight path, with more elements) and
examples/gui_examples/svg/maze_gen.svg (four path walls, two circles),
read where it lies.  The JAX package is
imported inside a fixture.
"""

import os

import numpy as np
import pytest

import omg_tools_torch as T

pytestmark = pytest.mark.fast

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAZE = os.path.join(ROOT, "examples", "gui_examples", "svg", "maze_gen.svg")

# tests/test_gui_tools.py's inline SVG, with an ellipse, a polyline and a
# polygon (G-code outlines), a circle drawn by cubic Beziers and a path of
# relative and H/V commands besides
SVG = """<?xml version="1.0"?>
<svg xmlns="http://www.w3.org/2000/svg" width="100" height="80">
  <rect x="10" y="10" width="20" height="10"/>
  <circle cx="60" cy="40" r="5"/>
  <ellipse cx="20" cy="60" rx="6" ry="3"/>
  <line x1="0" y1="0" x2="50" y2="40"/>
  <polyline points="5,5 15,5 15,25"/>
  <polygon points="30,30 40,30 35,38"/>
  <path d="M 70 60 L 90 60 L 90 70 L 70 70 Z"/>
  <path d="M 80 20 C 80 25.5 75.5 30 70 30 C 64.5 30 60 25.5 60 20
           C 60 14.5 64.5 10 70 10 C 75.5 10 80 14.5 80 20 z"/>
  <path d="m 40 70 h 10 v 5 h -10 z"/>
</svg>
"""


@pytest.fixture(scope="module")
def J():
    """The JAX package (its SVG reader is numpy)."""
    return pytest.importorskip("omg_tools_tpu")


@pytest.fixture(scope="module")
def inline_svg(tmp_path_factory):
    path = tmp_path_factory.mktemp("svg") / "env.svg"
    path.write_text(SVG)
    return str(path)


def _readers(J, path, world=None):
    out = []
    for m in (T, J):
        reader = m.SVGReader()
        reader.init(path)
        if world is not None:
            reader.set_world_size(*world)
        out.append(reader)
    return out


@pytest.mark.parametrize("svg,world", [
    ("inline", (10.0, 8.0)), ("inline", None),
    ("maze", (20.0, 12.0, (1.0, -2.0)))])
def test_environment_description_matches_jax(J, inline_svg, svg, world):
    """The canvas geometry and ``build_environment``'s description:
    the room, every obstacle's shape, size and world position."""
    path = inline_svg if svg == "inline" else MAZE
    tr, jr = _readers(J, path, world)
    assert (tr.width_px, tr.height_px, tr.meter_to_pixel) == \
        (jr.width_px, jr.height_px, jr.meter_to_pixel)
    td, jd = tr.build_environment(), jr.build_environment()
    assert td == jd
    assert len(td["obstacles"]) == 6


def test_inline_svg_shapes(inline_svg):
    """tests/test_gui_tools.py's checks on the port alone: the circle at
    pixel (60, 40), r 5 lands at world (6, 4), r 0.5; the straight path's
    box is 2 x 1 m; the Bezier path's control points are not all on its
    circle (their radii spread > 5 %): a 2 x 2 m box."""
    reader = T.SVGReader()
    reader.init(inline_svg)
    reader.set_world_size(10.0, 8.0)
    desc = reader.build_environment()
    assert desc["width"] == pytest.approx(10.0)
    circles = [o for o in desc["obstacles"] if o["shape"] == "circle"]
    assert len(circles) == 1
    assert circles[0]["pos"] == pytest.approx([6.0, 4.0])
    assert circles[0]["radius"] == pytest.approx(0.5)
    rects = {tuple(np.round(o["pos"], 9)): (o["width"], o["height"])
             for o in desc["obstacles"] if o["shape"] == "rectangle"}
    assert rects[(8.0, 1.5)] == pytest.approx((2.0, 1.0))
    assert rects[(7.0, 6.0)] == pytest.approx((2.0, 2.0))


@pytest.mark.parametrize("svg", ["inline", "maze"])
def test_paths_and_lines_match_jax(J, inline_svg, svg):
    """The path tokenizer's absolute point lists (relative commands, H/V,
    cubic Beziers, closing), the line segments (<line>, <polyline>,
    <polygon>) and the G-code outline commands."""
    path = inline_svg if svg == "inline" else MAZE
    tr, jr = _readers(J, path, (10.0, 8.0))
    tp, jp = tr.convert_path_to_points(), jr.convert_path_to_points()
    assert len(tp) == len(jp) > 0
    for (a, ca), (b, cb) in zip(tp, jp):
        assert ca == cb
        np.testing.assert_array_equal(a, b)
    assert tr.convert_lines() == jr.convert_lines()
    tr.lines, jr.lines = [], []
    assert tr.get_gcode_description() == jr.get_gcode_description()


def test_gcode_description_reads_back_as_blocks(J, inline_svg):
    """SVGReader.get_gcode_description's commands parse into the same
    G-code blocks in both packages' readers (the SVG-to-machining path)."""
    tr, jr = _readers(J, inline_svg, (10.0, 8.0))
    blocks = [m.GCodeReader().parse(r.get_gcode_description())
              for m, r in ((T, tr), (J, jr))]
    # a rapid to the first line's start, then one G01 a segment: the
    # line, the polyline's two and the polygon's three
    assert len(blocks[0]) == len(blocks[1]) == 1 + 6
    for a, b in zip(*blocks):
        assert (a.type, a.start, a.end) == (b.type, b.start, b.end)


@pytest.mark.parametrize("world_width", [None, 20.0])
def test_load_svg_gives_the_same_obstacles(J, world_width):
    """``EnvironmentGUI.load_svg`` of maze_gen.svg: the same obstacle
    descriptions and room in both packages, and the same Environment
    (tests/test_gui_tools.py::test_svg_maze_pipeline's geometry)."""
    guis = []
    for m in (T, J):
        gui = m.EnvironmentGUI(display=False)
        gui.load_svg(MAZE, world_width=world_width)
        guis.append(gui)
    assert guis[0].obstacles == guis[1].obstacles
    assert (guis[0].position, guis[0].width, guis[0].height) == \
        (guis[1].position, guis[1].width, guis[1].height)
    walls = [o for o in guis[0].obstacles if o["shape"] == "rectangle"]
    discs = [o for o in guis[0].obstacles if o["shape"] == "circle"]
    assert len(walls) == 4 and len(discs) == 2
    if world_width is not None:
        w0 = min(walls, key=lambda o: o["pos"][0])
        assert (w0["width"], w0["height"], w0["pos"][0]) == \
            pytest.approx((0.6, 9.0, 4.0))
    envs = [g.get_environment() for g in guis]
    assert len(envs[0].obstacles) == len(envs[1].obstacles) == 6
    for a, b in zip(envs[0].obstacles, envs[1].obstacles):
        assert type(a.shape).__name__ == type(b.shape).__name__
        np.testing.assert_array_equal(a.signals["position"],
                                      b.signals["position"])

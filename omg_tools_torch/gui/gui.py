"""Environment editor GUI (a copy of ``omg_tools_tpu.gui.gui``, after
omgtools' Tkinter editor, gui/gui.py:22-626): click-to-place rectangle and
circle obstacles with optional velocities and bounce flags, snap-to-grid,
pixel<->world transforms, pickle save/load of environments, SVG import
(``load_svg``, through ``svg_reader.SVGReader``), and
``build_environment()`` producing a real :class:`Environment`.

The data model (obstacle list, transforms, persistence, environment
construction) is usable headless: the Tk canvas is attached only when a
display is available (``display=True``), and ``tkinter`` is imported only
then.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

__all__ = ["EnvironmentGUI"]


class EnvironmentGUI:

    def __init__(self, parent=None, width=8.0, height=8.0, position=(0, 0),
                 options=None, display=None, **kwargs):
        self.width = float(width)
        self.height = float(height)
        self.position = list(position)
        self.options = {"cell_size": 0.5, "meter_to_pixel": 50}
        self.options.update(options or {})
        self.obstacles = []
        self.clicked_positions = []
        self.canvas = None
        self.root = None
        if display is None:
            display = bool(os.environ.get("DISPLAY")) and parent is not False
        if display:
            self._init_tk(parent)

    # -- Tk front-end (optional) ---------------------------------------------
    def _init_tk(self, parent):  # pragma: no cover - needs a display
        import tkinter as tk
        self.root = parent or tk.Tk()
        self.root.title("omg_tools_torch environment editor")
        m2p = self.options["meter_to_pixel"]
        self.canvas = tk.Canvas(self.root, width=self.width * m2p,
                                height=self.height * m2p, bg="white")
        self.canvas.pack()
        self.canvas.bind("<Button-1>",
                         lambda e: self.on_click((e.x, e.y), "rectangle"))
        self.canvas.bind("<Button-3>",
                         lambda e: self.on_click((e.x, e.y), "circle"))
        self.draw_grid()

    def draw_grid(self):  # pragma: no cover - needs a display
        m2p = self.options["meter_to_pixel"]
        step = int(self.options["cell_size"] * m2p)
        for x in range(0, int(self.width * m2p) + 1, step):
            self.canvas.create_line(x, 0, x, self.height * m2p, fill="#eee")
        for y in range(0, int(self.height * m2p) + 1, step):
            self.canvas.create_line(0, y, self.width * m2p, y, fill="#eee")

    def on_click(self, pixel, shape="rectangle", **props):
        """Place an obstacle at a clicked pixel (omgtools gui.py:209-283)."""
        world = self.snap_to_grid(self.pixel_to_world(pixel))
        obstacle = {"shape": shape, "pos": list(world),
                    "velocity": props.get("velocity", [0.0, 0.0]),
                    "bounce": props.get("bounce", False)}
        if shape == "rectangle":
            obstacle["width"] = props.get("width", self.options["cell_size"])
            obstacle["height"] = props.get("height",
                                           self.options["cell_size"])
        else:
            obstacle["radius"] = props.get("radius",
                                           0.5 * self.options["cell_size"])
        self.add_obstacle(obstacle)
        self.clicked_positions.append(list(world))
        return obstacle

    # -- data model ------------------------------------------------------------
    def add_obstacle(self, obstacle):
        self.obstacles.append(dict(obstacle))
        self._draw_obstacle(self.obstacles[-1])

    def remove_obstacle(self, index=-1):
        if self.obstacles:
            self.obstacles.pop(index)

    def move_obstacle(self, index, new_pos):
        self.obstacles[index]["pos"] = list(new_pos)

    def _draw_obstacle(self, obs):  # pragma: no cover - needs a display
        if self.canvas is None:
            return
        px = self.world_to_pixel(obs["pos"])
        m2p = self.options["meter_to_pixel"]
        if obs["shape"] == "circle":
            r = obs["radius"] * m2p
            self.canvas.create_oval(px[0] - r, px[1] - r, px[0] + r,
                                    px[1] + r, outline="black")
        else:
            w, h = 0.5 * obs["width"] * m2p, 0.5 * obs["height"] * m2p
            self.canvas.create_rectangle(px[0] - w, px[1] - h, px[0] + w,
                                         px[1] + h, outline="black")

    def snap_to_grid(self, point):
        """Snap a world point to the cell grid (omgtools gui.py:353-359)."""
        cell = self.options["cell_size"]
        return [round((p - o) / cell) * cell + o
                for p, o in zip(point, self.position)]

    def pixel_to_world(self, pixel):
        """Canvas pixels -> world meters, y-flip (omgtools gui.py:596-611)."""
        m2p = self.options["meter_to_pixel"]
        return [self.position[0] + pixel[0] / m2p - 0.5 * self.width,
                self.position[1] + 0.5 * self.height - pixel[1] / m2p]

    def world_to_pixel(self, world):
        """Inverse of pixel_to_world (omgtools gui.py:613-626)."""
        m2p = self.options["meter_to_pixel"]
        return [(world[0] - self.position[0] + 0.5 * self.width) * m2p,
                (0.5 * self.height - world[1] + self.position[1]) * m2p]

    def get_clicked_positions(self, margin=None):
        if margin is None:
            return list(self.clicked_positions)
        lim_x = 0.5 * self.width - margin
        lim_y = 0.5 * self.height - margin
        return [p for p in self.clicked_positions
                if abs(p[0] - self.position[0]) <= lim_x
                and abs(p[1] - self.position[1]) <= lim_y]

    # -- persistence -------------------------------------------------------------
    def save_environment(self, filename):
        """Pickle the environment description (omgtools gui.py:428-440)."""
        description = {"position": list(self.position), "width": self.width,
                       "height": self.height,
                       "obstacles": [dict(o) for o in self.obstacles]}
        with open(filename, "wb") as fh:
            pickle.dump(description, fh)
        return description

    def load_environment(self, filename):
        """Load a pickled description (omgtools gui.py:440-476)."""
        with open(filename, "rb") as fh:
            description = pickle.load(fh)
        self.apply_description(description)
        return description

    def load_svg(self, filename, world_width=None):
        """Import an SVG file as obstacles (omgtools gui.py:478-565)."""
        from .svg_reader import SVGReader
        reader = SVGReader()
        reader.init(filename)
        if world_width is not None:
            reader.set_world_size(world_width,
                                  world_width * reader.height_px
                                  / reader.width_px,
                                  position=self.position)
        self.apply_description(reader.build_environment())

    def apply_description(self, description):
        self.position = list(description.get("position", self.position))
        self.width = float(description.get("width", self.width))
        self.height = float(description.get("height", self.height))
        for obs in description.get("obstacles", []):
            self.add_obstacle(obs)

    # -- environment construction ---------------------------------------------
    def build_environment(self):
        """Construct the modeling :class:`Environment`
        (omgtools gui.py:374-427)."""
        from ..environment.environment import Environment
        from ..environment.obstacle import Obstacle
        from ..environment.shapes import Circle, Rectangle

        environment = Environment(room={
            "shape": Rectangle(width=self.width, height=self.height),
            "position": list(self.position)})
        for obs in self.obstacles:
            if obs["shape"] == "circle":
                shape = Circle(obs["radius"])
            else:
                shape = Rectangle(width=obs["width"], height=obs["height"])
            initial = {"position": obs["pos"],
                       "velocity": obs.get("velocity", [0.0, 0.0])}
            if obs.get("angular_velocity"):
                initial["angular_velocity"] = obs["angular_velocity"]
            environment.add_obstacle(Obstacle(
                initial, shape=shape,
                options={"bounce": bool(obs.get("bounce", False))}))
        return environment

    def get_environment(self):
        return self.build_environment()

    def mainloop(self):  # pragma: no cover - needs a display
        if self.root is not None:
            self.root.mainloop()

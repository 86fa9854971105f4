"""Plotting / observability layer: a copy of
``omg_tools_tpu.execution.plotlayer``, kept here so that the port imports
nothing of the JAX package.

A re-design of omgtools' plot system (execution/plotlayer.py:180-405):
every modeling entity (vehicle, problem, environment) mixes in
``PlotLayer`` and exposes plot *providers* via two hooks:

- ``init_plot(argument, **kwargs)`` returns a grid (list of rows, each row a
  list of axes-info dicts) describing subplots and their line styles;
- ``update_plot(argument, t, **kwargs)`` returns a matching grid of line
  data, each line an ``(n_dim, n_samples)`` array, at sample index ``t``.

On top of the providers PlotLayer implements live figures (``plot``,
``update_plots``), image export (``save_plot``), animation replay
(``plot_movie``) and movie export (``save_movie``: gif via
matplotlib.animation, tikz via a minimal pgfplots writer -- omgtools
shells out to imagemagick / matplotlib2tikz, plotlayer.py:139-177, 328-405).

All of this is host-side observability code -- matplotlib is imported
lazily and an ``Agg`` backend is forced when no display is available, so the
compute path never depends on it.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

__all__ = ["PlotLayer", "mix_with_white"]


def _get_pyplot():
    import matplotlib
    if not os.environ.get("DISPLAY") and matplotlib.get_backend() not in (
            "Agg", "agg"):
        try:
            matplotlib.use("Agg")
        except Exception:
            pass
    import matplotlib.pyplot as plt
    return plt


def mix_with_white(color, perc_white=80.0):
    """Lighten a color by mixing with white (omgtools plotlayer.py:30-37)."""
    import matplotlib.colors as mcolors
    rgb = np.asarray(mcolors.to_rgb(color))
    w = perc_white / 100.0
    return tuple(rgb * (1.0 - w) + w)


class PlotLayer:
    """Mixin giving modeling entities live plots and movie export."""

    # class-level back-pointer, set by Simulator (omgtools plotlayer.py:181)
    simulator = None

    # -- provider hooks (overridden by subclasses) --------------------------
    def init_plot(self, argument, **kwargs):
        return None

    def update_plot(self, argument, t, **kwargs):
        return None

    # -- plot management -----------------------------------------------------
    def _plots_list(self):
        if not hasattr(self, "_plots"):
            self._plots = []
        return self._plots

    def plot(self, argument, **kwargs):
        """Create a figure for provider ``argument`` and draw the latest
        sample (omgtools plotlayer.py:201-247)."""
        t0 = kwargs.pop("t", -1)
        info = self.init_plot(argument, **kwargs)
        if info is None:
            raise ValueError(
                f"{type(self).__name__} has no plot provider {argument!r}")
        plt = _get_pyplot()
        n_rows = len(info)
        n_cols = max(len(row) for row in info)
        proj_3d = any(ax.get("projection") == "3d"
                      for row in info for ax in row)
        fig = plt.figure(figsize=kwargs.get("figsize", (8, 6)))
        axes, lines = [], []
        for i, row in enumerate(info):
            ax_row, ln_row = [], []
            for j, ax_info in enumerate(row):
                if ax_info.get("projection") == "3d":
                    ax = fig.add_subplot(n_rows, n_cols, i * n_cols + j + 1,
                                         projection="3d")
                else:
                    ax = fig.add_subplot(n_rows, n_cols, i * n_cols + j + 1)
                labels = ax_info.get("labels", [])
                if len(labels) > 0:
                    ax.set_xlabel(labels[0])
                if len(labels) > 1:
                    ax.set_ylabel(labels[1])
                if len(labels) > 2 and hasattr(ax, "set_zlabel"):
                    ax.set_zlabel(labels[2])
                if ax_info.get("aspect_equal") and not proj_3d:
                    ax.set_aspect("equal")
                if "xlim" in ax_info:
                    ax.set_xlim(*ax_info["xlim"])
                if "ylim" in ax_info:
                    ax.set_ylim(*ax_info["ylim"])
                ln_ax = []
                for line_style in ax_info.get("lines", []):
                    style = dict(line_style)
                    if ax_info.get("projection") == "3d":
                        (ln,) = ax.plot([], [], [], **style)
                    else:
                        (ln,) = ax.plot([], [], **style)
                    ln_ax.append(ln)
                ax_row.append(ax)
                ln_row.append(ln_ax)
            axes.append(ax_row)
            lines.append(ln_row)
        plot = {"argument": argument, "kwargs": kwargs, "figure": fig,
                "axes": axes, "lines": lines, "info": info}
        self._plots_list().append(plot)
        self.update_plots(t=t0, plots=[plot])
        return plot

    def _draw_plot(self, plot, t=-1):
        data = self.update_plot(plot["argument"], t, **plot["kwargs"])
        if data is None:
            return
        autoscale = not ("xlim" in plot["info"][0][0])
        for i, row in enumerate(data):
            for j, ax_data in enumerate(row):
                ax = plot["axes"][i][j]
                for ln, arr in zip(plot["lines"][i][j], ax_data):
                    arr = np.atleast_2d(np.asarray(arr, dtype=np.float64))
                    if arr.shape[0] >= 3 and hasattr(ln, "set_data_3d"):
                        ln.set_data_3d(arr[0], arr[1], arr[2])
                    else:
                        ln.set_data(arr[0], arr[1] if arr.shape[0] > 1
                                    else np.zeros_like(arr[0]))
                if autoscale:
                    ax.relim()
                    ax.autoscale_view()
        plot["figure"].canvas.draw_idle()

    def update_plots(self, t=-1, plots=None):
        """Redraw registered figures at sample index ``t``
        (omgtools plotlayer.py:248-273)."""
        for plot in (plots if plots is not None else self._plots_list()):
            self._draw_plot(plot, t)

    def show_plots(self, block=False):
        plt = _get_pyplot()
        try:
            plt.show(block=block)
        except Exception:
            pass

    # -- export --------------------------------------------------------------
    def save_plot(self, argument, name="plot", path="images/", t=-1,
                  **kwargs):
        """Render provider ``argument`` at index ``t`` to ``<path><name>``;
        suffix picks the format (default .png; .tex emits tikz)."""
        os.makedirs(path, exist_ok=True)
        root, ext = os.path.splitext(name)
        ext = ext or ".png"
        plot = self.plot(argument, **dict(kwargs, t=t))
        target = os.path.join(path, root + ext)
        if ext == ".tex":
            self._save_tikz(plot, target)
        else:
            plot["figure"].savefig(target, bbox_inches="tight", dpi=150)
        return target

    def plot_movie(self, argument, repeat=False, number_of_frames=100,
                   **kwargs):
        """Replay the simulation inside a live figure
        (omgtools plotlayer.py:279-326)."""
        plot = self.plot(argument, **kwargs)
        plt = _get_pyplot()
        for t in self._frame_indices(number_of_frames):
            self._draw_plot(plot, t)
            try:
                plt.pause(0.01)
            except Exception:
                break
        while repeat:  # pragma: no cover - interactive only
            for t in self._frame_indices(number_of_frames):
                self._draw_plot(plot, t)
                plt.pause(0.01)

    def save_movie(self, argument, format="gif", name="movie", path="movies/",
                   number_of_frames=100, **kwargs):
        """Export an animation: gif/mp4 via matplotlib.animation, tikz as a
        frame sequence (omgtools plotlayer.py:328-405)."""
        os.makedirs(path, exist_ok=True)
        plot = self.plot(argument, **kwargs)
        frames = self._frame_indices(number_of_frames)
        if format == "tikz":
            directory = os.path.join(path, name)
            os.makedirs(directory, exist_ok=True)
            for k, t in enumerate(frames):
                self._draw_plot(plot, t)
                self._save_tikz(plot, os.path.join(directory, f"{name}_{k}.tex"))
            return directory
        import matplotlib.animation as animation

        def animate(t):
            self._draw_plot(plot, t)
            return [ln for row in plot["lines"] for lns in row for ln in lns]

        anim = animation.FuncAnimation(plot["figure"], animate, frames=frames,
                                       blit=False)
        target = os.path.join(path, f"{name}.{format}")
        try:
            if format == "gif":
                anim.save(target, writer=animation.PillowWriter(fps=10))
            else:
                anim.save(target, fps=10)
        except Exception as err:  # pragma: no cover - writer availability
            warnings.warn(f"movie export failed ({err}); saving last frame")
            target = os.path.join(path, f"{name}.png")
            plot["figure"].savefig(target)
        return target

    def _frame_indices(self, number_of_frames):
        n = self._n_samples()
        if n <= 1:
            return [0]
        number_of_frames = min(number_of_frames, n)
        return list(np.unique(np.linspace(0, n - 1, number_of_frames)
                              .astype(int)))

    def _n_samples(self):
        # prefer this entity's own data: the class-level simulator pointer
        # may belong to a DIFFERENT problem in the same process
        signals = getattr(self, "signals", None)
        if signals and "time" in signals:
            return np.atleast_2d(signals["time"]).shape[-1]
        for vehicle in getattr(self, "vehicles", []):
            if "time" in vehicle.signals:
                return vehicle.signals["time"].shape[-1]
        sim = PlotLayer.simulator
        if sim is not None and getattr(sim, "problem", None) is not None:
            for vehicle in getattr(sim.problem, "vehicles", []):
                if "time" in vehicle.signals:
                    return vehicle.signals["time"].shape[-1]
        return 1

    # -- minimal tikz writer --------------------------------------------------
    def _save_tikz(self, plot, target):
        """Write the current figure's line data as a pgfplots picture.
        Replaces omgtools' matplotlib2tikz + _cleanup_rubbish
        post-processor (plotlayer.py:139-177) with a direct writer."""
        parts = ["% generated by omg_tools_torch PlotLayer\n",
                 "\\begin{tikzpicture}\n"]
        for i, ax_row in enumerate(plot["axes"]):
            for j, ax in enumerate(ax_row):
                opts = [f"xlabel={{{ax.get_xlabel()}}}",
                        f"ylabel={{{ax.get_ylabel()}}}"]
                if ax.get_aspect() == 1.0:
                    opts.append("axis equal")
                parts.append("\\begin{axis}[%s]\n" % ", ".join(opts))
                for ln in plot["lines"][i][j]:
                    x, y = ln.get_data()
                    coords = " ".join(f"({float(a):.6g},{float(b):.6g})"
                                      for a, b in zip(np.atleast_1d(x),
                                                      np.atleast_1d(y)))
                    parts.append("\\addplot coordinates {%s};\n" % coords)
                parts.append("\\end{axis}\n")
        parts.append("\\end{tikzpicture}\n")
        with open(target, "w") as fh:
            fh.write("".join(parts))
        return target

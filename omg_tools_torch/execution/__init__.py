"""Subpackage of omg_tools_torch (see the package docstring)."""

from .simulator import Simulator, Deployer
from .plotlayer import PlotLayer

__all__ = ["Simulator", "Deployer", "PlotLayer"]

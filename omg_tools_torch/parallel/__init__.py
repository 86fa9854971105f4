"""The fleet's device loop (``FleetRunner``)."""

from .fleet_runner import FleetCarry, FleetRunner

__all__ = ["FleetCarry", "FleetRunner"]

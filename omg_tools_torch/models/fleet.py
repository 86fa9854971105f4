"""Fleet: vehicle container + interconnection graph (a copy of
``omg_tools_tpu.models.fleet``; it holds no array code of its own).

Mirrors omgtools' vehicles/fleet.py: neighbor topology ('circular' or
'full'), formation configuration -> per-vehicle relative positions
``rel_pos_c`` and pairwise relative configurations ``rel_config``, and
broadcasting of initial/terminal conditions.  The neighbor graph is what
the consensus ADMM (``problems.admm``) communicates along.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

__all__ = ["Fleet", "get_fleet_vehicles"]


class Fleet:

    def __init__(self, vehicles=None, interconnection="circular"):
        vehicles = vehicles or []
        self.vehicles = vehicles if isinstance(vehicles, list) else [vehicles]
        self.interconnection = interconnection
        self.set_neighbors()

    @property
    def N(self):
        return len(self.vehicles)

    def add_vehicle(self, vehicle):
        if isinstance(vehicle, list):
            self.vehicles.extend(vehicle)
        else:
            self.vehicles.append(vehicle)
        self.set_neighbors()

    def set_neighbors(self):
        """Build the neighbor lists (omgtools fleet.py:49-60)."""
        self.nghb_list: Dict = {}
        N = self.N
        for l, vehicle in enumerate(self.vehicles):
            if self.interconnection == "circular":
                if N > 2:
                    nghb_ind = [(l + 1) % N, (l - 1) % N]
                elif N == 2:
                    nghb_ind = [(l + 1) % N]
                else:
                    nghb_ind = []
            elif self.interconnection == "full":
                nghb_ind = [k for k in range(N) if k != l]
            else:
                raise ValueError("interconnection must be circular or full")
            self.nghb_list[vehicle] = [self.vehicles[k] for k in nghb_ind]

    def get_neighbors(self, vehicle):
        return self.nghb_list[vehicle]

    # -- formation configuration ------------------------------------------
    def set_configuration(self, configuration, orientation=0.0):
        """configuration: per-vehicle offsets from the fleet center, either
        lists (mapped onto spline indices 0..n-1) or {spline_index: value}
        dicts.  Builds rel_pos_c = -offset per vehicle (center = position +
        rel_pos_c) and pairwise rel_config (omgtools fleet.py:62-101)."""
        if len(configuration) != self.N:
            raise ValueError("need one configuration entry per vehicle")
        cth, sth = np.cos(-orientation), np.sin(-orientation)
        self.configuration = {}
        for l, config in enumerate(configuration):
            if isinstance(config, dict):
                self.configuration[self.vehicles[l]] = dict(config)
                continue
            config = list(config)
            if len(config) == 2:
                config = [config[0] * cth - config[1] * sth,
                          config[0] * sth + config[1] * cth]
            self.configuration[self.vehicles[l]] = dict(enumerate(config))
        for veh in self.vehicles:
            ind = sorted(self.configuration[veh].keys())
            veh.rel_pos_c = [-self.configuration[veh][k] for k in ind]
        self.rel_config = {}
        for veh in self.vehicles:
            self.rel_config[veh] = {}
            ind_veh = sorted(self.configuration[veh].keys())
            for nghb in self.get_neighbors(veh):
                ind_nghb = sorted(self.configuration[nghb].keys())
                self.rel_config[veh][nghb] = [
                    self.configuration[veh][iv] - self.configuration[nghb][ig]
                    for iv, ig in zip(ind_veh, ind_nghb)]

    def get_rel_config(self, vehicle):
        return self.rel_config[vehicle]

    # -- broadcast helpers -------------------------------------------------
    def set_initial_conditions(self, conditions):
        for veh, cond in zip(self.vehicles, conditions):
            veh.set_initial_conditions(cond)

    def set_terminal_conditions(self, conditions):
        for veh, cond in zip(self.vehicles, conditions):
            veh.set_terminal_conditions(cond)

    def overrule_state(self, states):
        for veh, st in zip(self.vehicles, states):
            veh.overrule_state(st)

    def overrule_input(self, inputs):
        for veh, inp in zip(self.vehicles, inputs):
            veh.overrule_input(inp)


def get_fleet_vehicles(fleet_or_vehicles):
    """Normalize user input to (Fleet, [vehicles])
    (omgtools fleet.py:176-185)."""
    from .base import Vehicle
    if isinstance(fleet_or_vehicles, Fleet):
        return fleet_or_vehicles, fleet_or_vehicles.vehicles
    if isinstance(fleet_or_vehicles, Vehicle):
        fleet = Fleet([fleet_or_vehicles])
        return fleet, fleet.vehicles
    fleet = Fleet(list(fleet_or_vehicles))
    return fleet, fleet.vehicles

"""Problem base class (counterpart of ``omg_tools_tpu.problems.problem``).

``init()`` runs the layout-pass transcription over all children and the
one-time host precomputation the solvers share: Ipopt-style gradient row
scaling and the objective scale, by ``torch.func`` AD in float64 on the
CPU.

Not ported yet: the single-scenario host ``solve()`` loop with its
reinitialize-on-failure policy (the simulator's path), the ``ipm`` and
``scipy`` backends, fleets of more than one vehicle, and plotting.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.func import grad, jacfwd

from ..modeling.opti import OptiChild, OptiFather
from ..ops.solver import gradient_row_scales

__all__ = ["Problem", "get_fleet_vehicles"]


def get_fleet_vehicles(fleet_or_vehicles):
    """Normalize user input to (fleet, [vehicles]) for one vehicle."""
    from ..models.base import Vehicle
    if isinstance(fleet_or_vehicles, Vehicle):
        return None, [fleet_or_vehicles]
    vehicles = list(fleet_or_vehicles)
    if len(vehicles) != 1 or not isinstance(vehicles[0], Vehicle):
        raise NotImplementedError(
            "omg_tools_torch supports problems with one vehicle so far")
    return None, vehicles


class Problem(OptiChild):

    def __init__(self, fleet, environment, options=None, label="problem"):
        OptiChild.__init__(self, label)
        self.fleet, self.vehicles = get_fleet_vehicles(fleet)
        self.environment = environment
        self.set_default_options()
        self.set_options(options or {})

    # -- options -----------------------------------------------------------
    def set_default_options(self):
        self.options = {
            "verbose": 2,
            "solver": "alm",
            "solver_options": {"max_iter": 60, "tol": 1e-4},
            "dtype": "float64",
        }

    def set_options(self, options):
        for key, val in options.items():
            if key == "solver_options":
                self.options["solver_options"].update(val)
            else:
                self.options[key] = val

    # -- build -------------------------------------------------------------
    def init(self):
        if self.options.get("solver", "alm") != "alm":
            raise NotImplementedError(
                "omg_tools_torch ports the 'alm' backend only so far")
        self.children = (list(self.vehicles) + self.environment.obstacles
                         + [self.environment, self])
        self.father = OptiFather(self.children)
        self.transcription = self.father.transcribe(self.construct)
        tr = self.transcription
        # Ipopt-style gradient-based row scaling at the initial guess
        # (one-time host AD in float64)
        x_ref = torch.as_tensor(tr.initial_guess())
        p_ref = torch.as_tensor(self.pack_parameters(0.0))
        row_scale = gradient_row_scales(jacfwd(tr.constraints), x_ref, p_ref)
        grad0 = grad(tr.objective)(x_ref, p_ref).numpy()
        self._row_scale = row_scale
        self._obj_scale = 1.0 / max(1.0, np.max(np.abs(grad0)) / 100.0)
        self._primal_transform = None
        tf = getattr(self, "init_primal_transform", None)
        if tf is not None:
            self._primal_transform = tr.spline_shift_matrix(tf)
        if self.options["verbose"] >= 2:
            print(f"[{self.label}] transcribed: n_x={tr.n_x} "
                  f"n_g={tr.n_g} n_p={tr.n_p}")

    def pack_parameters(self, current_time) -> np.ndarray:
        values: Dict = {}
        for child in self.children:
            for obj, d in child.set_parameters(current_time).items():
                values[obj] = {**values.get(obj, {}), **d}
        return self.transcription.pack_parameters(values)

    def construct(self):
        """Declare shared symbols and let environment/vehicles register.
        Subclasses extend."""
        self.environment.init()

    def initialize(self, current_time):
        self.start_time = current_time

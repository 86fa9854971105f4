"""Distributed-formation export: the two-phase embedded ADMM runtime
(counterpart of ``omg_tools_tpu.export.export_formation``).

Exports ONE local problem per vehicle type: the plain fixed-T
point-to-point tensors (the base ``Export``) plus the consensus-ADMM data:
the shared-coefficient selector ``S_idx``, the closed-form z-projection
matrix ``z_proj``, the knot-shift transform of the shared coefficients and
the penalty parameter.  The C++ side (cpp/omg_admm.{hpp,cpp}) implements
the caller-communicates ``update1``/``update2`` API.  The local problem
and its runner are built in float64 on the CPU."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .export import Export, _write_array

__all__ = ["ExportFormation", "ExportADMM"]


class ExportADMM(Export):
    """Shared machinery for ADMM-based exports (formation, rendezvous)."""

    def __init__(self, problem, options=None):
        """problem: an initialized ADMMProblem (e.g. FormationPoint2point)."""
        Export.__init__(self, problem, options)

    def _local_options(self):
        options = {"verbose": 0, "device": "cpu"}
        if "horizon_time" in self.problem.options:
            options["horizon_time"] = self.problem.options["horizon_time"]
        return options

    def _local_problem(self):
        """Plain single-vehicle fixed-T point-to-point problem matching the
        ADMM local subproblem's variable layout (the z/lam consensus terms
        enter the C++ objective via hooks, not the transcription)."""
        from ..problems.point2point import FixedTPoint2point
        prob = self.problem
        local = FixedTPoint2point(prob.vehicles[0], prob.environment.copy(),
                                  self._local_options())
        local.init()
        return local

    def _shared_selector(self, runner, local):
        """Indices of the shared coefficients in the local transcription."""
        veh = local.vehicles[0]
        sl, shape = runner.tr.var_slice(veh, "splines_seg0")
        n_c, n_spl = shape
        idx = np.arange(sl.start, sl.stop).reshape(n_c, n_spl)
        ind = self.problem.template.fleet_config_indices
        return np.concatenate([idx[:, k] for k in ind])

    def run(self):
        from ..problems.batch import BatchedP2PRunner
        prob = self.problem
        local = self._local_problem()
        runner = BatchedP2PRunner(local, dtype=torch.float64, device="cpu")
        out = self.export(runner)
        extras = {
            "S_idx": self._shared_selector(runner, local).astype(np.float64),
            "z_proj": np.asarray(prob.z_proj),
            "sh_shift": np.asarray(prob._sh_shift),
        }
        scalars = {
            "n_sh": int(prob.n_sh),
            "n_slots": int(prob.n_slots),
            "rho_admm": float(prob.rho),
            "init_iter": int(prob.init_iter),
        }
        self._append(out, extras, scalars)
        return out

    def _append(self, out, arrays, scalars):
        manifest_path = os.path.join(out, "manifest.json")
        with open(manifest_path) as f:
            manifest = json.load(f)
        data_dir = os.path.join(out, "data")
        with open(os.path.join(out, "meta.txt"), "a") as meta:
            for key, val in scalars.items():
                manifest["scalars"][key] = val
                meta.write(f"scalar {key} {val}\n")
            for name, arr in arrays.items():
                _write_array(data_dir, name, arr, manifest)
                dims = " ".join(str(s) for s in np.asarray(arr).shape)
                meta.write(f"array {name} {np.asarray(arr).ndim} {dims}\n")
        with open(manifest_path, "w") as f:
            json.dump(manifest, f, indent=1)


class ExportFormation(ExportADMM):
    """Formation-specific entry point."""

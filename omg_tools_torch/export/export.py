"""Embedded C++ runtime export (counterpart of
``omg_tools_tpu.export.export``).

The exported runtime replaces the NLP with the structural quadratic form
g(x, p) = c(p) + A(p) x + x'Q x and is self-contained: a dense
Gauss-Newton augmented-Lagrangian solver in plain C++ (no torch, no
CasADi, no Ipopt) that reads the problem tensors written here:

- Q (sparse COO), per-phase affine tensors c0/C1 (dense) and A0/TA
  (sparse), the objective gradient, bounds, the warm-start shift matrix,
  the spline bases;
- the static C++ sources of ``cpp/`` (solver, spline sampler, MPC stepper,
  test harnesses) copied next to the data with a Makefile.

Layout of an exported directory:
    manifest.json  meta.txt  data/*.bin  *.hpp *.cpp Makefile

The exporter computes nothing on a device: everything it writes is host
float64, from the runner's host tensors (``_affine_np``) and host AD, so
the problems and runners it builds itself are float64 on the CPU.  A
runner built on a card writes the same files.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict

import numpy as np
import torch

from ..ops.alm import detect_quadratic_structure
from ..ops.solver import BIG

__all__ = ["Export"]

_CPP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp")


def _write_array(data_dir, name, arr, manifest, dtype="<f8"):
    arr = np.ascontiguousarray(np.asarray(arr, dtype=np.float64))
    path = os.path.join(data_dir, name + ".bin")
    arr.astype(dtype).tofile(path)
    manifest["arrays"][name] = {"shape": list(arr.shape), "dtype": dtype,
                                "file": f"data/{name}.bin"}


def _sparse_coo(T, tol=1e-12):
    """Flatten an (m, ...) tensor to COO (rows, cols..., values)."""
    idx = np.argwhere(np.abs(T) > tol)
    vals = T[tuple(idx.T)]
    return idx.astype(np.float64), vals


def _host(t):
    """A runner's device tensor on the host, in the runner's dtype."""
    return t.detach().cpu().numpy()


class Export:

    def __init__(self, problem, options=None):
        self.problem = problem
        self.options = options or {}
        self.directory = self.options.get("directory", "export")

    def export(self, runner):
        """Write the exported runtime for a ``BatchedP2PRunner`` with the
        quadratic structure's per-phase affine tensors."""
        if not runner.affine_cA:
            raise RuntimeError(
                "export requires the quadratic/affine problem structure")
        out = self.directory
        data_dir = os.path.join(out, "data")
        os.makedirs(data_dir, exist_ok=True)
        tr = runner.tr
        problem = runner.problem   # the runner's (local) problem: for
        # distributed exports self.problem is the multi-vehicle wrapper
        vehicle = problem.vehicles[0]
        model = runner.model

        manifest: Dict = {"arrays": {}, "scalars": {}}
        man = manifest["scalars"]
        man["n_x"] = tr.n_x
        man["n_g"] = tr.n_g
        man["n_p"] = tr.n_p
        man["n_phases"] = int(runner.steps_per_knot)
        man["horizon_time"] = float(runner.horizon)
        man["update_time"] = float(runner.update_time)
        man["n_spl"] = int(vehicle.n_spl)
        man["spline_degree"] = int(vehicle.degree)
        man["n_coeffs"] = len(vehicle.basis)
        man["i_splines_start"] = int(runner.i_splines[0])
        man["i_t"] = int(runner.i_t[0])
        man["i_state0"] = int(model.i_state0[0])
        man["i_input0"] = int(model.i_input0[0])
        sl, _ = tr.par_slice(vehicle, "poseT")
        man["i_poseT"] = int(sl.start)
        man["obstacle_idx"] = [
            [int(ix[0]), int(iv[0]), int(ia[0])]
            for (ix, iv, ia) in runner.obstacle_idx]
        # spline-trajectory obstacles: parameter offset and shape per slot,
        # and the per-period re-basing transform the runtime applies when
        # the caller does not supply fresh coefficients
        man["traj_obstacle_idx"] = [
            [int(ic[0]), int(cshape[0]), int(cshape[1])]
            for (ic, cshape, _) in runner.traj_obstacle_idx]
        man["rho_init"] = 100.0
        man["rho_max"] = 1e4

        p_ref = np.asarray(problem.pack_parameters(0.0), dtype=np.float64)
        frozen = []
        try:
            slT, _ = tr.par_slice(problem, "T")
            frozen = list(range(slT.start, slT.stop))
        except KeyError:
            pass
        Q = detect_quadratic_structure(tr.constraints, tr.n_x,
                                       torch.as_tensor(p_ref),
                                       frozen_idx=frozen)
        # fold the row scaling into everything exported
        d = np.asarray(problem._row_scale, dtype=np.float64)
        obj_scale = float(problem._obj_scale)
        an = runner._affine_np
        Qs = Q * d[:, None, None]
        qi, qv = _sparse_coo(Qs)
        _write_array(data_dir, "Q_idx", qi, manifest)
        _write_array(data_dir, "Q_val", qv, manifest)
        _write_array(data_dir, "c0", an["c0"] * d[None, :], manifest)
        # C1/TA are restricted to the VARYING parameter columns (vsel);
        # the C++ runtime contracts against the full p vector, so expand
        # the column space back out (zeros on the frozen columns: their
        # contribution is folded into c0/A0 at the reference point)
        vsel = np.asarray(an["vsel"], dtype=np.int64)
        C1v = an["C1"] * d[None, :, None]
        C1 = np.zeros(C1v.shape[:2] + (tr.n_p,))
        C1[:, :, vsel] = C1v
        _write_array(data_dir, "C1", C1, manifest)
        A0 = an["A0"] * d[None, :, None]
        ai, av = _sparse_coo(A0)
        _write_array(data_dir, "A0_idx", ai, manifest)
        _write_array(data_dir, "A0_val", av, manifest)
        TAv = an["TA"] * d[None, :, None, None]
        ti, tv = _sparse_coo(TAv)
        ti[:, -1] = vsel[ti[:, -1].astype(np.int64)]  # remap to full-p cols
        _write_array(data_dir, "TA_idx", ti, manifest)
        _write_array(data_dir, "TA_val", tv, manifest)
        _write_array(data_dir, "gf", an["gf"] * obj_scale, manifest)
        lbn, ubn = (np.asarray(b, dtype=np.float64) for b in tr.bounds(0.0))
        lbn = np.where(lbn > -BIG / 2, d * lbn, lbn)
        ubn = np.where(ubn < BIG / 2, d * ubn, ubn)
        _write_array(data_dir, "lb", lbn, manifest)
        _write_array(data_dir, "ub", ubn, manifest)
        _write_array(data_dir, "shift_M", _host(runner.shift_M), manifest)
        _write_array(data_dir, "p_base", p_ref, manifest)
        _write_array(data_dir, "x_init", tr.initial_guess(), manifest)
        # spline sampling data
        _write_array(data_dir, "knots", vehicle.basis.knots, manifest)
        for o, (_, _, M_obs) in enumerate(runner.traj_obstacle_idx):
            _write_array(data_dir, f"traj_shift{o}", _host(M_obs), manifest)
        _write_array(data_dir, "E0", _host(model.E0), manifest)
        _write_array(data_dir, "E1", _host(model.E1), manifest)

        with open(os.path.join(out, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        # flat manifest for the C++ loader (no JSON dependency)
        with open(os.path.join(out, "meta.txt"), "w") as f:
            for k, v in manifest["scalars"].items():
                if k == "obstacle_idx":
                    f.write(f"scalar n_obstacles {len(v)}\n")
                    for o, (ix, iv, ia) in enumerate(v):
                        f.write(f"scalar obs{o}_x {ix}\n")
                        f.write(f"scalar obs{o}_v {iv}\n")
                        f.write(f"scalar obs{o}_a {ia}\n")
                elif k == "traj_obstacle_idx":
                    f.write(f"scalar n_traj_obstacles {len(v)}\n")
                    for o, (ic, nb, nd) in enumerate(v):
                        f.write(f"scalar tobs{o}_coeffs {ic}\n")
                        f.write(f"scalar tobs{o}_nb {nb}\n")
                        f.write(f"scalar tobs{o}_dim {nd}\n")
                else:
                    f.write(f"scalar {k} {v}\n")
            for name, info in manifest["arrays"].items():
                dims = " ".join(str(s) for s in info["shape"])
                f.write(f"array {name} {len(info['shape'])} {dims}\n")

        for fname in os.listdir(_CPP_DIR):
            shutil.copy(os.path.join(_CPP_DIR, fname),
                        os.path.join(out, fname))
        return out

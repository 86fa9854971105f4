"""Carry state from the JAX package into the port.

The functions take the JAX package's arrays as numpy (``np.asarray`` of a
jax array, or the host tensors it keeps) and return the port's objects, so
that both packages can be fed identical solver inputs: a difference then
lies in the solver, not in tensors the two built by their own AD.  Nothing
here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.alm import ALMState
from .ops.compact import ArrowStatic, CompactStructure, FamilyStatic
from .problems.batch import resolve_device

__all__ = ["state_from_numpy", "batch_from_numpy", "compact_from_numpy"]


def state_from_numpy(state, dtype=torch.float64, device=None):
    """An ALMState from a mapping (or NamedTuple) of numpy arrays with the
    fields x, lam, rho, feas, stat, n_iter[, feas_raw] over a batch, on
    ``device`` (None: CUDA, which must then exist)."""
    device = resolve_device(device)
    d = state._asdict() if hasattr(state, "_asdict") else dict(state)
    out = {}
    for name in ALMState._fields:
        val = d.get(name)
        if val is None:
            out[name] = None
            continue
        out[name] = torch.tensor(
            np.asarray(val), dtype=torch.int32 if name == "n_iter" else dtype,
            device=device)
    return ALMState(**out)


def batch_from_numpy(x0, p0, state, device=None, dtype=torch.float64):
    """(x0 (B, n_x), p0 (B, n_p), state (B, n_dim)) tensors on ``device``
    (None: CUDA, which must then exist)."""
    device = resolve_device(device)
    return tuple(torch.tensor(np.asarray(a), dtype=dtype, device=device)
                 for a in (x0, p0, state))


def compact_from_numpy(families, row_perm, tensors, n_x, n_p, arrow=None):
    """A port CompactStructure from the JAX CompactStructure's pieces:
    ``families`` (FamilyStatic tuples), ``row_perm``, ``tensors`` (its host
    dict: c0, C1, f0, gf, pcols, and per-family lists A0c/TAc/Qc with None
    where absent) and ``arrow`` (an ArrowStatic tuple or None)."""
    fams = [FamilyStatic(int(f[0]), int(f[1]),
                         tuple((int(s), int(z)) for (s, z) in f[2]),
                         tuple(int(q) for q in f[3]), bool(f[4]))
            for f in families]
    host = {}
    for key in ("c0", "C1", "f0", "gf"):
        host[key] = np.asarray(tensors[key], dtype=np.float64)
    host["pcols"] = np.asarray(tensors.get(
        "pcols", np.arange(host["C1"].shape[-1])), dtype=np.int32)
    for key in ("A0c", "TAc", "Qc"):
        host[key] = [None if a is None else np.asarray(a, dtype=np.float64)
                     for a in tensors[key]]
    ar = None
    if arrow is not None:
        ar = ArrowStatic(
            head=tuple(int(v) for v in arrow[0]),
            blocks=tuple(tuple(int(v) for v in b) for b in arrow[1]),
            fam_segments=tuple(tuple(tuple(int(v) for v in seg)
                                     for seg in segs) for segs in arrow[2]),
            fam_block=tuple(int(v) for v in arrow[3]),
            b_max=int(arrow[4]))
    return CompactStructure(fams, np.asarray(row_perm), host, n_x=int(n_x),
                            n_p=int(n_p), arrow=ar)

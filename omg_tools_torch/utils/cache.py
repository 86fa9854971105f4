"""Disk cache for the one-time host precomputation (counterpart of
``omg_tools_tpu.utils.cache``).

Problem setup runs heavy host AD (row scales, quadratic-structure
detection, the per-phase affine constraint tensors) that is a pure
function of the transcribed problem.  Its results are stored under
``$OMG_CACHE_DIR/torch`` (by default ``.omg_cache/torch`` at the root of
the checkout), keyed on a content fingerprint: layout sizes, bounds,
initial guess, base parameters, plus objective and constraint values at
deterministic probe points, so that any change to the model code or its
data changes the key.

Tensors are stored in float64, the host AD's own dtype, whatever the
dtype of the runner that wrote them; a runner casts them when it uses
them.  A cache written by a float32 run therefore serves a float64 run
unrounded.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

__all__ = ["problem_fingerprint", "load_tensors", "store_tensors",
           "cache_dir"]

_VERSION = "torch-1"  # change to invalidate every cached artifact


def cache_dir():
    """The cache's root directory, created on first use."""
    base = os.environ.get(
        "OMG_CACHE_DIR",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), ".omg_cache"))
    root = os.path.join(base, "torch")
    os.makedirs(root, exist_ok=True)
    return root


def problem_fingerprint(tr, p_base, extra=""):
    """Content hash of a transcribed problem: sizes, bounds, guess, base
    parameters and probe values of (objective, constraints), evaluated in
    float64 on the CPU."""
    h = hashlib.md5()
    h.update(_VERSION.encode())
    h.update(extra.encode())
    h.update(np.int64(tr.n_x).tobytes())
    h.update(np.int64(tr.n_p).tobytes())
    h.update(np.asarray(tr.lb, dtype=np.float64).tobytes())
    h.update(np.asarray(tr.ub, dtype=np.float64).tobytes())
    h.update(np.asarray(tr.initial_guess(), dtype=np.float64).tobytes())
    h.update(np.asarray(p_base, dtype=np.float64).tobytes())
    rng = np.random.default_rng(12345)
    x_probe = torch.as_tensor(rng.standard_normal(tr.n_x) * 0.3)
    p_probe = torch.as_tensor(np.asarray(p_base, dtype=np.float64)
                              + rng.standard_normal(len(np.asarray(p_base)))
                              * 0.05)
    with torch.no_grad():
        gv = tr.constraints(x_probe, p_probe).numpy()
        fv = np.float64(tr.objective(x_probe, p_probe))
    h.update(np.round(gv, 9).tobytes())
    h.update(np.round(fv, 9).tobytes())
    return h.hexdigest()


def _path(key, name):
    return os.path.join(cache_dir(), f"{name}_{key}.npz")


def load_tensors(key, name):
    """The arrays stored under (key, name), or None when there are none or
    the file cannot be read."""
    target = _path(key, name)
    if not os.path.exists(target):
        return None
    try:
        with np.load(target, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError):
        return None


def _f64(a):
    a = np.asarray(a)
    return a.astype(np.float64) if np.issubdtype(a.dtype, np.floating) else a


def store_tensors(key, name, arrays):
    """Store ``arrays`` under (key, name), floating arrays in float64; the
    file appears whole or not at all."""
    target = _path(key, name)
    tmp = os.path.join(cache_dir(), f".tmp{os.getpid()}_{name}_{key}.npz")
    np.savez(tmp, **{k: _f64(v) for k, v in arrays.items()})
    os.replace(tmp, target)
    return target

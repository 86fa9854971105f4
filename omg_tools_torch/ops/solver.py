"""Solver constants and Ipopt-style row scaling (the part of
``omg_tools_tpu.ops.solver`` the ALM path needs; the interior-point
backend is not ported yet)."""

from __future__ import annotations

import numpy as np

__all__ = ["BIG", "gradient_row_scales"]

BIG = 1e20


def gradient_row_scales(jac_fn, x0, p0, max_gradient=100.0):
    """Ipopt-style gradient-based constraint scaling: rows whose Jacobian
    infinity-norm at the reference point exceeds ``max_gradient`` are scaled
    down (Ipopt's nlp_scaling_method=gradient-based)."""
    J = np.asarray(jac_fn(x0, p0))
    row_norm = np.max(np.abs(J), axis=1)
    return 1.0 / np.maximum(1.0, row_norm / max_gradient)

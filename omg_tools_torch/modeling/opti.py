"""Constraint-transcription layer (counterpart of
``omg_tools_tpu.modeling.opti``).

Every modeling object (vehicle, obstacle, environment, problem -- all
``OptiChild``s) calls ``define_variable / define_spline_variable /
define_parameter / define_constraint / define_objective``; an
:class:`OptiContext` services the calls by running the model code twice:

1. **layout pass** -- allocates named variable/parameter blocks, records
   constraint row counts and constant bounds, and captures initial values;
2. **replay pass** -- re-runs the identical model code with block views
   sliced out of flat ``x`` / ``p`` tensors, giving ``objective(x, p)`` and
   ``constraints(x, p)`` functions that ``torch.func.jacfwd`` can
   differentiate (twice): the replay only slices its inputs, never writes
   into them and never reads a value back to Python.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.basis import Basis
from ..ops.spline import BSpline

__all__ = ["OptiChild", "OptiFather", "Transcription", "BIG"]

BIG = 1e20  # stand-in for +/- inf bounds (masked in the solver)


class _VarBlock:
    __slots__ = ("child", "name", "shape", "basis", "value", "offset")

    def __init__(self, child, name, shape, basis=None, value=None):
        self.child = child
        self.name = name
        self.shape = tuple(shape)
        self.basis = basis  # set for spline coefficient blocks
        self.value = np.zeros(self.shape) if value is None else np.broadcast_to(
            np.asarray(value, dtype=np.float64), self.shape).copy()
        self.offset = None

    @property
    def size(self):
        return int(np.prod(self.shape))


class _ConBlock:
    __slots__ = ("label", "rows", "lb", "ub", "shutdown", "offset")

    def __init__(self, label, rows, lb, ub, shutdown):
        self.label = label
        self.rows = rows
        self.lb = np.broadcast_to(np.asarray(lb, dtype=np.float64), (rows,)).copy()
        self.ub = np.broadcast_to(np.asarray(ub, dtype=np.float64), (rows,)).copy()
        self.shutdown = shutdown  # None or callable(t)->bool
        self.offset = None


class OptiContext:
    """Shared recording/replay context threaded through all children."""

    def __init__(self, mode: str, layout: Optional["OptiContext"] = None,
                 x=None, p=None):
        if mode not in ("layout", "replay"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.variables: "collections.OrderedDict[Tuple[str,str],_VarBlock]" = \
            collections.OrderedDict()
        self.parameters: "collections.OrderedDict[Tuple[str,str],_VarBlock]" = \
            collections.OrderedDict()
        self.constraints: List[_ConBlock] = []
        self.con_values: List = []
        self.objective = 0.0
        self.substitutes: Dict[Tuple[str, str], object] = {}
        self._con_cnt = 0
        self._layout = layout
        self._x = x
        self._p = p

    # -- block access ------------------------------------------------------
    def _fetch(self, table_name, key):
        layout = self._layout
        blk = (layout.variables if table_name == "variables"
               else layout.parameters)[key]
        flat = self._x if table_name == "variables" else self._p
        return flat[blk.offset:blk.offset + blk.size].reshape(blk.shape)

    def declare(self, table_name, child, name, shape, basis=None, value=None):
        key = (child.label, name)
        if self.mode == "layout":
            table = getattr(self, table_name)
            if key in table:
                # idempotent re-declaration (obstacle.init runs per
                # segment); shape must agree
                if table[key].shape != tuple(shape):
                    raise ValueError(
                        f"conflicting re-declaration of {key}: "
                        f"{table[key].shape} vs {tuple(shape)}")
                return torch.as_tensor(table[key].value)
            blk = _VarBlock(child.label, name, shape, basis, value)
            table[key] = blk
            return torch.as_tensor(blk.value)
        return self._fetch(table_name, key)

    def add_constraint(self, child, expr, lb, ub, shutdown=None, name=None,
                       skip=()):
        """Spline expr -> bounds on every coefficient (convex-hull property);
        tensor expr -> elementwise bounds."""
        if isinstance(expr, (float, int)):
            return
        if isinstance(expr, BSpline):
            vals = expr.coeffs
            if skip:
                head, tail = skip
                vals = vals[..., head:vals.shape[-1] - tail if tail else None]
        else:
            vals = torch.atleast_1d(torch.as_tensor(expr))
        rows = int(vals.shape[-1]) if vals.ndim else 1
        label = f"{child.label}:{name or 'c'}{self._con_cnt}"
        self._con_cnt += 1
        if self.mode == "layout":
            self.constraints.append(_ConBlock(label, rows, lb, ub, shutdown))
        self.con_values.append(vals.reshape((-1,)))

    def add_objective(self, child, expr):
        if self.mode == "replay":
            self.objective = self.objective + expr


class OptiChild:
    """Base class for every modeling entity (vehicle, obstacle, environment,
    problem)."""

    _label_counts: Dict[str, int] = {}

    def __init__(self, label: str):
        cnt = OptiChild._label_counts.get(label, 0)
        OptiChild._label_counts[label] = cnt + 1
        self.label = f"{label}{cnt}"
        self._ctx: Optional[OptiContext] = None

    # -- definition API ----------------------------------------------------
    def define_variable(self, name, size=1, value=None):
        shape = (size,) if isinstance(size, int) else tuple(size)
        return self._ctx.declare("variables", self, name, shape, None, value)

    def define_parameter(self, name, size=1, value=None):
        shape = (size,) if isinstance(size, int) else tuple(size)
        return self._ctx.declare("parameters", self, name, shape, None, value)

    def define_spline_variable(self, name, size=1, basis: Basis = None,
                               value=None):
        basis = basis if basis is not None else self.basis
        arr = self._ctx.declare("variables", self, name, (len(basis), size),
                                basis, value)
        return [BSpline(basis, arr[:, k]) for k in range(size)]

    def define_spline_parameter(self, name, size=1, basis: Basis = None,
                                value=None):
        basis = basis if basis is not None else self.basis
        arr = self._ctx.declare("parameters", self, name, (len(basis), size),
                                basis, value)
        return [BSpline(basis, arr[:, k]) for k in range(size)]

    def define_constraint(self, expr, lb, ub, shutdown=None, name=None,
                          skip=()):
        self._ctx.add_constraint(self, expr, lb, ub, shutdown, name, skip)

    def define_objective(self, expr):
        self._ctx.add_objective(self, expr)

    def define_substitute(self, name, expr):
        if isinstance(expr, list):
            return [self.define_substitute(name + str(l), e)
                    for l, e in enumerate(expr)]
        self._ctx.substitutes[(self.label, name)] = expr
        return expr

    def set_parameters(self, current_time):
        return {self: {}}


class Transcription:
    """The transcribed problem: flat-vector functions + layout metadata."""

    def __init__(self, father, layout: OptiContext, build_fn):
        self.father = father
        self.layout = layout
        self._build_fn = build_fn
        off = 0
        for blk in layout.variables.values():
            blk.offset = off
            off += blk.size
        self.n_x = off
        off = 0
        for blk in layout.parameters.values():
            blk.offset = off
            off += blk.size
        self.n_p = off
        off = 0
        for con in layout.constraints:
            con.offset = off
            off += con.rows
        self.n_g = off
        self.lb = np.concatenate([c.lb for c in layout.constraints]) \
            if layout.constraints else np.zeros(0)
        self.ub = np.concatenate([c.ub for c in layout.constraints]) \
            if layout.constraints else np.zeros(0)
        self._shutdown_cons = [c for c in layout.constraints
                               if c.shutdown is not None]

    # -- differentiable problem functions ----------------------------------
    def _replay(self, x, p):
        ctx = OptiContext("replay", self.layout, x, p)
        self.father._attach(ctx)
        try:
            self._build_fn()
        finally:
            self.father._attach(None)
        return ctx

    def objective(self, x, p):
        obj = self._replay(x, p).objective
        return obj if isinstance(obj, torch.Tensor) else \
            torch.zeros((), dtype=x.dtype, device=x.device) + obj

    def constraints(self, x, p):
        ctx = self._replay(x, p)
        if not ctx.con_values:
            return torch.zeros((0,), dtype=x.dtype, device=x.device)
        return torch.cat(ctx.con_values)

    def objective_and_constraints(self, x, p):
        """(objective, constraints) from one replay."""
        ctx = self._replay(x, p)
        obj = ctx.objective
        if not isinstance(obj, torch.Tensor):
            obj = torch.zeros((), dtype=x.dtype, device=x.device) + obj
        if not ctx.con_values:
            return obj, torch.zeros((0,), dtype=x.dtype, device=x.device)
        return obj, torch.cat(ctx.con_values)

    def bounds(self, t=0.0):
        """(lb, ub) numpy arrays with shutdown masking at host time t."""
        lb = self.lb.copy()
        ub = self.ub.copy()
        for con in self._shutdown_cons:
            if con.shutdown(t):
                sl = slice(con.offset, con.offset + con.rows)
                lb[sl] = -BIG
                ub[sl] = BIG
        return lb, ub

    def relayout(self):
        """Re-run the layout pass to refresh the initial values (the
        straight-line spline guesses and geometric hyperplane warm starts
        follow the current vehicle prediction and obstacle positions).  The
        structure must stay identical; only the blocks' values change."""
        ctx = OptiContext("layout")
        self.father._attach(ctx)
        try:
            self._build_fn()
        finally:
            self.father._attach(None)
        if list(ctx.variables.keys()) != list(self.layout.variables.keys()):
            raise RuntimeError("relayout changed the variable structure")
        for key, blk in ctx.variables.items():
            self.layout.variables[key].value = blk.value

    # -- packing helpers ---------------------------------------------------
    def var_slice(self, child, name):
        blk = self.layout.variables[(child.label, name)]
        return slice(blk.offset, blk.offset + blk.size), blk.shape

    def par_slice(self, child, name):
        blk = self.layout.parameters[(child.label, name)]
        return slice(blk.offset, blk.offset + blk.size), blk.shape

    def initial_guess(self) -> np.ndarray:
        return np.concatenate([blk.value.reshape(-1)
                               for blk in self.layout.variables.values()]) \
            if self.n_x else np.zeros(0)

    def pack_parameters(self, values: Dict) -> np.ndarray:
        """values: {child_object_or_label: {name: array}} -> flat p vector."""
        p = np.zeros(self.n_p)
        norm = {}
        for child, d in values.items():
            label = child if isinstance(child, str) else child.label
            norm.setdefault(label, {}).update(d)
        for (label, name), blk in self.layout.parameters.items():
            if label in norm and name in norm[label]:
                val = np.asarray(norm[label][name], dtype=np.float64)
                if val.size == blk.size:
                    p[blk.offset:blk.offset + blk.size] = val.reshape(-1)
                else:  # scalar broadcast
                    p[blk.offset:blk.offset + blk.size] = float(val)
        return p

    def spline_shift_matrix(self, transform_fn: Callable[[Basis], np.ndarray],
                            only_children: Optional[set] = None,
                            block_filter=None) -> np.ndarray:
        """(n_x, n_x) matrix applying a per-basis coefficient transform to
        every primal spline block.  Non-spline blocks pass through."""
        M = np.eye(self.n_x)
        for blk in self.layout.variables.values():
            if blk.basis is None:
                continue
            if only_children is not None and blk.child not in only_children:
                continue
            if block_filter is not None and not block_filter(blk):
                continue
            T = transform_fn(blk.basis)          # (n, n)
            n, size = blk.shape
            # block layout is (n_coeffs, size) flattened row-major
            E = np.kron(T, np.eye(size))
            sl = slice(blk.offset, blk.offset + blk.size)
            M[sl, sl] = E
        return M


class OptiFather:
    """Stitches children into one transcribed problem."""

    def __init__(self, children: List[OptiChild]):
        self.children = list(children)

    def add(self, child):
        if child not in self.children:
            self.children.append(child)

    def _attach(self, ctx):
        for child in self.children:
            child._ctx = ctx

    def transcribe(self, build_fn) -> Transcription:
        ctx = OptiContext("layout")
        self._attach(ctx)
        try:
            build_fn()
        finally:
            self._attach(None)
        return Transcription(self, ctx, build_fn)

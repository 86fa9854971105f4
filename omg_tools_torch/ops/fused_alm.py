"""The fused ALM inner loop, K3: every inner Newton iteration of one outer
round in one kernel launch (counterpart of ``omg_tools_tpu.ops.fused_alm``,
whose Pallas kernel is ``make_fused_kernel`` -> ``kern``).

Per lane and per iteration the loop evaluates the constraint families
(g, multiplier estimate, Jacobian), assembles the block-arrow Gauss-Newton
system, adds the ridge, factors the tail blocks and the head's Schur
complement, back-substitutes, applies the non-finite fallback and the
max_step cap, and runs the exact-quadratic Armijo search.  The family
kinds (see ``ops/compact.py``):

- ``const``: A shared by all lanes; H = A' diag(d) A is the precomputed
  table P[(r, s), k] = A[k, r] A[k, s] applied to d;
- ``param``: A = A0 + TA pq varies per lane (obstacle states);
- ``quad``:  J = A + 2 Q x, and g = c + (A + Q x) x.

:class:`FusedPlan` is the host part (numpy, float64): the deduplicated
tables of the structure and their flat encoding for the CUDA kernel of
``csrc/fused_alm.cu`` -- an int32 descriptor (families, runs, segments,
table offsets, tail blocks) and, per in-knot phase, one flat buffer holding
every table.  :func:`fused_inner_plain` is the kernel's arithmetic in
PyTorch with a leading batch axis, reading the same flat buffer;
:func:`fused_inner` takes it for CPU tensors and launches the kernel for
CUDA tensors, counting launches in ``fused_inner.launches``.

The kernel and the plain version form Q x and Q dx once per quad family
and iteration: the line search's J dx = A dx + 2 x' Q dx reads the
contraction Q dx, which holds because every Q row is symmetric (a
Hessian; checked when the plan is built).  The Pallas kernel forms Q x a
second and a third time instead.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["FusedPlan", "fused_inner", "fused_inner_plain"]

# descriptor layout, the same names as in csrc/fused_alm.cu, which reports
# its own values through omg_fused_layout; the wrapper checks they agree
MAGIC = 0x4B33
HEADER = 16                    # header length; the tail blocks follow
FAM = 48                       # length of one family record
MAX_RUNS, MAX_SEGS, MAX_Q = 4, 4, 12
# header fields
(H_MAGIC, H_N, H_M, H_NV, H_H0, H_H, H_NB, H_NF, H_C0, H_C1, H_GF, H_PLEN,
 H_JBUF, H_FAM0, H_LEN) = range(15)
# family record fields; runs (start, size), segments (oa, sa, ta, pa) and
# parameter positions from F_RUNS, F_SEGS and F_QPOS
F_KIND, F_ROW, F_MF, F_NF, F_NRUNS, F_NSEGS, F_NQ, F_A, F_TA, F_Q, F_P = \
    range(11)
F_RUNS, F_SEGS, F_QPOS = 12, 20, 36
KIND_CODE = {"const": 0, "param": 1, "quad": 2}
LAYOUT = (MAGIC, HEADER, FAM, MAX_RUNS, MAX_SEGS, MAX_Q, H_LEN, F_P, F_RUNS,
          F_SEGS, F_QPOS)


class _FamPlan(NamedTuple):
    kind: str                 # 'const' | 'param' | 'quad'
    row_start: int
    row_stop: int
    runs: Tuple[Tuple[int, int], ...]
    segs: Tuple[Tuple[int, int, int, int], ...]
    iA: int                   # unique-A table index
    iTA: int                  # unique-TA table index (-1: none)
    iQ: int                   # unique-Qflat table index (-1: none)
    iP: int                   # unique-P table index (-1: non-const)
    qpos: Tuple[int, ...]     # qcols as positions within pcols


def _dedup(arrays):
    """Return (unique_list, index_per_input) by array equality."""
    uniq, idx = [], []
    for a in arrays:
        found = -1
        for j, u in enumerate(uniq):
            if u.shape == a.shape and np.array_equal(u, a):
                found = j
                break
        if found < 0:
            uniq.append(a)
            found = len(uniq) - 1
        idx.append(found)
    return uniq, idx


class FusedPlan:
    """Host-side preparation of the fused kernel's operands for one
    :class:`ops.compact.CompactStructure` with an arrow partition."""

    def __init__(self, struct):
        if struct.arrow is None:
            raise ValueError("the fused kernel needs the arrow partition")
        self.struct = struct
        ar = struct.arrow
        self.head = ar.head
        self.blocks = ar.blocks
        self.n_x = struct.n_x
        self.m = struct.m
        t = struct.tensors
        self.pcols = np.asarray(t["pcols"], dtype=np.int64)
        self.n_v = len(self.pcols)
        self.spk = np.asarray(t["c0"]).shape[0]

        pos_of = {int(c): i for i, c in enumerate(self.pcols)}

        A_for, TA_for, Q_for, P_for = [], [], [], []
        fams: List[_FamPlan] = []
        for i, fam in enumerate(struct.families):
            A0c = np.asarray(t["A0c"][i])          # (spk, m_f, n_f)
            TAc = t["TAc"][i]
            Qc = t["Qc"][i]
            segs = ar.fam_segments[i]
            if Qc is not None:
                kind = "quad"
            elif TAc is not None:
                kind = "param"
            else:
                kind = "const"
            iA = len(A_for)
            A_for.append(A0c)
            iTA = -1
            if TAc is not None:
                iTA = len(TA_for)
                TA_for.append(np.asarray(TAc))
            iQ = -1
            if Qc is not None:
                Qc = np.asarray(Qc)
                if not np.array_equal(Qc, Qc.transpose(0, 2, 1)):
                    raise ValueError(f"family {i}: Q rows are not symmetric")
                m_f, n_f = Qc.shape[0], Qc.shape[1]
                iQ = len(Q_for)
                Q_for.append(np.ascontiguousarray(
                    Qc.reshape(m_f * n_f, n_f)))
            iP = -1
            if kind == "const":
                # P[ph, (r,s), k] = A[ph,k,r] * A[ph,k,s]: H = P @ (d*rho)
                iP = len(P_for)
                P_for.append(np.ascontiguousarray(
                    np.einsum("pkr,pks->prsk", A0c, A0c).reshape(
                        A0c.shape[0], A0c.shape[2] * A0c.shape[2],
                        A0c.shape[1])))
            qpos = tuple(pos_of[int(c)] for c in fam.qcols)
            fams.append(_FamPlan(kind, fam.row_start, fam.row_stop,
                                 fam.runs, segs, iA, iTA, iQ, iP, qpos))

        # dedup unique tensor tables (per-obstacle families share tensors)
        self.uA, a_map = _dedup(A_for)
        self.uTA, ta_map = _dedup(TA_for)
        self.uQ, q_map = _dedup(Q_for)
        self.uP, p_map = _dedup(P_for)
        self.fams = [f._replace(
            iA=a_map[f.iA],
            iTA=-1 if f.iTA < 0 else ta_map[f.iTA],
            iQ=-1 if f.iQ < 0 else q_map[f.iQ],
            iP=-1 if f.iP < 0 else p_map[f.iP]) for f in fams]
        self.c0 = np.asarray(t["c0"])
        self.C1 = np.asarray(t["C1"])
        self.gf = np.asarray(t["gf"])

        # head and tail blocks tile [0, n): dx is written by block offset
        cover = np.zeros(self.n_x, dtype=np.int64)
        for (s, sz) in ((self.head,) + tuple(self.blocks)):
            cover[s:s + sz] += 1
        if not (cover == 1).all():
            raise ValueError("head and tail blocks do not tile the variables")
        # the Schur subtraction order: tail blocks grouped by size, groups
        # in order of first appearance (the Pallas kernel's lane folding)
        sizes = {}
        for bi, (_, sz) in enumerate(self.blocks):
            sizes.setdefault(sz, []).append(bi)
        self.schur_order = tuple(bi for bis in sizes.values() for bi in bis)
        self._layout()

    # -- flat encoding ------------------------------------------------------
    def _layout(self):
        """Float offsets of every table inside one phase's flat buffer
        (each table 16-byte aligned)."""
        size = 0

        def take(count):
            nonlocal size
            at = size
            size += -(-count // 4) * 4
            return at
        self.off_A = [take(a[0].size) for a in self.uA]
        self.off_TA = [take(a[0].size) for a in self.uTA]
        self.off_Q = [take(a.size) for a in self.uQ]
        self.off_P = [take(a[0].size) for a in self.uP]
        self.off_c0 = take(self.m)
        self.off_C1 = take(self.m * self.n_v)
        self.off_gf = take(self.n_x)
        self.phase_len = size

    def phase_tables(self, phase):
        """One phase's flat float64 buffer of every shared table."""
        buf = np.zeros(self.phase_len)

        def put(off, a):
            a = np.asarray(a, dtype=np.float64).ravel()
            buf[off:off + a.size] = a
        for off, a in zip(self.off_A, self.uA):
            put(off, a[phase])
        for off, a in zip(self.off_TA, self.uTA):
            put(off, a[phase])
        for off, a in zip(self.off_Q, self.uQ):
            put(off, a)
        for off, a in zip(self.off_P, self.uP):
            put(off, a[phase])
        put(self.off_c0, self.c0[phase])
        put(self.off_C1, self.C1[phase])
        put(self.off_gf, self.gf[phase])
        return buf

    def tables(self, flat):
        """Views of one phase's flat buffer (a tensor of ``phase_len``):
        dict of uA (m_f, n_f), uTA (m_f, n_f, n_q), uQ (m_f n_f, n_f),
        uP (n_f^2, m_f) lists and c0 (m,), C1 (m, n_v), gf (n,)."""
        def view(off, shape):
            return flat[off:off + int(np.prod(shape))].view(*shape)
        return {
            "uA": [view(o, a.shape[1:]) for o, a in zip(self.off_A, self.uA)],
            "uTA": [view(o, a.shape[1:])
                    for o, a in zip(self.off_TA, self.uTA)],
            "uQ": [view(o, a.shape) for o, a in zip(self.off_Q, self.uQ)],
            "uP": [view(o, a.shape[1:]) for o, a in zip(self.off_P, self.uP)],
            "c0": view(self.off_c0, (self.m,)),
            "C1": view(self.off_C1, (self.m, self.n_v)),
            "gf": view(self.off_gf, (self.n_x,)),
        }

    def descriptor(self):
        """The int32 descriptor the CUDA kernel walks (layout in
        ``csrc/fused_alm.cu``): header, tail blocks (start, size), the
        Schur order, then one fixed-size record per family."""
        nb, nf = len(self.blocks), len(self.fams)
        fam0 = HEADER + 3 * nb
        total = fam0 + FAM * nf
        jbuf = max([(f.row_stop - f.row_start) * sum(z for _, z in f.runs)
                    for f in self.fams if f.kind != "const"] + [1])
        d = np.zeros(total, dtype=np.int32)
        d[:H_LEN + 1] = (MAGIC, self.n_x, self.m, self.n_v, self.head[0],
                         self.head[1], nb, nf, self.off_c0, self.off_C1,
                         self.off_gf, self.phase_len, jbuf, fam0, total)
        for bi, (s, sz) in enumerate(self.blocks):
            d[HEADER + 2 * bi:HEADER + 2 * bi + 2] = (s, sz)
        d[HEADER + 2 * nb:fam0] = self.schur_order
        for fi, f in enumerate(self.fams):
            if (len(f.runs) > MAX_RUNS or len(f.segs) > MAX_SEGS
                    or len(f.qpos) > MAX_Q):
                raise ValueError(f"family {fi} exceeds the descriptor's "
                                 "run/segment/parameter slots")
            rec = d[fam0 + FAM * fi:fam0 + FAM * (fi + 1)]
            rec[:F_P + 1] = (KIND_CODE[f.kind], f.row_start,
                             f.row_stop - f.row_start,
                             sum(z for _, z in f.runs), len(f.runs),
                             len(f.segs), len(f.qpos), self.off_A[f.iA],
                             -1 if f.iTA < 0 else self.off_TA[f.iTA],
                             -1 if f.iQ < 0 else self.off_Q[f.iQ],
                             -1 if f.iP < 0 else self.off_P[f.iP])
            rec[F_RUNS:F_RUNS + 2 * len(f.runs)] = np.ravel(f.runs)
            rec[F_SEGS:F_SEGS + 4 * len(f.segs)] = np.ravel(f.segs)
            rec[F_QPOS:F_QPOS + len(f.qpos)] = f.qpos
        return d

    def shared(self, dtype, device):
        """The kernel's shared operands, built once: ``tables`` (spk,
        phase_len) on ``device``, the descriptor on ``device`` and on the
        host.  Slice one phase with :meth:`slice_phase`."""
        desc = self.descriptor()
        tables = np.stack([self.phase_tables(ph) for ph in range(self.spk)])
        return {"tables": torch.as_tensor(tables, dtype=dtype, device=device),
                "desc": torch.as_tensor(desc, device=device),
                "desc_host": desc}

    @staticmethod
    def slice_phase(shared, phase):
        """The operands of one in-knot phase (a host int)."""
        return dict(shared, tables=shared["tables"][phase])


# -- the plain version ------------------------------------------------------

def _gather(v, runs):
    if len(runs) == 1:
        s, sz = runs[0]
        return v[:, s:s + sz]
    return torch.cat([v[:, s:s + sz] for (s, sz) in runs], dim=1)


def _chol_(L):
    """In-place right-looking Cholesky of L (..., n, n); the lower triangle
    holds the factor (the Pallas kernel's ``_masked_chol``)."""
    n = L.shape[-1]
    for j in range(n):
        inv = torch.rsqrt(L[..., j, j])
        L[..., j:, j] *= inv[..., None]
        s = L[..., j + 1:, j]
        L[..., j + 1:, j + 1:] -= s[..., :, None] * s[..., None, :]


def _fwd_(L, M):
    """In place M <- L^-1 M for M (..., n, r)."""
    for i in range(L.shape[-1]):
        acc = (L[..., i, :i, None] * M[..., :i, :]).sum(-2)
        M[..., i, :] = (M[..., i, :] - acc) / L[..., i, i, None]


def _bwd_(L, M):
    """In place M <- L'^-1 M for M (..., n, r)."""
    n = L.shape[-1]
    for i in range(n - 1, -1, -1):
        acc = (L[..., i + 1:, i, None] * M[..., i + 1:, :]).sum(-2)
        M[..., i, :] = (M[..., i, :] - acc) / L[..., i, i, None]


def _seg_start(plan, ta, pa):
    """Variable index of local offset ``pa`` in target ``ta`` (-1: head)."""
    return (plan.head[0] if ta < 0 else plan.blocks[ta][0]) + pa


def fused_inner_plain(plan, fs, x, lam, rho, pv, lb, ub, opt, n_inner):
    """K3's arithmetic in PyTorch.  ``fs``: one phase's shared operands
    (:meth:`FusedPlan.slice_phase`); x (B, n), lam (B, m), rho (B,),
    pv (B, n_v); lb/ub (m,) scaled and in compact row order; ``opt`` an
    ``ALMOptions``.  Returns (x, gv, stat): the iterate after ``n_inner``
    iterations, g at it, and the last iteration's gradient inf-norm."""
    tb = plan.tables(fs["tables"])
    B, n = x.shape
    m = plan.m
    dt, dev = x.dtype, x.device
    h0, h = plan.head
    rho_c = rho[:, None]
    cv = tb["c0"] + pv @ tb["C1"].T                 # resolved constants
    lor = lam / rho_c
    zero = torch.zeros((), dtype=dt, device=dev)
    A_of = []
    for f in plan.fams:
        A = tb["uA"][f.iA]
        if f.iTA >= 0:
            pq = pv[:, list(f.qpos)]
            A = A + torch.einsum("rjq,bq->brj", tb["uTA"][f.iTA], pq)
        elif f.kind != "const":
            A = A.expand(B, *A.shape)
        A_of.append(A)
    stat = None
    for _ in range(n_inner):
        # -- constraint values, multiplier estimate, arrow-system assembly
        gv = torch.empty((B, m), dtype=dt, device=dev)
        grad = tb["gf"].expand(B, n).clone()
        S = torch.zeros((B, h, h), dtype=dt, device=dev)
        D = [torch.zeros((B, sz, sz), dtype=dt, device=dev)
             for (_, sz) in plan.blocks]
        M = [torch.zeros((B, sz, h + 2), dtype=dt, device=dev)
             for (_, sz) in plan.blocks]
        for f, A in zip(plan.fams, A_of):
            rows = slice(f.row_start, f.row_stop)
            xf = _gather(x, f.runs)
            if f.kind == "const":
                g_rows = cv[:, rows] + xf @ A.T
            elif f.iQ >= 0:
                m_f, n_f = A.shape[1], A.shape[2]
                t1 = (xf @ tb["uQ"][f.iQ].T).view(B, m_f, n_f)
                g_rows = cv[:, rows] + ((A + t1) * xf[:, None, :]).sum(-1)
                J = A + 2.0 * t1
            else:
                g_rows = cv[:, rows] + (A * xf[:, None, :]).sum(-1)
                J = A
            r = g_rows + lor[:, rows]
            y = rho_c * (r - torch.clamp(r, lb[rows], ub[rows]))
            d = torch.where(y.abs() > 0.0, rho_c, zero)
            gv[:, rows] = g_rows
            n_f = xf.shape[1]
            if f.kind == "const":
                g_f = y @ A
                H = (d @ tb["uP"][f.iP].T).view(B, n_f, n_f)
            else:
                g_f = (J * y[:, :, None]).sum(1)
                H = torch.einsum("bkr,bks->brs", J * d[:, :, None], J)
            for (oa, sa, ta, pa) in f.segs:
                s = _seg_start(plan, ta, pa)
                grad[:, s:s + sa] += g_f[:, oa:oa + sa]
                for (ob, sb, tb_, pb) in f.segs:
                    if ta >= 0 and tb_ < 0:
                        continue                   # mirror of (head, block)
                    if ta < 0 and tb_ < 0:
                        S[:, pa:pa + sa, pb:pb + sb] += H[:, oa:oa + sa,
                                                          ob:ob + sb]
                    elif ta < 0:                   # C' kept pre-transposed
                        M[tb_][:, pb:pb + sb, pa:pa + sa] += \
                            H[:, ob:ob + sb, oa:oa + sa]
                    else:
                        D[ta][:, pa:pa + sa, pb:pb + sb] += H[:, oa:oa + sa,
                                                              ob:ob + sb]
        r_h = grad[:, h0:h0 + h].clone()
        for bi, (s, sz) in enumerate(plan.blocks):
            M[bi][:, :, h] = grad[:, s:s + sz]

        # -- ridge --------------------------------------------------------
        dmax = S.diagonal(dim1=-2, dim2=-1).abs().amax(-1)
        for Db in D:
            dmax = torch.maximum(
                dmax, Db.diagonal(dim1=-2, dim2=-1).abs().amax(-1))
        ridge = opt.gn_delta_rel * torch.clamp(dmax, min=1.0) + opt.delta
        S.diagonal(dim1=-2, dim2=-1).add_(ridge[:, None])
        for Db in D:
            Db.diagonal(dim1=-2, dim2=-1).add_(ridge[:, None])

        # -- tail factors, Y = L^-1 [C' | r_b], Schur complement ----------
        for bi in plan.schur_order:
            _chol_(D[bi])
            _fwd_(D[bi], M[bi][:, :, :h + 1])
            Y = M[bi]
            G = torch.einsum("bkr,bkc->brc", Y[:, :, :h], Y[:, :, :h + 1])
            S = S - G[:, :, :h]
            r_h = r_h - G[:, :, h]

        # -- head solve, back-substitution ---------------------------------
        _chol_(S)
        W = r_h[:, :, None].clone()
        _fwd_(S, W)
        _bwd_(S, W)
        dx_h = W[:, :, 0]
        dx = torch.empty((B, n), dtype=dt, device=dev)
        dx[:, h0:h0 + h] = -dx_h
        for bi, (s, sz) in enumerate(plan.blocks):
            Y = M[bi]
            Y[:, :, h + 1] = Y[:, :, h] - (Y[:, :, :h]
                                           * dx_h[:, None, :]).sum(-1)
            _bwd_(D[bi], Y[:, :, h + 1:h + 2])
            dx[:, s:s + sz] = -Y[:, :, h + 1]

        # -- non-finite fallback, trust region -----------------------------
        finite = torch.isfinite(dx).all(-1, keepdim=True)
        gnorm = torch.sqrt((grad * grad).sum(-1, keepdim=True))
        dx = torch.where(finite, dx, -grad / torch.clamp(gnorm, min=1.0))
        dx_norm = dx.abs().amax(-1, keepdim=True)
        dx = dx * torch.clamp(opt.max_step / torch.clamp(dx_norm, min=1e-12),
                              max=1.0)

        # -- exact-quadratic Armijo line search ----------------------------
        slope = (grad * dx).sum(-1)
        Jd = torch.empty((B, m), dtype=dt, device=dev)
        qd = torch.zeros((B, m), dtype=dt, device=dev)
        for f, A in zip(plan.fams, A_of):
            rows = slice(f.row_start, f.row_stop)
            df = _gather(dx, f.runs)
            if f.kind == "const":
                Jd[:, rows] = df @ A.T
            elif f.iQ >= 0:
                m_f, n_f = A.shape[1], A.shape[2]
                t2 = (df @ tb["uQ"][f.iQ].T).view(B, m_f, n_f)
                xf = _gather(x, f.runs)
                # J dx = A dx + 2 x' Q dx (Q rows symmetric)
                Jd[:, rows] = (A * df[:, None, :]
                               + 2.0 * xf[:, None, :] * t2).sum(-1)
                qd[:, rows] = (t2 * df[:, None, :]).sum(-1)
            else:
                Jd[:, rows] = (A * df[:, None, :]).sum(-1)
        df_obj = dx @ tb["gf"]

        def penalty(g):
            rr = g + lor
            return 0.5 * rho * ((rr - torch.clamp(rr, lb, ub)) ** 2).sum(-1)

        m0 = penalty(gv)           # f0 + gf.x cancels in the comparison
        alpha = torch.zeros((B,), dtype=dt, device=dev)
        found = torch.zeros((B,), dtype=torch.bool, device=dev)
        for a in opt.ls_candidates:
            a = float(a)
            mv = a * df_obj + penalty(gv + a * Jd + (a * a) * qd)
            ok = torch.isfinite(mv) & (mv <= m0 + (opt.armijo * a) * slope)
            alpha = torch.where(ok & ~found, torch.full_like(alpha, a), alpha)
            found = found | ok
        x = x + alpha[:, None] * dx
        gv = gv + alpha[:, None] * Jd + (alpha * alpha)[:, None] * qd
        stat = grad.abs().amax(-1)
    return x, gv, stat


# -- the wrapper ------------------------------------------------------------

def _load():
    """The kernel's library, once its descriptor layout is checked against
    this module's."""
    lib = _build.load("fused_alm")
    if not getattr(lib, "layout_checked", False):
        got = np.zeros(len(LAYOUT), dtype=np.int32)
        lib.omg_fused_layout(got.ctypes.data, len(LAYOUT))
        if tuple(got) != LAYOUT:
            raise RuntimeError(f"csrc/fused_alm.cu lays the descriptor out "
                               f"as {tuple(got)}, this module as {LAYOUT}")
        lib.layout_checked = True
    return lib


def _check(named, device):
    for name, t in named:
        if t.device != device:
            raise ValueError(f"{name} lies on {t.device}, not {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_inner(plan, fs, x, lam, rho, pv, lb, ub, opt, n_inner):
    """``n_inner`` fused ALM inner iterations for a batch of lanes (the
    arguments of :func:`fused_inner_plain`).  CPU tensors take the plain
    version; CUDA float32 tensors launch K3; anything else raises."""
    named = (("x", x), ("lam", lam), ("rho", rho), ("pv", pv), ("lb", lb),
             ("ub", ub), ("tables", fs["tables"]))
    if all(t.device.type == "cpu" for _, t in named):
        return fused_inner_plain(plan, fs, x, lam, rho, pv, lb, ub, opt,
                                 n_inner)
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    _check(named, x.device)
    B = x.shape[0]
    n, m, n_v = plan.n_x, plan.m, plan.n_v
    want = {"x": (B, n), "lam": (B, m), "rho": (B,), "pv": (B, n_v),
            "lb": (m,), "ub": (m,), "tables": (plan.phase_len,)}
    for name, t in named:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
    desc, desc_host = fs["desc"], np.ascontiguousarray(fs["desc_host"],
                                                       dtype=np.int32)
    if desc.device != x.device or desc.dtype != torch.int32 \
            or desc.numel() != desc_host.size:
        raise ValueError("the descriptor must be the plan's int32 "
                         "descriptor on the lanes' device")
    x_out = torch.empty_like(x)
    gv = torch.empty((B, m), dtype=x.dtype, device=x.device)
    stat = torch.empty((B,), dtype=x.dtype, device=x.device)
    if B == 0:
        return x_out, gv, stat
    opts = np.asarray([opt.armijo, opt.max_step, opt.gn_delta_rel,
                       opt.delta, *opt.ls_candidates], dtype=np.float64)
    lib = _load()
    err = lib.omg_fused_inner_f32(
        desc_host.ctypes.data, desc.data_ptr(), fs["tables"].data_ptr(),
        lb.data_ptr(), ub.data_ptr(), x.data_ptr(), lam.data_ptr(),
        rho.data_ptr(), pv.data_ptr(), opts.ctypes.data,
        len(opt.ls_candidates), x_out.data_ptr(), gv.data_ptr(),
        stat.data_ptr(), B, int(n_inner),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_alm kernel launch failed (cudaError {err})")
    fused_inner.launches += 1
    return x_out, gv, stat


fused_inner.launches = 0

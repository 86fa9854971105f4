"""Family-compacted constraint evaluation for the batched ALM solver
(counterpart of ``omg_tools_tpu.ops.compact``).

Spline MPC transcriptions are very sparse: every constraint row touches
only the few coefficients inside one basis-function support.  This module
compacts the structure once at setup (host, float64 numpy):

- constraint rows are grouped into **families** -- transcription constraint
  blocks merged when they share the same variable support -- and globally
  re-ordered so each family is a contiguous row slice;
- each family's variable support is covered by a few contiguous **runs** of
  the variable vector, so gathers/scatters are static slices;
- per family the affine/quadratic tensors are compacted to the support:
  A0c (spk, m_f, n_f), TAc (spk, m_f, n_f, n_qf), Qc (m_f, n_f, n_f);
- :func:`detect_arrow` finds the block-arrow partition (head = vehicle
  splines, pairwise-uncoupled tail blocks) the Newton step factors by.

At run time :class:`CompactWork` evaluates J, g, the gradient, the
Gauss-Newton system (dense, or block-arrow) and the line-search terms
family by family.  Unlike
the JAX module (written per scenario and lifted by ``vmap``), every runtime
method here takes tensors with an explicit leading batch axis B.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["CompactStructure", "build_compact", "detect_arrow",
           "resolve_phase", "CompactWork"]


class FamilyStatic(NamedTuple):
    """Static description of one constraint family."""
    row_start: int          # rows in PERMUTED row space
    row_stop: int
    runs: Tuple[Tuple[int, int], ...]   # (start, size) variable runs
    qcols: Tuple[int, ...]  # parameter columns entering A (empty: constant)
    has_Q: bool


class ArrowStatic(NamedTuple):
    """Block-arrow partition of the variable space (see ``detect_arrow``).

    head: (start, size) -- the coupling variable block (vehicle splines);
    blocks: ((start, size), ...) -- pairwise-uncoupled tail blocks;
    fam_segments: per family, a tuple of
        (fam_col_off, size, target, tgt_off) segments mapping the family's
        LOCAL column range [fam_col_off, fam_col_off+size) to target -1
        (head, local offset tgt_off) or block index >= 0 (local tgt_off).
    """
    head: Tuple[int, int]
    blocks: Tuple[Tuple[int, int], ...]
    fam_segments: Tuple[Tuple[Tuple[int, int, int, int], ...], ...]
    fam_block: Tuple[int, ...]   # the single block each family touches (-1: none)
    b_max: int                   # padded tail-block size


class CompactStructure:
    """Host-side compacted problem structure.

    ``tensors`` (host numpy, leading phase axis where applicable):
      c0 (spk, m), C1 (spk, m, n_pc), f0 (spk,), gf (spk, n) -- full-row
      constants in permuted row order, row/objective scaling baked in;
      pcols (n_pc,) the full-p columns C1 is restricted to;
      per family: A0c, TAc (or None), Qc (or None).
    """

    def __init__(self, families: List[FamilyStatic], row_perm: np.ndarray,
                 tensors: dict, n_x: int, n_p: int,
                 arrow: Optional[ArrowStatic] = None):
        self.families = families
        self.row_perm = np.asarray(row_perm)
        self.inv_perm = np.argsort(self.row_perm)
        self.tensors = tensors
        self.n_x = n_x
        self.n_p = n_p
        self.m = len(self.row_perm)
        self.arrow = arrow

    def device_tensors(self, dtype, device):
        """The tensors resolve_phase needs, on ``device``."""
        t = self.tensors

        def dev(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a), dtype=dtype, device=device)

        def idx(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=device)

        fams = tuple((dev(t["A0c"][k]), dev(t["TAc"][k]), dev(t["Qc"][k]),
                      idx(fam.qcols))
                     for k, fam in enumerate(self.families))
        return {"c0": dev(t["c0"]), "C1": dev(t["C1"]), "f0": dev(t["f0"]),
                "gf": dev(t["gf"]),
                "pcols": idx(t.get("pcols", np.arange(t["C1"].shape[-1]))),
                "fams": fams}


def _runs_from_support(cols: np.ndarray, gap: int = 8,
                       n: Optional[int] = None):
    """Cover a sorted index set by contiguous runs, merging gaps <= gap."""
    cols = np.unique(cols)
    if len(cols) == 0:
        return ((0, 0),)
    runs = []
    start = prev = int(cols[0])
    for c in cols[1:]:
        c = int(c)
        if c - prev <= gap:
            prev = c
            continue
        runs.append((start, prev - start + 1))
        start = prev = c
    runs.append((start, prev - start + 1))
    if n is not None:
        runs = [(s, min(sz, n - s)) for (s, sz) in runs]
    return tuple(runs)


def detect_arrow(families: List[FamilyStatic], n: int,
                 head: Tuple[int, int]) -> Optional[ArrowStatic]:
    """Detect a block-arrow partition of the variable space.

    ``head`` is the coupling block (the vehicle spline coefficients).  The
    remaining variables split into tail blocks that are pairwise uncoupled:
    each family's support must lie inside head + (at most) one tail block.
    Returns None when the structure does not hold."""
    h0, h1 = head[0], head[0] + head[1]

    def split_interval(s, e):
        """Split [s, e) at the head boundaries -> (lo, head-part, hi)."""
        parts = []
        if s < h0:
            parts.append((s, min(e, h0), False))
        if max(s, h0) < min(e, h1):
            parts.append((max(s, h0), min(e, h1), True))
        if e > h1:
            parts.append((max(s, h1), e, False))
        return parts

    fam_tail: List[List[Tuple[int, int]]] = []
    for fam in families:
        tails = []
        for (s, sz) in fam.runs:
            for (a, b, in_head) in split_interval(s, s + sz):
                if not in_head and b > a:
                    tails.append((a, b))
        fam_tail.append(tails)

    # union-find over tail intervals: intervals of one family merge; then
    # overlapping intervals across families merge
    intervals = []
    owner = []
    for fi, tails in enumerate(fam_tail):
        for (a, b) in tails:
            intervals.append([a, b])
            owner.append(fi)
    parent = list(range(len(intervals)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(i, j):
        parent[find(i)] = find(j)

    for i in range(len(intervals)):
        for j in range(i + 1, len(intervals)):
            same_family = owner[i] == owner[j]
            overlap = (intervals[i][0] < intervals[j][1]
                       and intervals[j][0] < intervals[i][1])
            if same_family or overlap:
                union(i, j)
    groups: dict = {}
    for i in range(len(intervals)):
        groups.setdefault(find(i), []).append(i)

    blocks = []
    for members in groups.values():
        lo = min(intervals[i][0] for i in members)
        hi = max(intervals[i][1] for i in members)
        blocks.append((lo, hi))
    blocks.sort()
    merged = []
    for (lo, hi) in blocks:
        if merged and lo < merged[-1][1]:
            merged[-1] = (merged[-1][0], max(hi, merged[-1][1]))
        else:
            merged.append((lo, hi))
    blocks = merged
    # leftover variables untouched by any family -> own blocks (diag-only)
    covered = np.zeros(n, dtype=bool)
    covered[h0:h1] = True
    for (lo, hi) in blocks:
        if lo < h1 and hi > h0:
            return None    # block overlaps head: not arrow
        covered[lo:hi] = True
    i = 0
    while i < n:
        if not covered[i]:
            j = i
            while j < n and not covered[j]:
                j += 1
            blocks.append((i, j))
            i = j
        else:
            i += 1
    blocks.sort()
    if not blocks:
        return None

    def block_of(a, b):
        for bi, (lo, hi) in enumerate(blocks):
            if a >= lo and b <= hi:
                return bi
        return None

    fam_segments = []
    fam_block = []
    for fam, tails in zip(families, fam_tail):
        segs = []
        blk = -1
        off = 0
        ok = True
        for (s, sz) in fam.runs:
            for (a, b, in_head) in split_interval(s, s + sz):
                if b <= a:
                    continue
                if in_head:
                    segs.append((off, b - a, -1, a - h0))
                else:
                    bi = block_of(a, b)
                    if bi is None or (blk not in (-1, bi)):
                        ok = False
                        break
                    blk = bi
                    segs.append((off, b - a, bi, a - blocks[bi][0]))
                off += b - a
            if not ok:
                break
        if not ok:
            return None
        fam_segments.append(tuple(segs))
        fam_block.append(blk)

    b_max = max(hi - lo for (lo, hi) in blocks)
    return ArrowStatic(
        head=(h0, h1 - h0),
        blocks=tuple((lo, hi - lo) for (lo, hi) in blocks),
        fam_segments=tuple(fam_segments),
        fam_block=tuple(fam_block),
        b_max=int(b_max))


def build_compact(con_blocks, Q, c0, C1, A0, TA, f0, gf,
                  row_scale=None, obj_scale=1.0, gap=8,
                  tol=1e-12, head=None, p_cols=None) -> CompactStructure:
    """Build the compacted structure from dense host tensors.

    con_blocks: [(offset, rows)] from the transcription layout.
    Q: (m, n, n) or None; c0/C1/A0/TA with leading phase axis (spk, ...);
    TA may be None (A constant in p).  p_cols: full-p indices of the
    columns C1/TA are restricted to; default = all of p.
    """
    A0 = np.asarray(A0)
    spk, m, n = A0.shape
    n_pc = np.asarray(C1).shape[-1]
    p_cols = np.arange(n_pc) if p_cols is None else np.asarray(p_cols)
    n_p = int(p_cols.max()) + 1 if len(p_cols) else 0
    Q = None if Q is None else np.asarray(Q)
    TA = None if TA is None else np.asarray(TA)

    # -- per-block supports -------------------------------------------------
    blocks = []
    for (off, rows) in con_blocks:
        rr = np.arange(off, off + rows)
        sup = np.zeros(n, dtype=bool)
        sup |= (np.abs(A0[:, rr, :]) > tol).any(axis=(0, 1))
        if TA is not None:
            sup |= (np.abs(TA[:, rr, :, :]) > tol).any(axis=(0, 1, 3))
        if Q is not None:
            qs = (np.abs(Q[rr]) > tol)
            sup |= qs.any(axis=(0, 2)) | qs.any(axis=(0, 1))
        runs = _runs_from_support(np.where(sup)[0], gap=gap, n=n)
        blocks.append((off, rows, runs))

    # -- merge blocks sharing a run signature into families -----------------
    fam_map = {}
    for off, rows, runs in blocks:
        fam_map.setdefault(runs, []).append((off, rows))
    families_rows = []
    for runs, members in fam_map.items():
        rr = np.concatenate([np.arange(o, o + r) for (o, r) in members])
        families_rows.append((runs, np.sort(rr)))

    # -- global row permutation ---------------------------------------------
    row_perm = np.concatenate([rr for (_, rr) in families_rows]) \
        if families_rows else np.zeros(0, dtype=int)
    if len(row_perm) != m:
        raise ValueError(f"families cover {len(row_perm)} of {m} rows")

    d = np.ones(m) if row_scale is None else np.asarray(row_scale)

    c0p = (c0 * d[None, :])[:, row_perm]
    C1p = (C1 * d[None, :, None])[:, row_perm, :]
    f0s = np.asarray(f0) * obj_scale
    gfs = np.asarray(gf) * obj_scale

    families: List[FamilyStatic] = []
    A0c_list, TAc_list, Qc_list = [], [], []
    row_off = 0
    for runs, rr in families_rows:
        cols = np.concatenate([np.arange(s, s + sz) for (s, sz) in runs])
        m_f = len(rr)
        drr = d[rr]
        A0c = (A0[:, rr, :] * drr[None, :, None])[:, :, cols]
        TAc = None
        if TA is not None:
            TAf = TA[:, rr, :, :][:, :, cols, :] * drr[None, :, None, None]
            qnz = np.where((np.abs(TAf) > tol).any(axis=(0, 1, 2)))[0]
            if len(qnz):
                TAc = np.ascontiguousarray(TAf[:, :, :, qnz])
        else:
            qnz = np.zeros(0, dtype=int)
        Qc = None
        if Q is not None:
            Qf = Q[rr] * drr[:, None, None]
            if (np.abs(Qf) > tol).any():
                Qc = np.ascontiguousarray(Qf[:, cols, :][:, :, cols])
        families.append(FamilyStatic(
            row_start=row_off, row_stop=row_off + m_f, runs=runs,
            qcols=tuple(int(p_cols[q])
                        for q in (qnz if TAc is not None else ())),
            has_Q=Qc is not None))
        A0c_list.append(A0c)
        TAc_list.append(TAc)
        Qc_list.append(Qc)
        row_off += m_f

    tensors = {"c0": c0p, "C1": C1p, "f0": f0s, "gf": gfs,
               "pcols": np.asarray(p_cols, dtype=np.int32),
               "A0c": A0c_list, "TAc": TAc_list, "Qc": Qc_list}
    arrow = None
    if head is not None:
        arrow = detect_arrow(families, n, head)
    return CompactStructure(families, row_perm, tensors, n_x=n, n_p=n_p,
                            arrow=arrow)


# -- runtime -----------------------------------------------------------------

def resolve_phase(struct: CompactStructure, dt_tensors, phase: int, p):
    """Phase- and parameter-resolved per-solve tensors for a batch of
    parameter vectors p (B, n_p).  ``phase`` is a host int.  Returns the
    ``ct`` argument of the compact ALM evaluator: full-row constants c
    (B, m) plus per-family A matrices (B, m_f, n_f)."""
    B = p.shape[0]
    c = dt_tensors["c0"][phase] \
        + p[:, dt_tensors["pcols"]] @ dt_tensors["C1"][phase].T
    Af, Qf = [], []
    for A0c, TAc, Qc, qsel in dt_tensors["fams"]:
        A = A0c[phase]
        if TAc is not None:
            A = A + torch.einsum("rtq,bq->brt", TAc[phase], p[:, qsel])
        else:
            A = A.expand(B, *A.shape)
        Af.append(A)
        Qf.append(Qc)
    return {"c": c, "f0": dt_tensors["f0"][phase],
            "gf": dt_tensors["gf"][phase], "Af": tuple(Af), "Qf": tuple(Qf)}


class CompactWork:
    """Evaluator bound to (static structure, resolved tensors).

    Every method takes and returns tensors with a leading batch axis B;
    every gather/scatter is a static slice.
    """

    def __init__(self, struct: CompactStructure, ct):
        self.struct = struct
        self.ct = ct

    # -- pieces --------------------------------------------------------------
    def _xf(self, x, fam: FamilyStatic):
        if len(fam.runs) == 1:
            s, sz = fam.runs[0]
            return x[:, s:s + sz]
        return torch.cat([x[:, s:s + sz] for (s, sz) in fam.runs], dim=1)

    def _rows(self, vec, fam: FamilyStatic):
        return vec[:, fam.row_start:fam.row_stop]

    def jacobians(self, x):
        """Per-family J_f (B, m_f, n_f)."""
        Jf = []
        for fam, A, Qc in zip(self.struct.families, self.ct["Af"],
                              self.ct["Qf"]):
            if Qc is not None:
                A = A + 2.0 * torch.einsum("krt,bt->bkr", Qc,
                                           self._xf(x, fam))
            Jf.append(A)
        return Jf

    def g_from_J(self, x, Jf):
        """g (B, m) in permuted row order: c + 0.5 (A + J) x per family."""
        parts = []
        for fam, A, J in zip(self.struct.families, self.ct["Af"], Jf):
            xf = self._xf(x, fam)
            parts.append(0.5 * ((A + J) @ xf[:, :, None])[:, :, 0])
        return self.ct["c"] + torch.cat(parts, dim=1)

    def g(self, x):
        return self.g_from_J(x, self.jacobians(x))

    def f(self, x):
        return self.ct["f0"] + x @ self.ct["gf"]

    def gf(self, x):
        return self.ct["gf"]

    def grad(self, Jf, y):
        """gf + J'y (B, n) by per-family slice adds."""
        out = self.ct["gf"].expand(Jf[0].shape[0], -1).clone()
        for fam, J in zip(self.struct.families, Jf):
            gfam = (J.transpose(1, 2) @ self._rows(y, fam)[:, :, None])[
                :, :, 0]                                 # (B, n_f)
            off = 0
            for (s, sz) in fam.runs:
                out[:, s:s + sz] += gfam[:, off:off + sz]
                off += sz
        return out

    def hessian(self, Jf, active, rho, ridge):
        """rho J'DJ + ridge I (B, n, n) by family-block slice adds (the
        compact mode without an arrow partition)."""
        n = self.struct.n_x
        J0 = Jf[0]
        H = ridge * torch.eye(n, dtype=J0.dtype, device=J0.device).expand(
            J0.shape[0], n, n).clone()
        for fam, J in zip(self.struct.families, Jf):
            d = self._rows(active, fam) * rho[:, None]
            Hf = J.transpose(1, 2) @ (d[:, :, None] * J)    # (B, n_f, n_f)
            oa = 0
            for (sa, sza) in fam.runs:
                ob = 0
                for (sb, szb) in fam.runs:
                    H[:, sa:sa + sza, sb:sb + szb] += \
                        Hf[:, oa:oa + sza, ob:ob + szb]
                    ob += szb
                oa += sza
        return H

    def arrow_system(self, Jf, y, active, rho):
        """Assemble the block-arrow Gauss-Newton system in block form:
            S (B, h, h), D (B, k, b, b), C (B, k, h, b), r_h (B, h),
            r_b (B, k, b)
        where [S, C; C', blockdiag(D)] [dx_h; dx_b] = [r_h; r_b] is the
        (unregularized) Newton system and r is the full gradient gf + J'y.
        Tail blocks are padded to b_max with unit diagonal."""
        ar = self.struct.arrow
        h0, h = ar.head
        k = len(ar.blocks)
        bm = ar.b_max
        J0 = Jf[0]
        B, dt, dev = J0.shape[0], J0.dtype, J0.device
        S = torch.zeros((B, h, h), dtype=dt, device=dev)
        D = torch.zeros((B, k, bm, bm), dtype=dt, device=dev)
        C = torch.zeros((B, k, h, bm), dtype=dt, device=dev)
        gf = self.ct["gf"]
        r_h = gf[h0:h0 + h].expand(B, h).clone()
        r_b = torch.zeros((B, k, bm), dtype=dt, device=dev)
        for bi, (s, sz) in enumerate(ar.blocks):
            r_b[:, bi, :sz] = gf[s:s + sz]
        for fam, segs, J in zip(self.struct.families, ar.fam_segments, Jf):
            yv = self._rows(y, fam)
            d = self._rows(active, fam) * rho[:, None]
            g_f = (J.transpose(1, 2) @ yv[:, :, None])[:, :, 0]    # (B, n_f)
            H_f = J.transpose(1, 2) @ (d[:, :, None] * J)         # (B, n_f, n_f)
            for (oa, sa, ta, pa) in segs:
                gseg = g_f[:, oa:oa + sa]
                if ta < 0:
                    r_h[:, pa:pa + sa] += gseg
                else:
                    r_b[:, ta, pa:pa + sa] += gseg
                for (ob, sb, tb, pb) in segs:
                    if ta >= 0 and tb < 0:
                        continue      # transpose of a (head, block) pair
                    blk = H_f[:, oa:oa + sa, ob:ob + sb]
                    if ta < 0 and tb < 0:
                        S[:, pa:pa + sa, pb:pb + sb] += blk
                    elif ta < 0:
                        C[:, tb, pa:pa + sa, pb:pb + sb] += blk
                    else:
                        D[:, ta, pa:pa + sa, pb:pb + sb] += blk
        # pad diagonals of the tail blocks stay positive definite
        for bi, (s, sz) in enumerate(ar.blocks):
            if sz < bm:
                D[:, bi].diagonal(dim1=-2, dim2=-1)[:, sz:] += 1.0
        return S, D, C, r_h, r_b

    def arrow_scatter(self, dx_h, dx_b):
        """Reassemble the full dx (B, n) from head/block pieces."""
        ar = self.struct.arrow
        h0, h = ar.head
        dx = torch.zeros((dx_h.shape[0], self.struct.n_x), dtype=dx_h.dtype,
                         device=dx_h.device)
        dx[:, h0:h0 + h] = dx_h
        for bi, (s, sz) in enumerate(ar.blocks):
            dx[:, s:s + sz] = dx_b[:, bi, :sz]
        return dx

    def Jd(self, Jf, dx):
        """J dx (B, m) for the line search."""
        return torch.cat([(J @ self._xf(dx, fam)[:, :, None])[:, :, 0]
                          for fam, J in zip(self.struct.families, Jf)],
                         dim=1)

    def quad_dir(self, dx):
        """d' Q d (B, m) for the exact quadratic line search."""
        parts = []
        B = dx.shape[0]
        for fam, Qc in zip(self.struct.families, self.ct["Qf"]):
            if Qc is None:
                parts.append(torch.zeros((B, fam.row_stop - fam.row_start),
                                         dtype=dx.dtype, device=dx.device))
            else:
                df = self._xf(dx, fam)
                parts.append(torch.einsum("krt,br,bt->bk", Qc, df, df))
        return torch.cat(parts, dim=1)

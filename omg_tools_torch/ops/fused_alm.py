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
dense tables of the structure, which :func:`fused_inner_plain` reads (one
flat buffer per in-knot phase), and their compressed encoding for the CUDA
kernel of ``csrc/fused_alm.cu``, which never sees the dense tables:

- an int32 descriptor (:meth:`FusedPlan.descriptor`, phase-independent):
  the header, the tail blocks and their place in each lane's shared
  memory, and every index list;
- per phase, one float buffer of the values at the same positions
  (:meth:`FusedPlan.phase_values`).

Every list is *sliced*: items (rows, J entries, variables, Gauss-Newton
targets) go in slices of 32, one warp's threads, and entry ``j`` of item
``i`` lies at ``off[i] + 32 j`` with ``off[i] = base(slice) + i % 32``,
so that a warp reads 32 consecutive words at each step.  The lists:

- rows: J's non-zero pattern per row (the union over phases of A, TA and
  Q), each entry a J position ``p`` with its variable, A0 value, the TA
  sub-list (parameter slot, value) and the Q sub-list (variable, value):
  J[p] = A0 + TA pq + 2 (Q x)[p]; and per row its C1 sub-list;
- gradient: per variable, the J positions in its column (J' y);
- Gauss-Newton: per hit entry of S, D (lower triangles) and C', the
  pairs (u, v) of J positions of one row whose product d J[u] J[v] it
  sums, in family and row order; no atomics.  The const families' H =
  A' diag(d) A is formed the same way from A's row non-zeros (A is
  1-2 % of the dense P table's size and needs no second code path), so
  P is not encoded.

:func:`fused_inner` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors, counting launches in ``fused_inner.launches``.
The plain version forms Q x and Q dx once per quad family and iteration:
the line search's J dx = A dx + 2 x' Q dx reads the contraction Q dx,
which holds because every Q row is symmetric.  A Q row is a Hessian, and
the one that host AD detects is symmetric to rounding only, so the plan
takes 0.5 (Q + Q') and refuses a Q whose asymmetry exceeds rounding
(``Q_SYM_RTOL``).  The kernel forms J dx from J itself, the same quantity.

:meth:`FusedPlan.kernel_refusal` says whether K3 takes a plan (its sizes
and the card's shared memory); the batched runner asks it before it
picks the fused structure.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["FusedPlan", "fused_inner", "fused_inner_plain",
           "lanes_per_block"]

# descriptor layout, the same names as in csrc/fused_alm.cu, which reports
# its own values through omg_fused_layout; the wrapper checks they agree
MAGIC = 0x4B34
HEADER = 48                    # header length; the tail blocks follow
SLICE = 32                     # items per slice of a sliced list
MAX_BLOCKS, MAX_LANES, MAX_CANDS = 16, 2, 16
MAX_J = 1 << 16                # J positions fit 16 bits (pairs u | v << 16)
MAX_SIZE = 64                  # the head and each tail block, at most
LANE_SCALARS = 8               # per-lane scalars: rho, slope, df, ...
# header fields: sizes, value offsets (V_*, into one phase's values) and
# index-array offsets (O_*, into the descriptor)
(H_MAGIC, H_N, H_M, H_NV, H_H0, H_H, H_NB, H_NJ, H_ARROW, H_VLEN, H_LEN,
 H_STAGE, H_NGN, H_NQ, H_NT, H_NC, H_NGR, H_NGE,
 V_A, V_Q, V_T, V_C, V_C0, V_GF,
 O_ROFF, O_RLEN, O_COFF, O_CLEN, O_CIDX,
 O_COL, O_QOFF, O_QLEN, O_QIDX, O_TOFF, O_TLEN, O_TIDX,
 O_GROFF, O_GRLEN, O_GRENT, O_GRROW,
 O_GNOFF, O_GNLEN, O_GNDST, O_GNENT, O_GNROW, H_END) = range(46)
# tail-block record (after the header): start, size, and the float
# offsets of its factor D (packed lower triangle) and panel M in a lane's
# arrow region; the Schur order follows the records
B_START, B_SIZE, B_D, B_M, B_REC = range(5)
# the kernel's phases of an iteration, in order (its optional clock counts)
PHASES = ("rows", "targets", "ridge", "tail_factor", "schur", "head",
          "back_substitute", "fallback", "line_rows", "line_search")
LAYOUT = (MAGIC, HEADER, SLICE, MAX_BLOCKS, MAX_LANES, MAX_CANDS, H_END,
          B_REC, LANE_SCALARS, len(PHASES))

# the card's shared memory (H100, sm_90): per SM, and what the runtime
# reserves per block; the wrapper aims at BLOCKS_PER_SM blocks an SM
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024
SMEM_BLOCK_MAX = 232448
BLOCKS_PER_SM = 2
# a quad family's Q may be asymmetric by this much of max |Q| (rounding)
Q_SYM_RTOL = 1e-12


def _r4(count):
    """``count`` rounded up to 4 (16-byte alignment of 4-byte words)."""
    return -(-count // 4) * 4


def _tri(i):
    return i * (i + 1) // 2


class _Sliced:
    """Sliced layout of items with given list lengths: item ``i``'s entry
    ``j`` at ``off[i] + 32 j``; ``size`` words in all."""

    def __init__(self, lengths):
        lengths = np.asarray(lengths, dtype=np.int64)
        self.len = lengths
        self.off = np.zeros(len(lengths), dtype=np.int64)
        base = 0
        for s in range(0, len(lengths), SLICE):
            w = int(lengths[s:s + SLICE].max())
            self.off[s:s + SLICE] = base + np.arange(len(lengths[s:s + SLICE]))
            base += SLICE * w
        self.size = base

    def positions(self, i):
        return self.off[i] + SLICE * np.arange(self.len[i])


def lanes_per_block(B, n_sm, smem):
    """Lanes a block serves: enough blocks for BLOCKS_PER_SM an SM at
    width B, and no more lanes than that share of an SM's shared memory
    holds.  ``smem(L)``: a block's shared bytes for L lanes."""
    budget = SMEM_PER_SM // BLOCKS_PER_SM - SMEM_RESERVED
    fit = max(L for L in range(MAX_LANES + 1) if L == 0 or smem(L) <= budget)
    want = B // (BLOCKS_PER_SM * n_sm)
    return max(1, min(MAX_LANES, fit, want))


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
                Qt = Qc.transpose(0, 2, 1)
                asym = float(np.abs(Qc - Qt).max(initial=0.0))
                scale = float(np.abs(Qc).max(initial=0.0))
                if asym > Q_SYM_RTOL * scale:
                    raise ValueError(
                        f"family {i}: Q rows are not symmetric (max "
                        f"|Q - Q'| {asym:.3g} > {Q_SYM_RTOL} max |Q| "
                        f"{scale:.3g})")
                Qc = 0.5 * (Qc + Qt)
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
        self._compress()

    # -- flat encoding ------------------------------------------------------
    def _layout(self):
        """Float offsets of every table inside one phase's flat buffer
        (each table 16-byte aligned)."""
        size = 0

        def take(count):
            nonlocal size
            at = size
            size += _r4(count)
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

    # -- the kernel's compressed encoding -----------------------------------
    def _compress(self):
        """Build the kernel's lists (module docstring) and the sources of
        their values; :meth:`descriptor` and :meth:`phase_values` emit
        them."""
        h = self.head[1]
        n, m = self.n_x, self.m
        # a lane's arrow region: S (packed lower triangle), r_h, then per
        # tail block its factor D (packed lower) and panel M (sz, h + 2)
        off = _r4(_tri(h)) + _r4(h)
        self.arrow_D, self.arrow_M = [], []
        for (_, sz) in self.blocks:
            self.arrow_D.append(off)
            off += _r4(_tri(sz))
            self.arrow_M.append(off)
            off += _r4(sz * (h + 2))
        self.arrow_len = off

        # J's pattern per row: (family, row in family, local columns)
        rows, pats, colvars = [], [], []
        for fi, f in enumerate(self.fams):
            m_f = f.row_stop - f.row_start
            cols = np.concatenate([np.arange(s, s + z) for s, z in f.runs])
            pat = (self.uA[f.iA] != 0).any(0)
            if f.iTA >= 0:
                pat |= (self.uTA[f.iTA] != 0).any(0).any(-1)
            if f.iQ >= 0:
                pat |= (self.uQ[f.iQ].reshape(m_f, len(cols), len(cols))
                        != 0).any(-1)
            if f.row_start != len(rows):
                raise ValueError(f"family {fi} does not start at row "
                                 f"{len(rows)}")
            pats.append(pat)
            colvars.append(cols)
            rows += [(fi, i, np.nonzero(pat[i])[0]) for i in range(m_f)]
        R = _Sliced([len(js) for _, _, js in rows])
        nJ = R.size
        col = np.zeros(nJ, np.int64)
        rowof = np.zeros(nJ, np.int64)
        pos = {}                                # (row, local column) -> p
        t_lists = [[] for _ in range(nJ)]       # (slot, (iTA, i, j, q))
        q_lists = [[] for _ in range(nJ)]       # (variable, (iQ, row, k))
        a_src = []                              # (p, iA, i, j)
        for r, (fi, i, js) in enumerate(rows):
            f = self.fams[fi]
            n_f = len(colvars[fi])
            for j, p in zip(js, R.positions(r)):
                pos[(r, j)] = p
                col[p] = colvars[fi][j]
                rowof[p] = r
                a_src.append((p, f.iA, i, j))
                if f.iTA >= 0:
                    for q in np.nonzero(
                            (self.uTA[f.iTA][:, i, j] != 0).any(0))[0]:
                        t_lists[p].append((f.qpos[q], (f.iTA, i, j, q)))
                if f.iQ >= 0:
                    qrow = self.uQ[f.iQ][i * n_f + j]
                    for k in np.nonzero(qrow)[0]:
                        q_lists[p].append((colvars[fi][k],
                                           (f.iQ, i * n_f + j, k)))
        Tl = _Sliced([len(t) for t in t_lists])
        Ql = _Sliced([len(q) for q in q_lists])
        c_lists = [[(q, (r, q)) for q in np.nonzero(
            (self.C1[:, r] != 0).any(0))[0]] for r in range(m)]
        Cl = _Sliced([len(c) for c in c_lists])

        def flat(lists, sl):
            idx = np.zeros(sl.size, np.int64)
            src = []
            for i, lst in enumerate(lists):
                for p, (k, s) in zip(sl.positions(i), lst):
                    idx[p] = k
                    src.append((p,) + s)
            return idx, src
        t_idx, t_src = flat(t_lists, Tl)
        q_idx, q_src = flat(q_lists, Ql)
        c_idx, c_src = flat(c_lists, Cl)

        # the gradient, J'y: per variable, the J positions of its column
        gr_lists = [[] for _ in range(n)]
        for r, (_, _, js) in enumerate(rows):
            for j in js:
                gr_lists[col[pos[(r, j)]]].append(pos[(r, j)])
        Gr = _Sliced([len(g) for g in gr_lists])
        gr_ent = np.zeros(Gr.size, np.int64)
        for v, lst in enumerate(gr_lists):
            gr_ent[Gr.positions(v)] = lst

        # Gauss-Newton: per hit target, the (u, v) pairs (module docstring)
        gn = {}
        for r, (fi, _, js) in enumerate(rows):
            f = self.fams[fi]
            tgt = []
            for j in js:
                for (oa, sa, ta, pa) in f.segs:
                    if oa <= j < oa + sa:
                        tgt.append((ta, pa + j - oa))
            for a, (ta, pa) in zip(js, tgt):
                for b, (tb, pb) in zip(js, tgt):
                    u, v = pos[(r, a)], pos[(r, b)]
                    if ta < 0 and tb < 0:
                        if pa >= pb:
                            gn.setdefault(_tri(pa) + pb, []).append((u, v))
                    elif ta < 0:               # C' kept pre-transposed
                        gn.setdefault(self.arrow_M[tb] + pb * (h + 2) + pa,
                                      []).append((v, u))
                    elif tb >= 0:
                        if ta != tb:
                            raise ValueError(f"family {fi} couples tail "
                                             f"blocks {ta} and {tb}")
                        if pa >= pb:
                            gn.setdefault(self.arrow_D[ta] + _tri(pa) + pb,
                                          []).append((u, v))
        # longest lists first: less padding in each slice
        dst = sorted(gn, key=lambda t: -len(gn[t]))
        Gn = _Sliced([len(gn[t]) for t in dst])
        gn_ent = np.zeros(Gn.size, np.int64)
        for i, t in enumerate(dst):
            gn_ent[Gn.positions(i)] = [u | (v << 16) for u, v in gn[t]]

        self._k = dict(R=R, col=col, rowof=rowof, Tl=Tl, Ql=Ql,
                       Cl=Cl, t_idx=t_idx, q_idx=q_idx, c_idx=c_idx,
                       a_src=np.array(a_src, np.int64).reshape(-1, 4),
                       t_src=t_src, q_src=q_src, c_src=c_src, Gr=Gr,
                       gr_ent=gr_ent, Gn=Gn, gn_ent=gn_ent,
                       gn_dst=np.array(dst, np.int64))
        # value offsets in one phase's buffer
        self.voff = {}
        size = 0
        for key, count in (("A", nJ), ("Q", Ql.size), ("T", Tl.size),
                           ("C", Cl.size), ("c0", m), ("gf", n)):
            self.voff[key] = size
            size += _r4(count)
        self.values_len = size
        self.n_j = nJ

    def phase_values(self, phase):
        """One phase's float64 values at the descriptor's positions."""
        k = self._k
        buf = np.zeros(self.values_len)
        a = k["a_src"]
        for iA in np.unique(a[:, 1]):
            sel = a[a[:, 1] == iA]
            buf[self.voff["A"] + sel[:, 0]] = \
                self.uA[iA][phase][sel[:, 2], sel[:, 3]]
        for p, iT, i, j, q in k["t_src"]:
            buf[self.voff["T"] + p] = self.uTA[iT][phase][i, j, q]
        for p, iQ, e, kk in k["q_src"]:
            buf[self.voff["Q"] + p] = self.uQ[iQ][e, kk]
        for p, r, q in k["c_src"]:
            buf[self.voff["C"] + p] = self.C1[phase][r, q]
        buf[self.voff["c0"]:self.voff["c0"] + self.m] = self.c0[phase]
        buf[self.voff["gf"]:self.voff["gf"] + self.n_x] = self.gf[phase]
        return buf

    def kernel_refusal(self):
        """None when K3 takes this plan, else why not: the head and each
        tail block at most MAX_SIZE, at most MAX_BLOCKS tail blocks, J's
        positions within MAX_J (16-bit pair indices) and one lane's block
        within the card's shared memory (SMEM_BLOCK_MAX)."""
        sizes = [self.head[1]] + [sz for _, sz in self.blocks]
        why = []
        if max(sizes) > MAX_SIZE:
            why.append(f"head and tail blocks {sizes}: one above "
                       f"MAX_SIZE {MAX_SIZE}")
        if len(self.blocks) > MAX_BLOCKS:
            why.append(f"{len(self.blocks)} tail blocks > MAX_BLOCKS "
                       f"{MAX_BLOCKS}")
        if self.n_j > MAX_J:
            why.append(f"{self.n_j} J positions > MAX_J {MAX_J}")
        if self.smem_bytes(1) > SMEM_BLOCK_MAX:
            why.append(f"{self.smem_bytes(1)} shared bytes for one lane > "
                       f"SMEM_BLOCK_MAX {SMEM_BLOCK_MAX}")
        return "; ".join(why) or None

    def summary(self):
        """The plan's sizes in one line (the runner's structure reason)."""
        return (f"n {self.n_x}, m {self.m}, head {self.head[1]}, tail "
                f"blocks {[sz for _, sz in self.blocks]}, {self.n_j} J "
                f"positions, {self.values_len} values a phase, "
                f"{self.smem_bytes(1)} shared bytes for one lane")

    def stage_len(self):
        """Descriptor words a block copies into shared memory: the header,
        the tail-block records and the Schur order."""
        return HEADER + (B_REC + 1) * len(self.blocks)

    def lane_floats(self):
        """Floats of one lane's working set in shared memory, in the
        order of ``lane_layout`` in ``csrc/fused_alm.cu``: x, dx, the
        gradient, pv, the rows' g, y (then J dx) and dx'Q dx, J at its
        positions, the arrow region, the lane's scalars."""
        n, m = self.n_x, self.m
        return sum(_r4(c) for c in (n, n, n, self.n_v, m, m, m, self.n_j,
                                    self.arrow_len, LANE_SCALARS))

    def smem_bytes(self, lanes):
        """Shared memory of a block serving ``lanes`` lanes."""
        return 4 * (_r4(self.stage_len()) + lanes * self.lane_floats())

    def descriptor(self):
        """The int32 descriptor the CUDA kernel reads (layout in
        ``csrc/fused_alm.cu``): header, tail-block records, Schur order,
        then every index array, each 16-byte aligned."""
        k = self._k
        nb = len(self.blocks)
        arrays = [
            (O_ROFF, k["R"].off), (O_RLEN, k["R"].len),
            (O_COFF, k["Cl"].off), (O_CLEN, k["Cl"].len),
            (O_CIDX, k["c_idx"]),
            (O_COL, k["col"]),
            (O_QOFF, k["Ql"].off), (O_QLEN, k["Ql"].len),
            (O_QIDX, k["q_idx"]),
            (O_TOFF, k["Tl"].off), (O_TLEN, k["Tl"].len),
            (O_TIDX, k["t_idx"]),
            (O_GROFF, k["Gr"].off), (O_GRLEN, k["Gr"].len),
            (O_GRENT, k["gr_ent"]), (O_GRROW, k["rowof"][k["gr_ent"]]),
            (O_GNOFF, k["Gn"].off), (O_GNLEN, k["Gn"].len),
            (O_GNDST, k["gn_dst"]), (O_GNENT, k["gn_ent"]),
            (O_GNROW, k["rowof"][k["gn_ent"] & 0xffff])]
        at = _r4(self.stage_len())
        offs = {}
        for field, a in arrays:
            offs[field] = at
            at += _r4(len(a))
        d = np.zeros(at, dtype=np.int64)
        d[:O_ROFF] = (MAGIC, self.n_x, self.m, self.n_v, self.head[0],
                      self.head[1], nb, self.n_j, self.arrow_len,
                      self.values_len, at, self.stage_len(), len(k["gn_dst"]),
                      k["Ql"].size, k["Tl"].size, k["Cl"].size, k["Gr"].size,
                      k["Gn"].size, self.voff["A"], self.voff["Q"],
                      self.voff["T"], self.voff["C"], self.voff["c0"],
                      self.voff["gf"])
        for bi, (s, sz) in enumerate(self.blocks):
            d[HEADER + B_REC * bi:HEADER + B_REC * (bi + 1)] = (
                s, sz, self.arrow_D[bi], self.arrow_M[bi])
        d[HEADER + B_REC * nb:self.stage_len()] = self.schur_order
        for field, a in arrays:
            d[field] = offs[field]
            d[offs[field]:offs[field] + len(a)] = a
        return d.astype(np.int32)

    def shared(self, dtype, device):
        """The operands, built once: the plain version's dense ``tables``
        (spk, phase_len) and the kernel's ``vals`` (spk, values_len) on
        ``device``, the kernel's descriptor on ``device`` and on the host.
        Slice one phase with :meth:`slice_phase`."""
        desc = self.descriptor()
        tables = np.stack([self.phase_tables(ph) for ph in range(self.spk)])
        vals = np.stack([self.phase_values(ph) for ph in range(self.spk)])
        return {"tables": torch.as_tensor(tables, dtype=dtype, device=device),
                "vals": torch.as_tensor(vals, dtype=dtype, device=device),
                "desc": torch.as_tensor(desc, device=device),
                "desc_host": desc}

    @staticmethod
    def slice_phase(shared, phase):
        """The operands of one in-knot phase (a host int)."""
        return dict(shared, tables=shared["tables"][phase],
                    vals=shared["vals"][phase])


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


def _scatter(plan, f, g_f, H, grad, S, D, M):
    """Add one family's gradient g_f (B, n_f) and Gauss-Newton block H
    (B, n_f, n_f) into grad, the head S, the tail blocks D and the panels M
    (C' pre-transposed; the (block, head) mirror pairs skipped)."""
    for (oa, sa, ta, pa) in f.segs:
        s = _seg_start(plan, ta, pa)
        grad[:, s:s + sa] += g_f[:, oa:oa + sa]
        for (ob, sb, tb, pb) in f.segs:
            if ta >= 0 and tb < 0:
                continue                           # mirror of (head, block)
            if ta < 0 and tb < 0:
                S[:, pa:pa + sa, pb:pb + sb] += H[:, oa:oa + sa, ob:ob + sb]
            elif ta < 0:                           # C' kept pre-transposed
                M[tb][:, pb:pb + sb, pa:pa + sa] += H[:, ob:ob + sb,
                                                      oa:oa + sa]
            else:
                D[ta][:, pa:pa + sa, pb:pb + sb] += H[:, oa:oa + sa,
                                                      ob:ob + sb]


def _line_search(opt, gv, Jd, qd, df_obj, slope, lor, rho, lb, ub):
    """The exact-quadratic Armijo search: along dx, g moves to
    gv + a J dx + a^2 dx'Q dx, so each candidate's merit is exact; the
    first acceptable candidate a (0 where none is)."""
    def penalty(g):
        rr = g + lor
        return 0.5 * rho * ((rr - torch.clamp(rr, lb, ub)) ** 2).sum(-1)

    m0 = penalty(gv)           # f0 + gf.x cancels in the comparison
    alpha = torch.zeros_like(rho)
    found = torch.zeros(rho.shape, dtype=torch.bool, device=rho.device)
    for a in opt.ls_candidates:
        a = float(a)
        mv = a * df_obj + penalty(gv + a * Jd + (a * a) * qd)
        ok = torch.isfinite(mv) & (mv <= m0 + (opt.armijo * a) * slope)
        alpha = torch.where(ok & ~found, torch.full_like(alpha, a), alpha)
        found = found | ok
    return alpha


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
            _scatter(plan, f, g_f, H, grad, S, D, M)
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
        alpha = _line_search(opt, gv, Jd, qd, dx @ tb["gf"], slope, lor, rho,
                             lb, ub)
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


def kernel_smem_bytes(desc_host, lanes):
    """The shared memory the CUDA side lays out for a block of ``lanes``
    lanes of this descriptor (-1: a plan or width it refuses); on the card
    only, to hold :meth:`FusedPlan.smem_bytes` to it."""
    desc_host = np.ascontiguousarray(desc_host, dtype=np.int32)
    return int(_load().omg_fused_smem(desc_host.ctypes.data, int(lanes)))


def _check(named, device):
    for name, t in named:
        if t.device != device:
            raise ValueError(f"{name} lies on {t.device}, not {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_inner(plan, fs, x, lam, rho, pv, lb, ub, opt, n_inner, clocks=None):
    """``n_inner`` fused ALM inner iterations for a batch of lanes (the
    arguments of :func:`fused_inner_plain`).  CPU tensors take the plain
    version; CUDA float32 tensors launch K3, whose blocks serve the lanes
    :func:`lanes_per_block` picks; anything else raises.
    ``clocks``: None, or an int64 tensor of len(PHASES) on the card to
    which every block adds the clock cycles it spent in each phase."""
    named = (("x", x), ("lam", lam), ("rho", rho), ("pv", pv), ("lb", lb),
             ("ub", ub), ("vals", fs["vals"]))
    if all(t.device.type == "cpu" for _, t in named):
        return fused_inner_plain(plan, fs, x, lam, rho, pv, lb, ub, opt,
                                 n_inner)
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    _check(named, x.device)
    B = x.shape[0]
    n, m, n_v = plan.n_x, plan.m, plan.n_v
    want = {"x": (B, n), "lam": (B, m), "rho": (B,), "pv": (B, n_v),
            "lb": (m,), "ub": (m,), "vals": (plan.values_len,)}
    for name, t in named:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
    desc, desc_host = fs["desc"], np.ascontiguousarray(fs["desc_host"],
                                                       dtype=np.int32)
    if desc.device != x.device or desc.dtype != torch.int32 \
            or desc.numel() != desc_host.size \
            or tuple(desc_host[[H_N, H_M, H_NV, H_VLEN]]) != (
                n, m, n_v, plan.values_len):
        raise ValueError("the descriptor must be the plan's int32 "
                         "descriptor on the lanes' device")
    x_out = torch.empty_like(x)
    gv = torch.empty((B, m), dtype=x.dtype, device=x.device)
    stat = torch.empty((B,), dtype=x.dtype, device=x.device)
    if B == 0:
        return x_out, gv, stat
    opts = np.asarray([opt.armijo, opt.max_step, opt.gn_delta_rel,
                       opt.delta, *opt.ls_candidates], dtype=np.float64)
    lanes = lanes_per_block(B, _sm_count(x.device), plan.smem_bytes)
    if clocks is not None and (clocks.device != x.device
                               or clocks.dtype != torch.int64
                               or tuple(clocks.shape) != (len(PHASES),)):
        raise ValueError("clocks must be an int64 tensor of len(PHASES) on "
                         "the lanes' device")
    lib = _load()
    err = lib.omg_fused_inner_f32(
        desc_host.ctypes.data, desc.data_ptr(), fs["vals"].data_ptr(),
        lb.data_ptr(), ub.data_ptr(), x.data_ptr(), lam.data_ptr(),
        rho.data_ptr(), pv.data_ptr(), opts.ctypes.data,
        len(opt.ls_candidates), x_out.data_ptr(), gv.data_ptr(),
        stat.data_ptr(), B, int(n_inner), int(lanes),
        None if clocks is None else clocks.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_alm kernel launch failed (cudaError {err})")
    fused_inner.launches += 1
    return x_out, gv, stat


fused_inner.launches = 0

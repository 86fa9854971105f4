"""K1's tiled variants (omg_tools_torch/csrc/chol_solve.cu,
``chol_tile_kernel``): systems above the register classes, their columns
cut into tiles of 32, each tile's lower triangle held column-major in
shared memory: ``block`` holds all of a system's tiles in one CTA,
``global`` spreads them over a thread-block cluster of 2-8 CTAs (each
panel factored by its owner, read by the others over distributed shared
memory); the right-hand sides ride along as augmented rows.

On the CPU: ``variant`` sends each shape of the paths and tests to its
variant and every shape that ran before the tiled design keeps its class;
``block_smem`` and the cluster's CTAs are the C side's counts at the edges;
and a numpy emulation of the kernel's loops (the tile layout, owners and
offsets, the remote panel's copy, the register factor of a diagonal
block, the panel solve, the trailing-update items (4 x 4 of FMAs in
float32, 8 x 8 of tensor-core steps in float64), the backward
substitution by tiles, in the kernel's index arithmetic, with every
shared element the kernel never writes and H's upper triangle NaN)
solves like ``numpy.linalg.solve`` to 1e-12, on one CTA and on
clusters.  On the card (``gpu``): the kernel against the plain version at
those shapes with the tolerances of ``chip_smoke.py``'s K1 rows (float64
1e-10, float32 5e-5 of the largest entry), with several right-hand sides,
inside a CUDA graph, on a non-SPD system, and what the entry point
refuses:

    python -m pytest tests/test_torch_k1_global.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from omg_tools_torch.ops import psd_kernels as pk

TOL_F32 = 5e-5
TOL_F64 = 1e-10
TB = pk.TILE
SLD = pk.TILE_SCRATCH_LD
# (systems, rows, dtype, variant, CTAs): chip_smoke.py's shapes of the
# tiled variants beyond 168 float64 rows (the global variant's before
# the tiled design), and the warehouse's 395
GLOBAL_SHAPES = [(1, 178, torch.float64, "block", 1),
                 (1, 186, torch.float64, "block", 1),
                 (4, 186, torch.float64, "block", 1),
                 (1, 203, torch.float64, "block", 1),
                 (1, 262, torch.float64, "global", 2),
                 (1, 395, torch.float64, "global", 6),
                 (1, 262, torch.float32, "block", 1)]
# every K1/K2 shape of PERF.md's kernel table before the global variant,
# with the variant it ran: (n, r, dtype, variant)
EARLIER = [(26, 1, torch.float32, "reg32"), (33, 27, torch.float32, "reg48"),
           (151, 1, torch.float32, "block"), (42, 1, torch.float32, "reg48"),
           (54, 1, torch.float32, "reg64"), (44, 43, torch.float32, "reg48"),
           (43, 55, torch.float32, "reg48"), (26, 1, torch.float64, "reg64"),
           (33, 27, torch.float64, "reg64"), (42, 1, torch.float64, "reg64"),
           (44, 43, torch.float64, "reg64"), (54, 1, torch.float64, "reg64"),
           (43, 55, torch.float64, "reg64"), (151, 1, torch.float64, "block"),
           (85, 1, torch.float32, "block"), (85, 1, torch.float64, "block"),
           (35, 1, torch.float64, "reg64"), (33, 1, torch.float64, "reg64"),
           (14, 43, torch.float32, "reg32"), (13, 55, torch.float32, "reg32"),
           (120, 1, torch.float64, "block"), (93, 1, torch.float64, "block")]


# the largest cluster the global variant launches (kMaxCluster in
# csrc/chol_solve.cu)
MAX_CLUSTER = 8
_r4 = lambda x: -(-x // 4) * 4                           # noqa: E731


def _tile_map(n, m, P, itemsize):
    """The tiles' owners and offsets over P CTAs, as the kernel's
    ``tile_map`` assigns them (largest first, each to the least-loaded
    CTA): (owner, off, the largest storage of one CTA in elements)."""
    load, owner, off = [0] * P, [], []
    for j in range(-(-n // TB)):
        q = min(range(P), key=lambda p: (load[p], p))
        owner.append(q)
        off.append(load[q])
        load[q] += TB * pk.tile_ld(m, j, itemsize)
    return owner, off, max(load)


def _tile_smem(n, r, itemsize, P):
    """The dynamic shared bytes of one CTA over P (``tile_smem``): its
    tiles, a remote panel's copy (P > 1), the diagonal block's scratch,
    the inverse pivots, one tile's x."""
    m = n + r
    most = _tile_map(n, m, P, itemsize)[2]
    panel = TB * _r4(m - TB) if P > 1 and m > TB else 0
    return itemsize * (most + panel + TB * SLD + _r4(n) + TB * r)


def _cluster_size(n, r, itemsize):
    """The CTAs the C side launches the global variant on: the smallest
    cluster of 2 .. MAX_CLUSTER whose shares fit, or None (refused)."""
    if n > pk.MAX_TILES * TB:
        return None
    return next((P for P in range(2, MAX_CLUSTER + 1)
                 if _tile_smem(n, r, itemsize, P) <= pk.TILE_SMEM), None)


def test_variant_sends_large_systems_to_the_global_variant():
    """Above one CTA's shared memory (float64 beyond 215 rows, float32
    beyond 315) the global variant, over the smallest cluster that holds
    the tiles; every earlier shape keeps its variant."""
    for _, n, dtype, want, ctas in GLOBAL_SHAPES:
        assert pk.variant(n, 1, dtype) == want, (n, dtype)
        size = torch.empty((), dtype=dtype).element_size()
        if want == "global":
            assert _cluster_size(n, 1, size) == ctas, (n, dtype)
    for n, r, dtype, want in EARLIER:
        assert pk.variant(n, r, dtype) == want, (n, r, dtype)
    assert pk.variant(420, 1, torch.float64) == "global"
    assert _cluster_size(420, 1, 8) == 7
    assert _cluster_size(440, 1, 8) is None       # beyond 8 CTAs
    assert _cluster_size(691, 1, 4) == 8
    assert _cluster_size(692, 1, 4) is None


def test_block_variant_keeps_what_fits_its_shared_memory():
    """The block variant's bytes: its tiles (32 columns of rows j 32 ..
    m - 1 at a stride of an odd number of 16-byte units), the diagonal
    block's scratch (32 x 36), the inverse pivots and one tile's x; the
    last float64 K1 system it holds is 215 rows, float32 315."""
    m = 216
    lds = [-(-(m - 32 * j) // 4) * 4 for j in range(7)]
    lds = [ld + 2 if (ld // 2) % 2 == 0 else ld for ld in lds]
    assert pk.block_smem(215, 1, 8) == 8 * (32 * sum(lds) + 32 * 36 + 216
                                             + 32)
    assert pk.block_smem(215, 1, 8) <= pk.TILE_SMEM < pk.block_smem(216, 1, 8)
    assert (pk.variant(215, 1, torch.float64),
            pk.variant(216, 1, torch.float64)) == ("block", "global")
    assert (pk.variant(315, 1, torch.float32),
            pk.variant(316, 1, torch.float32)) == ("block", "global")
    # K2 sizes: the r right-hand sides are r more rows of every tile
    assert pk.block_smem(160, 27, 8) > pk.block_smem(160, 1, 8)
    assert pk.variant(200, 27, torch.float64) == "global"
    assert pk.variant(120, 27, torch.float64) == "block"
    # a cluster's CTA holds its own tiles and a remote panel's copy
    owner, off, most = _tile_map(395, 396, 6, 8)
    assert owner[:6] == [0, 1, 2, 3, 4, 5] and off[:6] == [0] * 6
    assert _tile_smem(395, 1, 8, 6) == 8 * (most + 32 * 364 + 32 * 36
                                              + 396 + 32)


def test_block_bytes_are_the_cluster_layout_on_one_cta():
    """``variant``'s count of the block variant's bytes is the cluster
    layout's on one CTA (no remote panel), at every n of the tiled
    variants, r = 1 and K2's r, in both types."""
    for size in (4, 8):
        for r in (1, 2, 27, 55):
            for n in range(60, 700, 7):
                assert pk.block_smem(n, r, size) == _tile_smem(n, r, size,
                                                               1), (n, r)


def _emulate(H, G, P, itemsize, shake=0.0):
    """The tiled kernel's loops in numpy, one system over P CTAs: each
    CTA's dynamic shared memory a flat array, NaN where the kernel never
    writes, and the kernel's index arithmetic (csrc/chol_solve.cu
    ``chol_tile_kernel``)."""
    n, r = G.shape
    m = n + r
    nt = -(-n // TB)
    owner, off, most = _tile_map(n, m, P, itemsize)
    r4 = _r4
    ldb = r4(m - TB)
    size = _tile_smem(n, r, itemsize, P) // itemsize
    mem = [np.full(size, np.nan) for _ in range(P)]
    S_at = most + (TB * ldb if P > 1 and m > TB else 0)
    dinv_at = S_at + TB * SLD
    xb_at = dinv_at + r4(n)
    assert xb_at + TB * r == size
    ld = lambda j: pk.tile_ld(m, j, itemsize)             # noqa: E731
    width = lambda j: min(TB, n - j * TB)                 # noqa: E731
    # the load: a lane a column, a warp 4 rows
    for j in range(nt):
        A, c0, w = mem[owner[j]], j * TB, width(j)
        for g in range(r4(m - c0) // 4):
            for lane in range(TB):
                c = c0 + lane
                for q in range(4):
                    i = c0 + 4 * g + q
                    x = 0.0
                    if lane < w and i < n and i >= c:
                        x = H[i, c]
                    elif lane < w and n <= i < m:
                        x = G[c, i - n]
                    A[off[j] + lane * ld(j) + 4 * g + q] = x

    def factor_diag(M, at, ldj, w, d0):
        a = np.array([[M[at + t * ldj + lane] if t <= lane < w else 0.0
                       for t in range(TB)] for lane in range(TB)])
        for j in range(w):
            inv = 1.0 / np.sqrt(a[j, j])
            a[:, j] *= inv
            M[dinv_at + d0 + j] = inv
            col = a[:, j].copy()               # S's column j
            for t in range(j + 1, TB):
                a[:, t] -= a[:, j] * col[t]
        for lane in range(TB):
            for t in range(TB):
                if t <= lane < w:
                    M[at + t * ldj + lane] = a[lane, t]
                M[S_at + t * SLD + lane] = a[lane, t]

    def panel_solve(M, at, ldj, w, length, d0):
        for i in range(w, length):
            a = np.array([M[at + t * ldj + i] if t < w else 0.0
                          for t in range(TB)])
            for t in range(w):
                a[t] *= M[dinv_at + d0 + t]
                for u in range(t + 1, TB):
                    a[u] -= a[t] * M[S_at + t * SLD + u]
            for t in range(w):
                M[at + t * ldj + i] = a[t]

    def update(rank, k, jlo, jhi, Pm, Pp, pld):
        """float32: 4 x 4 items of FMAs; float64: 8 x 8 items of the
        tensor cores' m8n8k4 steps, rows beyond the panel's read as zeros
        and rows beyond the tile's not written."""
        M = mem[rank]
        b = 4 if itemsize == 4 else 8
        prows = r4(m - (k + 1) * TB)
        for j in range(jlo, jhi):
            if owner[j] != rank:
                continue
            R, cbs = -(-(m - j * TB) // b), -(-width(j) // b)
            rel = (j - k - 1) * TB
            for le in range(R * cbs):          # items, row block fastest
                cb, rb = le // R, le % R
                if rb < cb:
                    continue
                acc = np.zeros((b, b))
                for t in range(TB):
                    col = Pp + t * pld

                    def rows(p0):
                        return np.array([Pm[col + p] if p < prows else 0.0
                                         for p in range(p0, p0 + b)])
                    acc += np.outer(rows(rel + b * rb), rows(rel + b * cb))
                for y in range(b):
                    for x in range(b):
                        if b * rb + x < r4(m - j * TB):
                            M[off[j] + (b * cb + y) * ld(j) + b * rb + x] \
                                -= acc[x, y]

    factor_diag(mem[owner[0]], off[0], ld(0), width(0), 0)
    panel_solve(mem[owner[0]], off[0], ld(0), width(0), m, 0)
    for k in range(nt - 1):
        for rank in range(P):
            if owner[k] == rank:
                Pm, Pp, pld = mem[rank], off[k] + TB, ld(k)
            else:
                len4 = r4(m - (k + 1) * TB)
                if any(owner[j] == rank for j in range(k + 1, nt)):
                    src = mem[owner[k]]
                    for t in range(TB):
                        mem[rank][most + t * ldb:][:len4] = \
                            src[off[k] + TB + t * ld(k):][:len4]
                Pm, Pp, pld = mem[rank], most, ldb
            c1 = (k + 1) * TB
            if owner[k + 1] == rank:
                update(rank, k, k + 1, k + 2, Pm, Pp, pld)
                factor_diag(mem[rank], off[k + 1], ld(k + 1), width(k + 1),
                            c1)
                update(rank, k, k + 2, nt, Pm, Pp, pld)
                panel_solve(mem[rank], off[k + 1], ld(k + 1), width(k + 1),
                            m - c1, c1)
            else:
                update(rank, k, k + 1, nt, Pm, Pp, pld)
    def backward():
        for jt in range(nt - 1, -1, -1):
            c0, w, ldj = jt * TB, width(jt), ld(jt)
            Mo, at = mem[owner[jt]], off[jt]
            for q in range(r):
                z = np.array([Mo[at + i * ldj + (n - c0) + q] if i < w else 0.0
                              for i in range(TB)])
                for i in range(w - 1, -1, -1):
                    z[i] *= Mo[dinv_at + c0 + i]
                    for c in range(i):
                        z[c] -= Mo[at + c * ldj + i] * z[i]
                for i in range(w):
                    Mo[at + i * ldj + (n - c0) + q] = z[i]
            for rank in range(P):
                if jt == 0 or not any(owner[j] == rank for j in range(jt)):
                    continue
                M = mem[rank]
                for e in range(r * TB):
                    q, i = e // TB, e % TB
                    M[xb_at + e] = (Mo[at + i * ldj + (n - c0) + q] if i < w
                                    else 0.0)
                for j in range(jt):
                    if owner[j] != rank:
                        continue
                    for q in range(r):
                        for c in range(TB):
                            Lc = off[j] + c * ld(j) + (c0 - j * TB)
                            acc = sum(M[Lc + i:][:4] @ M[xb_at + q * TB + i:][:4]
                                      for i in range(0, w, 4))
                            M[off[j] + c * ld(j) + (n - j * TB) + q] -= acc

    def read_x():
        X = np.full((n, r), np.nan)
        for j in range(nt):
            for c in range(width(j)):
                X[j * TB + c] = mem[owner[j]][off[j] + c * ld(j)
                                              + (n - j * TB) + np.arange(r)]
        return X

    def slot(c, q):
        """Where z_c of right-hand side q lives: tile c // TB's augmented
        row n + q, column c."""
        t = c // TB
        return off[t] + (c - t * TB) * ld(t) + (n - t * TB) + q

    backward()
    X = read_x()
    if itemsize == 4 and P == 1:
        # float32 on one CTA refines once: X + shake stands in for the
        # first solve's rounding, which the refinement must take out
        X = X + shake
        M = mem[0]
        for e in range(n * r):                 # the residual, row fastest
            i, q = e % n, e // n
            h = np.concatenate([H[i, :i + 1], H[i + 1:, i]])
            M[slot(i, q)] = G[i, q] - h @ X[:, q]
        for k in range(nt):                    # forward by tiles
            c0, w, ldk = k * TB, width(k), ld(k)
            for q in range(r):
                z = np.array([M[off[k] + lane * ldk + (n - c0) + q]
                              if lane < w else 0.0 for lane in range(TB)])
                for i in range(w):
                    z[i] *= M[dinv_at + c0 + i]
                    for lane in range(i + 1, TB):
                        if lane < w:
                            z[lane] -= M[off[k] + i * ldk + lane] * z[i]
                for lane in range(w):
                    M[off[k] + lane * ldk + (n - c0) + q] = z[lane]
                M[xb_at + q * TB:][:TB] = np.where(np.arange(TB) < w, z, 0.0)
            for e in range(max(n - c0 - TB, 0) * r):
                length = n - c0 - TB
                c, q = c0 + TB + e % length, e // length
                acc = sum(M[off[k] + i * ldk + (c - c0)]
                          * M[xb_at + q * TB + i] for i in range(w))
                M[slot(c, q)] -= acc
        backward()
        X = X + read_x()
    return X


@pytest.mark.parametrize("n,r,P,itemsize", [
    (5, 1, 1, 8), (32, 1, 1, 4), (33, 2, 1, 8), (70, 3, 1, 4), (70, 3, 2, 8),
    (151, 1, 1, 4), (151, 1, 1, 8), (186, 1, 2, 8), (130, 33, 3, 4)])
def test_emulated_kernel_solves(n, r, P, itemsize):
    """float64's layout and tensor-core items (itemsize 8), float32's
    layout and FMA items (4), both emulated in float64 arithmetic."""
    rng = np.random.default_rng(n + r)
    M = rng.standard_normal((n, n))
    H = M @ M.T / n + np.eye(n)
    want = np.linalg.solve(H, rng.standard_normal((n, r)))
    G = H @ want
    H[np.triu_indices(n, 1)] = np.nan          # only the lower triangle
    X = _emulate(H, G, P, itemsize)
    assert np.isfinite(X).all()
    assert np.abs(X - want).max() <= 1e-12 * np.abs(want).max()
    if itemsize == 4 and P == 1:
        # the refinement step takes a first solve's error out
        shake = 1e-3 * rng.standard_normal((n, r))
        X = _emulate(H, G, P, itemsize, shake)
        assert np.abs(X - want).max() <= 1e-12 * np.abs(want).max()


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


def _card(N, n, r, seed, device, dtype):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    A = torch.randn((N, n, n), generator=gen, dtype=torch.float64)
    H = A @ A.transpose(1, 2) / n + torch.eye(n, dtype=torch.float64)
    G = torch.randn((N, n, r), generator=gen, dtype=torch.float64)
    return (H.to(device=device, dtype=dtype).contiguous(),
            G.to(device=device, dtype=dtype).contiguous())


def _close(got, want, dtype, what):
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), (what, err)


@pytest.mark.gpu
@pytest.mark.parametrize("n,r", [(85, 1), (151, 1), (190, 1), (151, 3)])
def test_cuda_block_float32_refines_to_the_system_it_was_given(
        cuda_device, n, r):
    """float32 on one CTA refines once (a float64 residual): on systems
    of condition ~1e3 it solves the float32 matrix it was given to within
    a few float32 roundings of a float64 solve, well inside the plain
    version's error there."""
    gen = torch.Generator(device="cpu").manual_seed(n + r)
    Q, _ = torch.linalg.qr(torch.randn((6, n, n), generator=gen,
                                       dtype=torch.float64))
    lam = torch.logspace(0, -3, n, dtype=torch.float64)
    H = ((Q * lam) @ Q.transpose(1, 2)).float().to(cuda_device)
    G = torch.randn((6, n, r), generator=gen).float().to(cuda_device)
    assert pk.variant(n, r, torch.float32) == "block"
    got = (pk.psd_solve(H, G[..., 0].contiguous())[..., None] if r == 1
           else pk.psd_solve_multi(H, G))
    Hd = torch.tril(H.double())
    want = torch.linalg.solve(Hd + torch.tril(Hd, -1).transpose(1, 2),
                              G.double())
    plain = pk.psd_solve_multi_plain(H, G)
    scale = want.abs().amax((1, 2))
    err = ((got.double() - want).abs().amax((1, 2)) / scale).max()
    plain_err = ((plain.double() - want).abs().amax((1, 2)) / scale).max()
    assert err <= 1e-6 and err <= plain_err / 10, (float(err),
                                                    float(plain_err))


@pytest.mark.gpu
@pytest.mark.parametrize("N,n,dtype,variant,ctas", GLOBAL_SHAPES)
def test_cuda_global_variant_matches_plain(cuda_device, N, n, dtype,
                                           variant, ctas):
    H, G = _card(N, n, 1, n, cuda_device, dtype)
    g = G[..., 0].contiguous()
    assert pk.variant(n, 1, dtype) == variant
    before = pk.psd_solve.launches
    got = pk.psd_solve(H, g)
    torch.cuda.synchronize()
    assert pk.psd_solve.launches == before + 1
    _close(got, pk.psd_solve_plain(H, g), dtype, (N, n))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_global_variant_with_several_right_hand_sides(cuda_device,
                                                           dtype):
    """r > 1 (K2's wrapper) beyond one CTA's shared memory, n not a
    multiple of the tile width, r above the 32 lanes of a warp."""
    shapes = ((2, 250, 3), (1, 240, 40), (3, 300, 2)) \
        if dtype == torch.float64 else ((2, 330, 3), (1, 300, 40),
                                        (3, 400, 2))
    for N, n, r in shapes:
        H, G = _card(N, n, r, n + r, cuda_device, dtype)
        assert pk.variant(n, r, dtype) == "global"
        got = pk.psd_solve_multi(H[:, None], G[:, None])[:, 0]
        _close(got, pk.psd_solve_multi_plain(H, G), dtype, (N, n, r))


@pytest.mark.gpu
@pytest.mark.parametrize("n,variant", [(186, "block"), (395, "global")])
def test_cuda_global_variant_kernel_name_and_graph(cuda_device, n, variant):
    """The launched kernel is ``chol_tile_kernel``; captured in a CUDA
    graph (the global variant a cluster launch) a replay gives the eager
    result bit for bit, on new inputs copied into the graph's own."""
    from torch.profiler import ProfilerActivity, profile
    from omg_tools_torch.ops.alm import CapturedCall
    H, G = _card(1, n, 1, 7, cuda_device, torch.float64)
    g = G[..., 0].contiguous()
    assert pk.variant(n, 1, torch.float64) == variant
    pk.psd_solve(H, g)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            pk.psd_solve(H, g)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if "chol" in e.key}
    assert len(names) == 1 and "chol_tile_kernel<double>" in names.pop(), \
        names
    call = CapturedCall(lambda h, v: (pk.psd_solve(h, v),), (H, g))
    assert call.k1_launches == 1
    H2, G2 = _card(1, n, 1, 8, cuda_device, torch.float64)
    for h, v in ((H, g), (H2, G2[..., 0].contiguous())):
        eager = pk.psd_solve(h, v)
        (replayed,) = call(h, v)
        torch.cuda.synchronize()
        assert torch.equal(eager, replayed)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [190, 300])
def test_cuda_global_variant_non_spd_and_refusals(cuda_device, n):
    """A non-SPD system among SPD ones is non-finite and leaves the others
    right (one CTA at 190 rows, a cluster at 300); the entry point refuses
    an empty batch, a block variant beyond one CTA's shared memory, a
    global one beyond a cluster of 8 and a system beyond 2,048 rows,
    launching nothing."""
    from omg_tools_torch.ops import _build
    H, G = _card(3, n, 1, 9, cuda_device, torch.float64)
    H[1, 4, 4] = -50.0
    g = G[..., 0].contiguous()
    got = pk.psd_solve(H, g)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(got[1]).all())
    keep = torch.tensor([0, 2], device=cuda_device)
    _close(got[keep], pk.psd_solve_plain(H[keep], g[keep]), torch.float64,
           "non-SPD neighbour")
    fn = _build.load("chol_solve_f64").omg_chol_solve_f64
    stream = torch.cuda.current_stream().cuda_stream
    for N, n_, var in ((0, 190, 0), (0, 300, 1), (1, 216, 0), (1, 440, 1),
                       (1, 2049, 1)):
        H, G = _card(1, n_, 1, 10, cuda_device, torch.float64)
        X = torch.full_like(G, 7.0)
        err = fn(H.data_ptr(), G.data_ptr(), X.data_ptr(), N, n_, 1, var,
                 stream)
        torch.cuda.synchronize()
        assert err == 1 and bool((X == 7.0).all()), (N, n_, var, err)

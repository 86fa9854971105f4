"""K1's global variant (omg_tools_torch/csrc/chol_solve.cu,
``chol_global_kernel``): SPD systems too large for a block's shared memory,
factored in a global-memory workspace by a right-looking blocked Cholesky
over panels of 32 columns, the right-hand sides riding along as augmented
rows.

On the CPU: ``variant`` sends float64 systems of 178, 186, 262 and 395 rows
(the scheduler's two-frame local problems, the central formation, the
free-time warehouse) and float32 systems of 262 rows to it, and every shape
that ran before keeps its variant; ``block_smem`` is the C side's count at
the edge; and a numpy emulation of the kernel's loops (panel staging,
column factorization, trailing update, backward substitution, in the
kernel's index arithmetic) solves like ``numpy.linalg.solve`` to 1e-12.
On the card (``gpu``): the kernel against the plain version at those
shapes with the tolerances of ``chip_smoke.py``'s K1 rows (float64 1e-10,
float32 5e-5 of the largest entry), with several right-hand sides, inside
a CUDA graph, on a non-SPD system, and what the entry point refuses:

    python -m pytest tests/test_torch_k1_global.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from omg_tools_torch.ops import psd_kernels as pk

TOL_F32 = 5e-5
TOL_F64 = 1e-10
NB = 32            # kPanel in csrc/chol_solve.cu
# (systems, rows, dtype): chip_smoke.py's shapes of the global variant
GLOBAL_SHAPES = [(1, 178, torch.float64), (1, 186, torch.float64),
                 (4, 186, torch.float64), (1, 262, torch.float64),
                 (1, 395, torch.float64), (1, 262, torch.float32)]
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


def test_variant_sends_large_systems_to_the_global_variant():
    for _, n, dtype in GLOBAL_SHAPES:
        assert pk.variant(n, 1, dtype) == "global", (n, dtype)
    for n, r, dtype, want in EARLIER:
        assert pk.variant(n, r, dtype) == want, (n, r, dtype)


def test_block_variant_keeps_what_fits_its_shared_memory():
    """The last float64 K1 system the block variant holds is 168 rows
    (231,184 of 232,448 bytes: 169 rows of stride 170, 168 pivots); 169
    rows is the first beyond it; float32 crosses at 236 / 237 rows."""
    assert pk.block_smem(168, 1, 8) == 8 * (169 * 170 + 168)
    assert pk.block_smem(168, 1, 8) <= pk.MAX_SMEM < pk.block_smem(169, 1, 8)
    assert (pk.variant(168, 1, torch.float64),
            pk.variant(169, 1, torch.float64)) == ("block", "global")
    assert (pk.variant(236, 1, torch.float32),
            pk.variant(237, 1, torch.float32)) == ("block", "global")
    # K2 sizes: the block variant adds the n x r panel
    assert pk.block_smem(160, 27, 8) == 8 * (160 * 162 + 160 + 160 * 27)
    assert pk.variant(160, 27, torch.float64) == "global"
    assert pk.variant(120, 27, torch.float64) == "block"


def _emulate(H, G):
    """The global kernel's loops in numpy, one system: the workspace A
    (n + r rows of n: H's lower triangle, then G'), panels of NB columns
    staged, factored column by column and written back, the trailing
    lower triangle and the augmented rows updated from each panel, then
    the backward substitution over z = (L^-1 G)'.  Entries the kernel never
    writes are NaN, so that reading one shows."""
    n, r = G.shape
    m = n + r
    A = np.full((m, n), np.nan)
    for i in range(n):
        A[i, :i + 1] = H[i, :i + 1]
    flat = G.reshape(-1)
    for e in range(n * r):
        A[n + e % r, e // r] = flat[e]
    dinv = np.zeros(n)
    for k0 in range(0, n, NB):
        nb = min(NB, n - k0)
        rows = m - k0
        P = np.full((rows, NB + 1), np.nan)
        for i in range(rows):
            P[i, :min(i, nb - 1) + 1] = A[k0 + i, k0:k0 + min(i, nb - 1) + 1]
        for j in range(nb):
            d = P[j, j]
            inv = 1.0 / np.sqrt(d)
            P[j + 1:rows, j] *= inv
            P[j, j] = d * inv
            dinv[k0 + j] = inv
            for i in range(j + 1, rows):
                t = np.arange(j + 1, min(i, nb - 1) + 1)
                P[i, t] -= P[i, j] * P[t, j]
        for i in range(rows):
            A[k0 + i, k0:k0 + min(i, nb - 1) + 1] = P[i, :min(i, nb - 1) + 1]
        for i in range(k0 + nb, m):
            c = np.arange(k0 + nb, min(i, n - 1) + 1)
            A[i, c] -= P[c - k0, :nb] @ P[i - k0, :nb]
    Z = A[n:].copy()
    X = np.zeros((n, r))
    for i in range(n - 1, -1, -1):
        xi = Z[:, i] * dinv[i]
        Z[:, :i] -= np.outer(xi, A[i, :i])
        X[i] = xi
    return X


@pytest.mark.parametrize("n,r", [(5, 1), (32, 1), (33, 2), (70, 3),
                                 (186, 1)])
def test_emulated_kernel_solves(n, r):
    rng = np.random.default_rng(n + r)
    M = rng.standard_normal((n, n))
    H = M @ M.T / n + np.eye(n)
    G = rng.standard_normal((n, r))
    X = _emulate(H, G)
    want = np.linalg.solve(H, G)
    assert np.isfinite(X).all()
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
@pytest.mark.parametrize("N,n,dtype", GLOBAL_SHAPES)
def test_cuda_global_variant_matches_plain(cuda_device, N, n, dtype):
    H, G = _card(N, n, 1, n, cuda_device, dtype)
    g = G[..., 0].contiguous()
    before = pk.psd_solve.launches
    got = pk.psd_solve(H, g)
    torch.cuda.synchronize()
    assert pk.psd_solve.launches == before + 1
    _close(got, pk.psd_solve_plain(H, g), dtype, (N, n))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_global_variant_with_several_right_hand_sides(cuda_device,
                                                           dtype):
    """r > 1 (K2's wrapper) beyond shared memory, n not a multiple of the
    panel width, r above the 32 lanes of a warp."""
    for N, n, r in ((2, 250, 3), (1, 240, 40), (3, 300, 2)):
        H, G = _card(N, n, r, n + r, cuda_device, dtype)
        assert pk.variant(n, r, dtype) == "global"
        got = pk.psd_solve_multi(H[:, None], G[:, None])[:, 0]
        _close(got, pk.psd_solve_multi_plain(H, G), dtype, (N, n, r))


@pytest.mark.gpu
def test_cuda_global_variant_kernel_name_and_graph(cuda_device):
    """The launched kernel is ``chol_global_kernel``; captured in a CUDA
    graph (its workspace from the graph's pool) a replay gives the eager
    result bit for bit, on new inputs copied into the graph's own."""
    from torch.profiler import ProfilerActivity, profile
    from omg_tools_torch.ops.alm import CapturedCall
    H, G = _card(1, 186, 1, 7, cuda_device, torch.float64)
    g = G[..., 0].contiguous()
    pk.psd_solve(H, g)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pk.psd_solve(H, g)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if "chol" in e.key}
    assert len(names) == 1 and "chol_global_kernel<double>" in names.pop()
    call = CapturedCall(lambda h, v: (pk.psd_solve(h, v),), (H, g))
    assert call.k1_launches == 1
    H2, G2 = _card(1, 186, 1, 8, cuda_device, torch.float64)
    for h, v in ((H, g), (H2, G2[..., 0].contiguous())):
        eager = pk.psd_solve(h, v)
        (replayed,) = call(h, v)
        torch.cuda.synchronize()
        assert torch.equal(eager, replayed)


@pytest.mark.gpu
def test_cuda_global_variant_non_spd_and_refusals(cuda_device):
    """A non-SPD system among SPD ones is non-finite and leaves the others
    right; the entry point refuses an empty batch and a system whose staged
    panel exceeds shared memory (n + r = 1,000 float64 rows), launching
    nothing."""
    from omg_tools_torch.ops import _build
    H, G = _card(3, 190, 1, 9, cuda_device, torch.float64)
    H[1, 4, 4] = -50.0
    g = G[..., 0].contiguous()
    got = pk.psd_solve(H, g)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(got[1]).all())
    keep = torch.tensor([0, 2], device=cuda_device)
    _close(got[keep], pk.psd_solve_plain(H[keep], g[keep]), torch.float64,
           "non-SPD neighbour")
    fn = _build.load("chol_solve_f64").omg_chol_solve_ws_f64
    stream = torch.cuda.current_stream().cuda_stream
    for N, n in ((0, 190), (1, 999)):
        H, G = _card(1, n, 1, 10, cuda_device, torch.float64)
        X = torch.full_like(G, 7.0)
        W = torch.empty((n + 1) * n, dtype=torch.float64, device=cuda_device)
        err = fn(H.data_ptr(), G.data_ptr(), X.data_ptr(), W.data_ptr(), N,
                 n, 1, stream)
        torch.cuda.synchronize()
        assert err == 1 and bool((X == 7.0).all()), (N, n, err)

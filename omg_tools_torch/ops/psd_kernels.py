"""Batched SPD solves for the ALM Newton step: K1 (``psd_solve``) and K2
(``psd_solve_multi``), counterparts of the lane-batched Pallas kernels in
``omg_tools_tpu/ops/pallas_kernels.py`` (``_chol_solve_kernel`` and
``_chol_solve_multi_kernel``).

A wrapper given CPU tensors runs its plain PyTorch version; given CUDA
tensors (float32 or float64) it launches the hand-written Hopper kernel of
``csrc/chol_solve.cu`` in the variant that ``variant`` picks, and raises on
what the kernel does not take.  Systems above the register classes take
the tiled variants: ``block`` keeps a system's lower triangle in one CTA's
shared memory, ``global`` spreads a larger one over a thread-block cluster
(2-8 CTAs, each holding some of its column tiles).  Each wrapper counts
its kernel launches in a plain integer attribute, ``launches``; K1 also
counts them by the number of systems a launch solves, in the Counter
``psd_solve.by_systems``.  A K1 call made while a CUDA graph is being
captured launches nothing and counts in ``psd_solve.captured`` (and
``captured_by_systems``) instead, and each replay of that graph adds its
calls to ``launches`` and ``by_systems`` (``ops.alm.CapturedCall``).

A system that is not positive definite gives non-finite output -- rsqrt of
a non-positive pivot -- in both versions, never an error: the ALM's per-lane
non-finite fallback relies on it.
"""

from __future__ import annotations

from collections import Counter

import torch

from . import _build

__all__ = ["psd_solve", "psd_solve_multi", "psd_solve_plain",
           "psd_solve_multi_plain", "chol_solve_plain", "variant"]

# the kernel's variants and the code its C entry point takes for each: the
# register classes by the rows a warp holds (n, plus the augmented row g'
# when r = 1; float64 has the 64-row class only), then one system a CTA,
# its column tiles in shared memory, then one system a cluster of CTAs
VARIANTS = {"reg32": 32, "reg48": 48, "reg64": 64, "block": 0, "global": 1}
_CLASSES = {torch.float32: ("reg32", "reg48", "reg64"),
            torch.float64: ("reg64",)}
# the library (``csrc/<name>.cu``) and C entry point of each element type
_ENTRY = {torch.float32: ("chol_solve", "omg_chol_solve_f32"),
          torch.float64: ("chol_solve_f64", "omg_chol_solve_f64")}
# a block's shared memory on sm_90 (kMaxSmem in csrc/chol_solve.cu), and
# the block variant's constants (kTileSmem, kTB, kSLD, kMaxTiles there);
# the cluster's layout is the C side's alone
MAX_SMEM = 232448
TILE_SMEM = MAX_SMEM - 1024
TILE = 32
TILE_SCRATCH_LD = TILE + 4
MAX_TILES = 64


def chol_solve_plain(H, G):
    """The kernels' arithmetic in tensor ops: H (N, n, n), G (N, n, r) ->
    X (N, n, r).  Masked right-looking Cholesky in place (only the lower
    triangle of H is read), then forward and backward substitution."""
    n = H.shape[-1]
    L = H.clone()      # the upper triangle is updated but never read
    for j in range(n):
        inv = torch.rsqrt(L[:, j, j])
        L[:, j:, j] = L[:, j:, j] * inv[:, None]
        s = L[:, j + 1:, j]
        L[:, j + 1:, j + 1:] -= s[:, :, None] * s[:, None, :]
    Z = G.clone()
    for i in range(n):
        acc = (L[:, i, :i, None] * Z[:, :i]).sum(1)
        Z[:, i] = (Z[:, i] - acc) / L[:, i, i, None]
    for i in range(n - 1, -1, -1):
        acc = (L[:, i + 1:, i, None] * Z[:, i + 1:]).sum(1)
        Z[:, i] = (Z[:, i] - acc) / L[:, i, i, None]
    return Z


def psd_solve_plain(H, g):
    """Plain version of K1: H (..., n, n), g (..., n) -> dx (..., n)."""
    n = H.shape[-1]
    X = chol_solve_plain(H.reshape(-1, n, n), g.reshape(-1, n, 1))
    return X.reshape(g.shape)


def psd_solve_multi_plain(D, G):
    """Plain version of K2: D (..., n, n), G (..., n, r) -> X (..., n, r)."""
    n, r = G.shape[-2], G.shape[-1]
    X = chol_solve_plain(D.reshape(-1, n, n), G.reshape(-1, n, r))
    return X.reshape(G.shape)


def _round4(x):
    return -(-x // 4) * 4


def tile_ld(m, j, itemsize):
    """Tile j's column stride (elements): rows j TILE .. m - 1 rounded up
    to 4, then to an odd number of 16-byte units (``tile_ld``)."""
    w = 16 // itemsize
    ld = _round4(m - j * TILE)
    if (ld // w) % 2 == 0:
        ld += w
    return ld


def block_smem(n, r, itemsize):
    """The dynamic shared bytes of the block variant at (n, r), as
    ``tile_smem`` counts them on one CTA: all of the system's tiles, the
    diagonal block's scratch, the inverse pivots, one tile's x."""
    m = n + r
    tiles = sum(TILE * tile_ld(m, j, itemsize)
                for j in range(-(-n // TILE)))
    return itemsize * (tiles + TILE * TILE_SCRATCH_LD + _round4(n)
                       + TILE * r)


def variant(n, r, dtype=torch.float32):
    """The kernel variant that solves (n, n) systems with r right-hand
    sides: the smallest register class of ``dtype`` that holds n rows
    (n + 1 for r = 1, whose right-hand side rides along as an augmented
    row), else ``block`` where the system's tiles fit one CTA's shared
    memory, else ``global``.  The C entry point checks again and refuses
    a system its variant does not take (the global one: beyond a cluster
    of 8 CTAs, ~439 float64 or ~691 float32 rows)."""
    if dtype not in _ENTRY:
        raise TypeError(f"the kernels take float32 or float64, not {dtype}")
    rows = n + (r == 1)
    for name in _CLASSES[dtype]:
        if rows <= VARIANTS[name]:
            return name
    itemsize = torch.empty((), dtype=dtype).element_size()
    fits = n <= MAX_TILES * TILE and block_smem(n, r, itemsize) <= TILE_SMEM
    return "block" if fits else "global"


def _check(H, R):
    for name, t in (("H", H), ("rhs", R)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in _ENTRY:
            raise TypeError(f"{name} must be float32 or float64, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if H.dtype != R.dtype:
        raise TypeError(f"H is {H.dtype}, rhs {R.dtype}")
    if H.device != R.device:
        raise ValueError("H and rhs lie on different devices")


def _launch(H, R, out, N, n, r):
    """Launch through the C entry point in the variant ``variant`` picks;
    it refuses (cudaErrorInvalidValue, nothing launched) a variant that
    does not fit, such as a system too large for a cluster."""
    source, entry = _ENTRY[H.dtype]
    lib = _build.load(source)
    stream = torch.cuda.current_stream(H.device).cuda_stream
    err = getattr(lib, entry)(H.data_ptr(), R.data_ptr(), out.data_ptr(), N,
                              n, r, VARIANTS[variant(n, r, H.dtype)], stream)
    if err != 0:
        raise RuntimeError(f"chol_solve kernel launch failed (cudaError {err})")


def psd_solve(H, g):
    """Solve H[b] dx[b] = g[b]: H (..., n, n), g (..., n) -> dx (..., n).
    K1 on CUDA tensors, its plain version on CPU tensors."""
    if H.device.type == "cpu" and g.device.type == "cpu":
        return psd_solve_plain(H, g)
    n = H.shape[-1]
    if H.shape[-2] != n or g.shape[-1] != n or H.shape[:-2] != g.shape[:-1]:
        raise ValueError(f"shape mismatch: H {tuple(H.shape)}, "
                         f"g {tuple(g.shape)}")
    _check(H, g)
    out = torch.empty_like(g)
    N = g.numel() // n if n else 0
    if N == 0:
        return out
    _launch(H, g, out, N, n, 1)
    if torch.cuda.is_current_stream_capturing():
        psd_solve.captured += 1     # launched by each replay of the graph
        psd_solve.captured_by_systems[N] += 1
    else:
        psd_solve.launches += 1
        psd_solve.by_systems[N] += 1
    return out


def psd_solve_multi(D, G):
    """Solve D[b] X[b] = G[b]: D (..., n, n), G (..., n, r) -> X (..., n, r)
    (the block-arrow step passes (B, k, b, b) tail blocks with (B, k, b,
    h+1) panels).  K2 on CUDA tensors, its plain version on CPU tensors."""
    if D.device.type == "cpu" and G.device.type == "cpu":
        return psd_solve_multi_plain(D, G)
    n, r = G.shape[-2], G.shape[-1]
    if D.shape[-1] != n or D.shape[-2] != n or D.shape[:-2] != G.shape[:-2]:
        raise ValueError(f"shape mismatch: D {tuple(D.shape)}, "
                         f"G {tuple(G.shape)}")
    _check(D, G)
    out = torch.empty_like(G)
    N = G.numel() // (n * r) if n * r else 0
    if N == 0:
        return out
    _launch(D, G, out, N, n, r)
    psd_solve_multi.launches += 1
    return out


psd_solve.launches = 0
psd_solve.by_systems = Counter()
psd_solve.captured = 0
psd_solve.captured_by_systems = Counter()
psd_solve_multi.launches = 0

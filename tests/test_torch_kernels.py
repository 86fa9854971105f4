"""K1/K2 of the torch port (omg_tools_torch/ops/psd_kernels.py).

The plain PyTorch versions are held to the JAX package's lane-batched
Pallas kernels run in interpret mode, float32, at the shapes of
tests/test_pallas_kernels.py plus the main-path tail/head shapes and the
edges of the kernel's size classes (n = 32, 33, 64; r = 32, 33), with the
same tolerance: max |diff| <= 5e-5 * max |want|; in float64 to
``numpy.linalg.solve``.  The CUDA kernels (float32 and float64) are held
to the plain versions on the card (tests marked ``gpu``, skipped without
one): every size class and its edges, ragged batches, element-aligned
slices, a non-SPD system among SPD ones, and what the C entry point must
refuse.  The JAX package is imported by a fixture, so that the ``gpu`` tests
also run where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from omg_tools_torch.ops import psd_kernels as pk

pytestmark = pytest.mark.fast

TOL = 5e-5
TOL_F64 = 1e-10
K1_SHAPES = [(3, 8), (5, 23), (2, 151), (130, 17)]
# the JAX test's multi-RHS shapes, plus the main path's head (n=26, r=1)
# and tail-block (n=33, r=h+1=27) systems
K2_SHAPES = [(3, 8, 4), (5, 23, 11), (130, 17, 9), (6, 26, 1), (10, 33, 27)]
# the edges of the kernel's register classes (rows n, plus one for r = 1)
EDGE_K1 = [(3, 31), (3, 32), (2, 63), (2, 64)]
EDGE_K2 = [(3, 32, 32), (3, 33, 33), (2, 64, 2), (2, 65, 3)]
# every class and its edges, for the kernels on the card
CARD_N = [1, 8, 26, 31, 32, 33, 64, 65, 151]
CARD_R = [1, 2, 27, 32, 33]
# K1's tiled variants at every shape of a path that runs them and of the
# tests (chip_smoke.py's K1_TILED_SHAPES): (systems, n, dtype, variant)
TILED_SHAPES = [(1, 178, torch.float64, "block"),
                (1, 186, torch.float64, "block"),
                (4, 186, torch.float64, "block"),
                (1, 203, torch.float64, "block"),
                (1, 262, torch.float64, "global"),
                (1, 395, torch.float64, "global"),
                (1, 262, torch.float32, "block"),
                (1, 151, torch.float64, "block"),
                (1, 120, torch.float64, "block"),
                (1, 111, torch.float64, "block"),
                (1, 93, torch.float64, "block"),
                (1, 85, torch.float64, "block"),
                (4, 85, torch.float64, "block"),
                (2, 90, torch.float64, "block"),
                (1024, 190, torch.float32, "block"),
                (256, 190, torch.float32, "block"),
                (4096, 151, torch.float32, "block"),
                (256, 151, torch.float32, "block"),
                (4, 85, torch.float32, "block"),
                (1024, 85, torch.float32, "block")]
# a sweep over the tiled variants' sizes: ragged last tiles (n not a
# multiple of 32), the edges of one CTA (float64 215/216, float32
# 315/316) and clusters of 2-7 CTAs
SWEEP_N = [65, 70, 96, 97, 127, 128, 129, 151, 160, 190, 215, 216, 250,
           290, 315, 316, 330, 395, 420]
# the compact-arrow shapes of bench.py's p2p_3dquadrotor (head 42, tail
# blocks 44 and 14, r = 43) and p2p_dubins (head 54, tail blocks 43, 33,
# 14 and 13, r = 55): (systems, n, r)
BENCH_SHAPES = [(6, 42, 1), (4, 44, 43), (4, 14, 43), (5, 54, 1),
                (5, 43, 55), (5, 33, 55), (5, 14, 55), (5, 13, 55)]


@pytest.fixture(scope="module")
def jk():
    """The JAX package's Pallas kernels (run in interpret mode)."""
    return pytest.importorskip("omg_tools_tpu.ops.pallas_kernels")


def _spd(B, n, r, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n)).astype(dtype)
    H = np.einsum("bij,bkj->bik", A, A) + 3 * np.eye(n, dtype=dtype)
    G = rng.standard_normal((B, n, r)).astype(dtype)
    return H, G


@pytest.mark.parametrize("B,n", K1_SHAPES)
def test_psd_solve_plain_matches_jax_interpret(jk, B, n):
    H, G = _spd(B, n, 1, seed=0)
    g = G[..., 0]
    want = np.asarray(jk.batched_psd_solve(H, g, interpret=True))
    got = pk.psd_solve(torch.as_tensor(H), torch.as_tensor(g)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL * np.max(np.abs(want)))


@pytest.mark.parametrize("B,n,r", K2_SHAPES)
def test_psd_solve_multi_plain_matches_jax_interpret(jk, B, n, r):
    H, G = _spd(B, n, r, seed=1)
    want = np.asarray(jk.batched_psd_solve_multi(H, G, interpret=True))
    # the arrow step's call layout: (B, k, n, n) blocks with (B, k, n, r)
    got = pk.psd_solve_multi(torch.as_tensor(H)[:, None],
                             torch.as_tensor(G)[:, None])[:, 0].numpy()
    np.testing.assert_allclose(got, want, atol=TOL * np.max(np.abs(want)))


@pytest.mark.parametrize("multi", [False, True])
def test_non_spd_gives_non_finite(jk, multi):
    """A negative pivot makes both versions non-finite (no error): the
    ALM's per-lane fallback depends on it.  Lane 1 stays SPD and finite."""
    H, G = _spd(2, 9, 3, seed=2)
    H[0, 4, 4] = -50.0
    if multi:
        want = np.asarray(jk.batched_psd_solve_multi(H, G, interpret=True))
        got = pk.psd_solve_multi(torch.as_tensor(H),
                                 torch.as_tensor(G)).numpy()
    else:
        want = np.asarray(jk.batched_psd_solve(H, G[..., 0],
                                               interpret=True))
        got = pk.psd_solve(torch.as_tensor(H),
                           torch.as_tensor(G[..., 0])).numpy()
    assert not np.isfinite(want[0]).all()
    assert not np.isfinite(got[0]).all()
    assert np.isfinite(got[1]).all()
    np.testing.assert_allclose(got[1], want[1],
                               atol=TOL * np.max(np.abs(want[1])))


@pytest.mark.parametrize("B,n", EDGE_K1)
def test_psd_solve_plain_matches_jax_interpret_at_class_edges(jk, B, n):
    H, G = _spd(B, n, 1, seed=6)
    want = np.asarray(jk.batched_psd_solve(H, G[..., 0], interpret=True))
    got = pk.psd_solve(torch.as_tensor(H), torch.as_tensor(G[..., 0]))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=TOL * np.max(np.abs(want)))


@pytest.mark.parametrize("B,n,r", EDGE_K2)
def test_psd_solve_multi_plain_matches_jax_interpret_at_class_edges(
        jk, B, n, r):
    H, G = _spd(B, n, r, seed=7)
    want = np.asarray(jk.batched_psd_solve_multi(H, G, interpret=True))
    got = pk.psd_solve_multi(torch.as_tensor(H), torch.as_tensor(G))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=TOL * np.max(np.abs(want)))


@pytest.mark.parametrize("B,n,r", BENCH_SHAPES)
def test_plain_matches_jax_interpret_at_bench_shapes(jk, B, n, r):
    """The plain versions at the shapes of the quadrotor and Dubins plans
    against the JAX package's kernels in interpret mode, float32."""
    H, G = _spd(B, n, r, seed=9)
    if r == 1:
        want = np.asarray(jk.batched_psd_solve(H, G[..., 0], interpret=True))
        got = pk.psd_solve(torch.as_tensor(H), torch.as_tensor(G[..., 0]))
    else:
        want = np.asarray(jk.batched_psd_solve_multi(H, G, interpret=True))
        got = pk.psd_solve_multi(torch.as_tensor(H), torch.as_tensor(G))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=TOL * np.max(np.abs(want)))


@pytest.mark.parametrize("B,n,r", [(4, 1, 1), (5, 26, 1), (3, 33, 27),
                                   (2, 65, 33), (2, 151, 2)])
def test_plain_f64_matches_numpy_solve(B, n, r):
    H, G = _spd(B, n, r, seed=8, dtype=np.float64)
    got = pk.psd_solve_multi(torch.as_tensor(H), torch.as_tensor(G))
    want = np.linalg.solve(H, G)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=TOL_F64 * np.max(np.abs(want)))


def test_variant_picks_the_size_class():
    """The register class that holds n rows (n + 1 when r = 1: the
    right-hand side rides along as a row), else the block variant (a
    system's column tiles in one CTA's shared memory), else the global
    one (a cluster's); float64 has the 64-row class only; other types are
    refused.  Each shape of the paths above the classes takes ``block``
    but the 262- and 395-row float64 systems."""
    f32, f64 = torch.float32, torch.float64
    assert pk.variant(26, 1, f32) == "reg32"        # K1, main path
    assert pk.variant(33, 27, f32) == "reg48"       # K2, main path
    assert pk.variant(151, 1, f32) == "block"       # dense / generic modes
    assert [pk.variant(n, 1, f32) for n in (31, 32, 47, 48, 63, 64)] == [
        "reg32", "reg48", "reg48", "reg64", "reg64", "block"]
    assert [pk.variant(n, 2, f32) for n in (32, 33, 48, 49, 64, 65)] == [
        "reg32", "reg48", "reg48", "reg64", "reg64", "block"]
    assert pk.variant(26, 1, f64) == pk.variant(33, 27, f64) == "reg64"
    assert pk.variant(64, 1, f64) == "block"
    for N, n, dtype, want in TILED_SHAPES:
        assert pk.variant(n, 1, dtype) == want, (N, n, dtype)
    assert [pk.variant(n, 1, f64) for n in (215, 216)] == ["block", "global"]
    assert [pk.variant(n, 1, f32) for n in (315, 316)] == ["block", "global"]
    with pytest.raises(TypeError):
        pk.variant(8, 1, torch.float16)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrappers run the plain version and count no
    kernel launch; a float64 CPU call keeps float64."""
    H, G = _spd(4, 7, 2, seed=3, dtype=np.float64)
    before = (pk.psd_solve.launches, pk.psd_solve_multi.launches)
    x = pk.psd_solve_multi(torch.as_tensor(H), torch.as_tensor(G))
    dx = pk.psd_solve(torch.as_tensor(H), torch.as_tensor(G[..., 0]))
    assert (pk.psd_solve.launches, pk.psd_solve_multi.launches) == before
    assert x.dtype == dx.dtype == torch.float64
    want = np.linalg.solve(H, G)
    np.testing.assert_allclose(x.numpy(), want, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(dx.numpy(), want[..., 0], rtol=1e-10,
                               atol=1e-12)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run on the card only")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("multi", [False, True])
def test_cuda_kernel_matches_plain(cuda_device, multi):
    shapes = K2_SHAPES if multi else [(B, n, 1) for (B, n) in K1_SHAPES]
    for (B, n, r) in shapes:
        H, G = _spd(B, n, r, seed=4)
        Hd = torch.as_tensor(H, device=cuda_device)
        Gd = torch.as_tensor(G, device=cuda_device)
        if multi:
            before = pk.psd_solve_multi.launches
            got = pk.psd_solve_multi(Hd, Gd)
            want = pk.psd_solve_multi_plain(Hd, Gd)
            assert pk.psd_solve_multi.launches == before + 1
        else:
            g = Gd[..., 0].contiguous()
            before = pk.psd_solve.launches
            got = pk.psd_solve(Hd, g)
            want = pk.psd_solve_plain(Hd, g)
            assert pk.psd_solve.launches == before + 1
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= TOL * scale, (B, n, r)


@pytest.mark.gpu
def test_cuda_kernel_non_spd_gives_non_finite(cuda_device):
    H, G = _spd(2, 9, 3, seed=2)
    H[0, 4, 4] = -50.0
    Hd = torch.as_tensor(H, device=cuda_device)
    Gd = torch.as_tensor(G, device=cuda_device)
    for got in (pk.psd_solve_multi(Hd, Gd),
                pk.psd_solve(Hd, Gd[..., 0].contiguous())):
        torch.cuda.synchronize()
        assert not bool(torch.isfinite(got[0]).all())
        assert bool(torch.isfinite(got[1]).all())


@pytest.mark.gpu
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    H, G = _spd(3, 8, 4, seed=5)
    Hd = torch.as_tensor(H, device=cuda_device)
    Gd = torch.as_tensor(G, device=cuda_device)
    with pytest.raises(TypeError):
        pk.psd_solve_multi(Hd.half(), Gd.half())
    with pytest.raises(TypeError):
        pk.psd_solve_multi(Hd.double(), Gd)
    with pytest.raises(ValueError):
        pk.psd_solve_multi(Hd, Gd.transpose(-1, -2).contiguous()
                           .transpose(-1, -2))
    with pytest.raises(ValueError):
        pk.psd_solve(Hd, Gd[..., :3, 0].contiguous())
    # too large for the kernel's shared-memory layouts (since the tiled
    # variants, 2,000 float32 rows exceed a cluster of 8 CTAs): the C
    # entry point refuses it and nothing is launched
    before = pk.psd_solve.launches
    big = torch.eye(2000, device=cuda_device)[None].contiguous()
    assert pk.variant(2000, 1, torch.float32) == "global"
    with pytest.raises(RuntimeError, match="cudaError"):
        pk.psd_solve(big, torch.ones((1, 2000), device=cuda_device))
    assert pk.psd_solve.launches == before


def _card(B, n, r, seed, device, dtype=np.float32):
    H, G = _spd(B, n, r, seed, dtype=dtype)
    return (torch.as_tensor(H, device=device),
            torch.as_tensor(G, device=device))


def _solve(H, G):
    """The kernel through its wrapper (K1 for r = 1) and the plain version
    on the same card tensors; asserts one launch."""
    if G.shape[-1] == 1:
        g = G[..., 0].contiguous()
        before = pk.psd_solve.launches
        got, want = pk.psd_solve(H, g), pk.psd_solve_plain(H, g)
        assert pk.psd_solve.launches == before + 1
    else:
        before = pk.psd_solve_multi.launches
        got, want = pk.psd_solve_multi(H, G), pk.psd_solve_multi_plain(H, G)
        assert pk.psd_solve_multi.launches == before + 1
    torch.cuda.synchronize()
    return got, want


def _assert_close(got, want, tol, what):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("multi", [False, True])
def test_cuda_kernel_f64_matches_plain(cuda_device, multi):
    shapes = K2_SHAPES if multi else [(B, n, 1) for (B, n) in K1_SHAPES]
    for (B, n, r) in shapes:
        H, G = _card(B, n, r, 4, cuda_device, np.float64)
        got, want = _solve(H, G)
        assert got.dtype == torch.float64
        _assert_close(got, want, TOL_F64, (B, n, r))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("r", CARD_R)
def test_cuda_kernel_every_size_class(cuda_device, r, dtype):
    tol = TOL if dtype == np.float32 else TOL_F64
    for n in CARD_N:
        H, G = _card(5, n, r, n + r, cuda_device, dtype)
        got, want = _solve(H, G)
        _assert_close(got, want, tol, (n, r, pk.variant(n, r, H.dtype)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_kernel_at_bench_shapes(cuda_device, dtype):
    """K1/K2 at the shapes of the quadrotor and Dubins plans, and at their
    rollouts' widths (4096 lanes of the head, the padded tail blocks of
    every lane), against the plain versions."""
    tol = TOL if dtype == np.float32 else TOL_F64
    shapes = BENCH_SHAPES + [(4096, 42, 1), (16384, 44, 43), (4096, 54, 1),
                             (20480, 43, 55)]
    for (B, n, r) in shapes:
        H, G = _card(B, n, r, n + r, cuda_device, dtype)
        got, want = _solve(H, G)
        _assert_close(got, want, tol, (B, n, r, pk.variant(n, r, H.dtype)))


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 3, 5, 4097, 20481])
def test_cuda_kernel_ragged_batches(cuda_device, N):
    """Batches that are no multiple of the warps a block, or of the warps
    resident on the card (each then walks a ragged number of systems)."""
    for (n, r) in ((26, 1), (33, 27)):
        H, G = _card(N, n, r, N, cuda_device)
        got, want = _solve(H, G)
        _assert_close(got, want, TOL, (N, n, r))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cuda_kernel_takes_element_aligned_slices(cuda_device, dtype):
    """H[1:] and G[1:] of contiguous batches: data pointers aligned to
    one element only, not to 16 bytes."""
    tol = TOL if dtype == np.float32 else TOL_F64
    for (n, r) in ((25, 1), (33, 27), (9, 3)):   # odd n: unaligned slices
        H, G = _card(66, n, r, n, cuda_device, dtype)
        Hs, Gs = H[1:], G[1:]
        assert Hs.is_contiguous() and Hs.data_ptr() % 16 != 0
        got, want = _solve(Hs, Gs)
        _assert_close(got, want, tol, (n, r))


@pytest.mark.gpu
def test_cuda_kernel_non_spd_among_spd(cuda_device):
    """One non-SPD system among 64 SPD ones of the same launch gives a
    non-finite solution; every other stays finite and right."""
    for (n, r) in ((26, 1), (33, 27), (70, 2)):
        H, G = _spd(64, n, r, seed=9)
        H[37, 5, 5] = -50.0
        got, want = _solve(torch.as_tensor(H, device=cuda_device),
                           torch.as_tensor(G, device=cuda_device))
        assert not bool(torch.isfinite(got[37]).all()), (n, r)
        keep = torch.arange(64, device=cuda_device) != 37
        assert bool(torch.isfinite(got[keep]).all()), (n, r)
        _assert_close(got[keep], want[keep], TOL, (n, r))


@pytest.mark.gpu
def test_cuda_kernel_runs_the_variant_it_picks(cuda_device):
    """The launched kernel is the instance of the class ``variant`` names."""
    from torch.profiler import ProfilerActivity, profile
    cases = [((26, 1), np.float32, "chol_warp_kernel<float, 32, true>"),
             ((33, 27), np.float32, "chol_warp_kernel<float, 48, false>"),
             ((50, 2), np.float32, "chol_warp_kernel<float, 64, false>"),
             ((151, 1), np.float32, "chol_tile_kernel<float>"),
             ((33, 27), np.float64, "chol_warp_kernel<double, 64, false>"),
             ((70, 3), np.float64, "chol_tile_kernel<double>"),
             ((262, 1), np.float64, "chol_tile_kernel<double>")]
    for (n, r), dtype, want in cases:
        H, G = _card(4, n, r, 10, cuda_device, dtype)
        _solve(H, G)                       # built and warm
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                _solve(H, G)
        names = {e.key for e in prof.key_averages() if "chol" in e.key}
        assert len(names) == 1 and want in names.pop(), (n, r, dtype)


@pytest.mark.gpu
def test_cuda_entry_point_refuses_what_does_not_fit(cuda_device):
    """A variant too small for n, an unknown variant, a class float64 does
    not have, an empty batch and a system too large for one CTA's shared
    memory (the block variant) or a cluster's (the global one):
    cudaErrorInvalidValue (1), nothing launched, the output left as it
    was."""
    from omg_tools_torch.ops import _build
    stream = torch.cuda.current_stream().cuda_stream
    cases = [(np.float32, 33, 27, 5, 32), (np.float32, 49, 2, 5, 48),
             (np.float32, 32, 1, 5, 32), (np.float32, 8, 4, 5, 7),
             (np.float64, 8, 4, 5, 32), (np.float32, 8, 4, 0, 32),
             (np.float32, 340, 1, 1, 0), (np.float64, 220, 1, 1, 0),
             (np.float64, 460, 1, 1, 1), (np.float32, 8, 4, 5, 2)]
    for dtype, n, r, N, var in cases:
        H, G = _card(max(N, 1), n, r, 11, cuda_device, dtype)
        X = torch.full_like(G, 7.0)
        fn = (_build.load("chol_solve").omg_chol_solve_f32
              if dtype == np.float32
              else _build.load("chol_solve_f64").omg_chol_solve_f64)
        err = fn(H.data_ptr(), G.data_ptr(), X.data_ptr(), N, n, r, var,
                 stream)
        torch.cuda.synchronize()
        assert err == 1, (dtype, n, r, N, var, err)
        assert bool((X == 7.0).all()), (dtype, n, r, N, var)


@pytest.mark.gpu
def test_cuda_problem_solve_matches_cpu(cuda_device):
    """Problem.solve on the card in float64 (a batch of one: K1's block
    variant at n = 151) against the port on the CPU, on bench.py's scene in
    the dense quadratic mode: the cold solve's first 11 Newton iterations
    (the solve amplifies rounding from its twelfth on, see
    tests/test_torch_closed_loop.py) within 1e-8, with K1 launched."""
    from omg_tools_torch.tools.parity import build_p2p_holonomic
    assert pk.variant(151, 1, torch.float64) == "block"
    states = {}
    for dev in ("cpu", cuda_device):
        problem = build_p2p_holonomic(
            solver_options={"outer_iter": 1, "inner_iter": 11},
            options={"device": dev, "exploit_structure": True})
        assert problem._structure == "quadratic"
        problem.initialize(0.0)
        problem.predict(0.0, 0.1, 0.01)
        solver, calls = problem._solver, []

        def record(*args, **kwargs):
            calls.append(solver(*args, **kwargs))
            return calls[-1]
        problem._solver = record
        before = pk.psd_solve.launches
        problem.solve(0.0, 0.1)
        launches = pk.psd_solve.launches - before
        states[str(dev)] = calls[0]
    assert launches >= 11, launches
    got, want = states[str(cuda_device)], states["cpu"]
    assert got.x.is_cuda and got.x.dtype == torch.float64
    np.testing.assert_allclose(got.x.cpu().numpy(), want.x.numpy(), rtol=0,
                               atol=1e-8)


# -- K1's tiled variants (block and global) on the card ----------------------

def _tiled(N, n, r, dtype, device, seed):
    """SPD systems in ``dtype`` (a torch type) on the card, from numpy."""
    H, G = _spd(N, n, r, seed, dtype=np.float64)
    H = H / n + np.eye(n)
    return (torch.as_tensor(H, device=device, dtype=dtype),
            torch.as_tensor(G, device=device, dtype=dtype))


def _tol(dtype):
    return TOL_F64 if dtype == torch.float64 else TOL


@pytest.mark.gpu
@pytest.mark.parametrize("N,n,dtype,variant", TILED_SHAPES)
def test_cuda_tiled_variants_at_the_path_shapes(cuda_device, N, n, dtype,
                                                variant):
    """K1 at every shape of a path that runs the tiled variants, in the
    variant ``variant`` picks, against the plain version."""
    H, G = _tiled(N, n, 1, dtype, cuda_device, n)
    assert pk.variant(n, 1, dtype) == variant
    got, want = _solve(H, G)
    _assert_close(got, want, _tol(dtype), (N, n, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_tiled_variants_sweep(cuda_device, dtype):
    """n from 65 to 420: ragged last tiles, the edge of one CTA, clusters
    of 2 to 7 CTAs; three systems a launch."""
    for n in SWEEP_N:
        H, G = _tiled(3, n, 1, dtype, cuda_device, n)
        got, want = _solve(H, G)
        _assert_close(got, want, _tol(dtype),
                      (n, pk.variant(n, 1, dtype)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_tiled_variants_several_right_hand_sides(cuda_device, dtype):
    """r > 1 above 64 rows (K2's wrapper): r below, at and above a warp's
    32 lanes, the right-hand sides as r more rows of every tile."""
    for n, r in ((65, 2), (70, 27), (151, 33), (200, 40), (250, 3),
                 (395, 5)):
        H, G = _tiled(2, n, r, dtype, cuda_device, n + r)
        got, want = _solve(H, G)
        _assert_close(got, want, _tol(dtype),
                      (n, r, pk.variant(n, r, dtype)))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [85, 151, 262, 395])
def test_cuda_tiled_variants_non_spd_among_spd(cuda_device, n):
    """One non-SPD system among eight gives a non-finite solution; every
    other stays finite and right (one CTA a system, or a cluster)."""
    H, G = _tiled(8, n, 1, torch.float64, cuda_device, n)
    H[5, n // 2, n // 2] = -50.0
    got, want = _solve(H, G)
    assert not bool(torch.isfinite(got[5]).all()), n
    keep = torch.arange(8, device=cuda_device) != 5
    assert bool(torch.isfinite(got[keep]).all()), n
    _assert_close(got[keep], want[keep], TOL_F64, n)


@pytest.mark.gpu
@pytest.mark.parametrize("N,n,dtype", [(1, 151, torch.float64),
                                       (1, 395, torch.float64),
                                       (1024, 190, torch.float32)])
def test_cuda_tiled_variants_captured_replay_equals_eager(cuda_device, N, n,
                                                          dtype):
    """K1 captured in a CUDA graph (``ops.alm.CapturedCall``, as the closed
    loops replay it): a replay equals the eager call bit for bit, on the
    captured inputs and on new ones copied in; one launch a replay."""
    from omg_tools_torch.ops.alm import CapturedCall
    H, G = _tiled(N, n, 1, dtype, cuda_device, 3)
    g = G[..., 0].contiguous()
    call = CapturedCall(lambda h, v: (pk.psd_solve(h, v),), (H, g))
    assert call.k1_launches == 1
    H2, G2 = _tiled(N, n, 1, dtype, cuda_device, 4)
    for h, v in ((H, g), (H2, G2[..., 0].contiguous())):
        eager = pk.psd_solve(h, v)
        before = pk.psd_solve.launches
        (replayed,) = call(h, v)
        torch.cuda.synchronize()
        assert pk.psd_solve.launches == before + 1
        assert torch.equal(eager, replayed), (N, n, dtype)


@pytest.mark.gpu
def test_cuda_tiled_variants_refuse_what_does_not_fit(cuda_device):
    """Through the wrapper, a system beyond a cluster of 8 CTAs raises
    and launches nothing; through the C entry point, the block variant
    beyond one CTA and the global one beyond 8 CTAs or 2,048 rows are
    refused (cudaErrorInvalidValue), the output left as it was."""
    from omg_tools_torch.ops import _build
    before = pk.psd_solve.launches
    H, G = _tiled(1, 460, 1, torch.float64, cuda_device, 5)
    assert pk.variant(460, 1, torch.float64) == "global"
    with pytest.raises(RuntimeError, match="cudaError"):
        pk.psd_solve(H, G[..., 0].contiguous())
    assert pk.psd_solve.launches == before
    stream = torch.cuda.current_stream().cuda_stream
    for dtype, n, var in ((torch.float64, 216, 0), (torch.float32, 316, 0),
                          (torch.float64, 440, 1), (torch.float32, 692, 1),
                          (torch.float32, 2049, 1)):
        H, G = _tiled(1, n, 1, dtype, cuda_device, 6)
        X = torch.full_like(G, 7.0)
        source, entry = pk._ENTRY[dtype]
        err = getattr(_build.load(source), entry)(
            H.data_ptr(), G.data_ptr(), X.data_ptr(), 1, n, 1, var, stream)
        torch.cuda.synchronize()
        assert err == 1 and bool((X == 7.0).all()), (dtype, n, var, err)

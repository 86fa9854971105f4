"""K1/K2 of the torch port (omg_tools_torch/ops/psd_kernels.py).

The plain PyTorch versions are held to the JAX package's lane-batched
Pallas kernels run in interpret mode, float32, at the shapes of
tests/test_pallas_kernels.py plus the main-path tail/head shapes, with the
same tolerance: max |diff| <= 5e-5 * max |want|.  The CUDA kernels are held
to the plain versions on the card (tests marked ``gpu``, skipped without
one).  The JAX package is imported by a fixture, so that the ``gpu`` tests
also run where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from omg_tools_torch.ops import psd_kernels as pk

pytestmark = pytest.mark.fast

TOL = 5e-5
K1_SHAPES = [(3, 8), (5, 23), (2, 151), (130, 17)]
# the JAX test's multi-RHS shapes, plus the main path's head (n=26, r=1)
# and tail-block (n=33, r=h+1=27) systems
K2_SHAPES = [(3, 8, 4), (5, 23, 11), (130, 17, 9), (6, 26, 1), (10, 33, 27)]


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
        pk.psd_solve_multi(Hd.double(), Gd.double())
    with pytest.raises(ValueError):
        pk.psd_solve_multi(Hd, Gd.transpose(-1, -2).contiguous()
                           .transpose(-1, -2))
    with pytest.raises(ValueError):
        pk.psd_solve(Hd, Gd[..., :3, 0].contiguous())
    # too large for the kernel's shared-memory layout: the C entry point
    # refuses it and nothing is launched
    before = pk.psd_solve.launches
    big = torch.eye(300, device=cuda_device)[None].contiguous()
    with pytest.raises(RuntimeError, match="cudaError"):
        pk.psd_solve(big, torch.ones((1, 300), device=cuda_device))
    assert pk.psd_solve.launches == before

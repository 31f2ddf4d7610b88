"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips, with its reason, on a host without a
CUDA device.  This file imports no JAX (the card's host need not have it):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine as eng
from repro_torch.core import suite, tracegen
from repro_torch.kernels import blackscholes as bs_mod
from repro_torch.kernels import canneal as ca_mod
from repro_torch.kernels import engine_scan, ref
from repro_torch.kernels import particlefilter as pf_mod
from repro_torch.kernels import streamcluster as sc_mod
from repro_torch.kernels import swaptions as sw_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "and run only on the card")
    return torch.device("cuda")


def bs_inputs(n: int, seed: int):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return [rng.uniform(10, 100, n).astype(f32),
            rng.uniform(10, 100, n).astype(f32),
            rng.uniform(0.01, 0.1, n).astype(f32),
            rng.uniform(0.1, 0.6, n).astype(f32),
            rng.uniform(0.2, 2.0, n).astype(f32),
            (rng.uniform(size=n) > 0.5).astype(np.int32)]


@pytest.mark.parametrize("n", [1, 1000, 65_537])
def test_blackscholes_kernel_matches_plain(cuda, n):
    """Ragged sizes (the tail is masked, no tile requirement), 3e-5."""
    args = [torch.from_numpy(a).to(cuda) for a in bs_inputs(n, seed=n)]
    before = bs_mod.blackscholes.launches
    got = bs_mod.blackscholes(*args)
    assert bs_mod.blackscholes.launches == before + 1
    torch.testing.assert_close(got, ref.blackscholes(*args),
                               rtol=3e-5, atol=3e-5)


def test_engine_scan_kernel_matches_plain_bitwise(cuda):
    """Three apps x Table-10 corners, steady-state lanes: every output of
    the kernel equal to the plain version's."""
    cfgs = [eng.VectorEngineConfig(mvl=m, lanes=l, mshrs=k)
            for m in (8, 256) for l in (1, 8) for k in (1, 16)]
    pairs = [(a, c) for a in ("jacobi-2d", "canneal", "swaptions")
             for c in cfgs]
    bodies = [tracegen.body_for(a, suite.effective_mvl(a, c), c)
              for a, c in pairs]
    inp = eng.pack_steady_state(bodies, [c for _, c in pairs], 3, 4, cuda)
    before = engine_scan.scan.launches
    got = engine_scan.scan(*inp.args())
    assert engine_scan.scan.launches == before + 1
    assert torch.equal(got, engine_scan.scan_plain(*inp.args()))


def test_kernel_launch_errors_raise(cuda):
    """A wrapper checks its operands before launching: a CPU operand beside
    CUDA ones is refused, never silently run on the host."""
    args = [torch.from_numpy(a).to(cuda) for a in bs_inputs(8, seed=0)]
    args[2] = args[2].cpu()
    with pytest.raises(ValueError, match="rate on cpu"):
        bs_mod.blackscholes(*args)


@pytest.mark.parametrize("n", [1, 1000, 65_537])
def test_cum_normal_inv_kernel_matches_plain(cuda, n):
    """Ragged sizes, the reference's bar rtol 1e-5 / atol 1e-6."""
    rng = np.random.RandomState(n)
    u = torch.from_numpy(rng.uniform(1e-5, 1 - 1e-5, n).astype(np.float32))
    u = u.to(cuda)
    before = sw_mod.cum_normal_inv.launches
    got = sw_mod.cum_normal_inv(u)
    assert sw_mod.cum_normal_inv.launches == before + 1
    torch.testing.assert_close(got, ref.cum_normal_inv(u), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("m,n,d", [(1, 1, 1), (1000, 129, 128),
                                   (300, 1000, 37), (65_537, 5, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamcluster_kernel_matches_plain(cuda, m, n, d, dtype):
    """M, N and D off the 128 x 128 x 16 tiling; 2e-4 in float32 and 1e-2
    in bfloat16, the reference's bars."""
    rng = np.random.RandomState(m + n + d)
    tdt = getattr(torch, dtype)
    p = torch.from_numpy(rng.uniform(size=(m, d)).astype(np.float32))
    c = torch.from_numpy(rng.uniform(size=(n, d)).astype(np.float32))
    p, c = p.to(cuda, tdt), c.to(cuda, tdt)
    before = sc_mod.streamcluster_dist.launches
    got = sc_mod.streamcluster_dist(p, c)
    assert sc_mod.streamcluster_dist.launches == before + 1
    tol = 1e-2 if dtype == "bfloat16" else 2e-4
    torch.testing.assert_close(got, ref.streamcluster_dist(p, c), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("m", [1, 1000, 65_537])
def test_find_index_kernel_matches_plain_exactly(cuda, m):
    """A monotone CDF of 5,000 entries (not a multiple of the kernel's
    2,048-entry tile) and, for the count semantics, an unsorted one."""
    rng = np.random.RandomState(m)
    u = torch.from_numpy(rng.uniform(size=m).astype(np.float32)).to(cuda)
    raw = rng.uniform(size=5000).astype(np.float32)
    for cdf in (np.sort(raw), raw):
        cdf = torch.from_numpy(cdf).to(cuda)
        before = pf_mod.find_index.launches
        got = pf_mod.find_index(cdf, u)
        assert pf_mod.find_index.launches == before + 1
        assert torch.equal(got, ref.particlefilter_findindex(cdf, u))


@pytest.mark.parametrize("b", [1, 1000, 65_537])
def test_swap_cost_kernel_matches_plain_bitwise(cuda, b):
    """Integer coordinates make every sum exact; -1 padding and indices
    past N (clamped to N-1) included."""
    rng = np.random.RandomState(b)
    N, F = 4000, 22
    locs = rng.randint(0, 1000, (N, 2)).astype(np.float32)
    fan = rng.randint(-1, N + 100, (b, F)).astype(np.int32)
    cand = [rng.randint(0, 1000, (b, 2)).astype(np.float32) for _ in "ab"]
    args = [torch.from_numpy(a).to(cuda) for a in (locs, fan, *cand)]
    before = ca_mod.swap_cost.launches
    got = ca_mod.swap_cost(*args)
    assert ca_mod.swap_cost.launches == before + 1
    for g, w in zip(got, ref.canneal_swap_cost(*args)):
        assert torch.equal(g, w)

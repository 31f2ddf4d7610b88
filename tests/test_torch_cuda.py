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
from repro_torch.kernels import engine_scan, ref

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

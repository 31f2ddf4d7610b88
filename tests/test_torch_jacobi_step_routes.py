"""The one-sweep Jacobi-2D kernel's two routes, on the CPU.

``jacobi2d.step_width`` is the pure function the wrapper picks a route
with, from the grid's columns, its type and the buffers' addresses: 16
bytes' points a chunk (the vector route: 4 float32, 8 bfloat16 or float16)
where C is a multiple of that and every pointer is 16-byte aligned, else
one point a chunk (the width-one route).  Both routes run one kernel with
the plain version's arithmetic, so on the CPU both compute
``ref.jacobi2d``, which is held here against the Pallas kernel in interpret
mode on grids of either route's shapes at 1e-6 (the Pallas kernel sums
its five terms in another order).  On the card the routes are held bit for
bit against the plain version by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import jacobi2d as j2_mod
from repro_torch.kernels import ops, ref

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


@pytest.mark.parametrize("C,dtype,width", [
    (2800, F32, 4), (2800, BF16, 8), (2800, F16, 8),
    (2804, F32, 4), (2804, BF16, 1), (2804, F16, 1),
    (2801, F32, 1), (2801, BF16, 1), (2802, F16, 1),
    (164, F32, 4), (164, F16, 1), (136, BF16, 8),
    (8, BF16, 8), (4, F32, 4), (3, F32, 1), (2, F16, 1), (1, F32, 1)])
def test_step_width_by_columns_and_type(C, dtype, width):
    """C a multiple of 16 bytes' points takes the vector route from aligned
    buffers; any other C the width-one route."""
    assert j2_mod.step_width(C, dtype, 0, 4096) == width


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
def test_step_width_by_alignment(dtype):
    """Every pointer must be 16-byte aligned: a grid one point (or 8 bytes)
    into a buffer, or an output that is, takes the width-one route."""
    v = 16 // dtype.itemsize
    assert j2_mod.step_width(64, dtype, 1024, 2048, 4096) == v
    for off in (dtype.itemsize, 8, 12):
        assert j2_mod.step_width(64, dtype, 1024 + off, 2048) == 1
        assert j2_mod.step_width(64, dtype, 1024, 2048 + off) == 1
        assert j2_mod.step_width(64, dtype, 1024, 2048, 4096 + off) == 1
    assert j2_mod.step_width(64, dtype, 1024 + 16, 2048 + 32) == v


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
def test_step_width_of_views(dtype):
    """Views of one buffer: one point in, the width-one route; 16 bytes in,
    the vector route again; the widths a wrapper would pick."""
    buf = torch.zeros(40 * 64 + 16, dtype=dtype)
    v = 16 // dtype.itemsize
    whole = buf[:40 * 64].view(40, 64)
    one_in = buf[1:40 * 64 + 1].view(40, 64)
    chunk_in = buf[v:40 * 64 + v].view(40, 64)
    assert whole.data_ptr() % 16 == 0
    for grid, want in ((whole, v), (one_in, 1), (chunk_in, v)):
        assert j2_mod.step_width(64, dtype, grid.data_ptr(),
                                 torch.empty_like(grid).data_ptr()) == want


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
@pytest.mark.parametrize("shape", [(40, 64), (33, 137), (2, 16), (3, 3)])
def test_views_sweep_as_their_copies(dtype, shape):
    """A view one point into its buffer (the width-one route on the card)
    sweeps as its contiguous copy does, on the CPU's plain version."""
    rng = np.random.RandomState(sum(shape))
    a = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)
    buf = torch.empty(a.numel() + 1, dtype=dtype)
    view = buf[1:].view(shape)
    view.copy_(a)
    got = j2_mod.jacobi2d_step(view)
    assert got.dtype == dtype and torch.equal(got, ref.jacobi2d(a))
    assert torch.equal(j2_mod.jacobi2d(view, 3), ref.jacobi2d(a, 3))


@pytest.mark.parametrize("shape,rpb", [
    ((66, 256), 64),      # vector route in every type
    ((34, 136), 32),      # 16-bit vector route, float32 too
    ((34, 137), 32),      # C odd: the width-one route
    ((18, 2801), 16),     # PolyBench-wide, C odd
    ((10, 9), 8),         # a strip's lanes mostly idle
    ((6, 4), 4)])         # one float32 chunk a row
def test_plain_version_matches_pallas_interpret(shape, rpb):
    """``ref.jacobi2d`` (what both routes compute) against the Pallas
    kernel in interpret mode, float32, at 1e-6."""
    a = np.random.RandomState(shape[1]).standard_normal(shape).astype(
        np.float32)
    want = np.asarray(ref_ops.jacobi2d_step(a, rows_per_block=rpb,
                                            interpret=True))
    got = ops.jacobi2d_step(a, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, ref.jacobi2d(torch.from_numpy(a)))


def test_wrapper_counts_nothing_on_the_cpu():
    """The CPU path runs the plain version: neither route's counter
    moves."""
    before = (j2_mod.jacobi2d_step.launches,
              j2_mod.jacobi2d_step.width1_launches)
    j2_mod.jacobi2d_step(torch.zeros(5, 9))
    assert (j2_mod.jacobi2d_step.launches,
            j2_mod.jacobi2d_step.width1_launches) == before

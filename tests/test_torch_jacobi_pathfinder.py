"""Port parity: the Jacobi-2D and pathfinder kernels.

On the CPU each ``repro_torch.kernels.ops`` wrapper takes its kernel's
plain PyTorch version, and only because the tensors lie on the CPU.  The
same seeded numpy inputs go through ``repro.kernels.ops`` with
``interpret=True`` (the Pallas kernels on the CPU), at the shapes and bars
of ``tests/test_kernels.py``; shapes the Pallas wrappers reject go against
``repro.kernels.ref``.  The CUDA kernels themselves are held against their
plain versions on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro_torch.kernels import jacobi2d as j2_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import pathfinder as path_mod


def grid(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def wall(shape, seed, dtype="float32"):
    """tests/test_kernels.py's uniform [0, 10) wall, or Rodinia's integer
    ``rand() % 10``."""
    rng = np.random.RandomState(seed)
    if dtype == "int32":
        return rng.randint(0, 10, shape).astype(np.int32)
    return rng.uniform(0, 10, shape).astype(np.float32)


@pytest.mark.parametrize("shape,rpb", [((66, 128), 64), ((130, 256), 32)])
def test_jacobi2d_matches_pallas_interpret(shape, rpb):
    a = grid(shape, seed=shape[0])
    want = np.asarray(ref_ops.jacobi2d_step(a, rows_per_block=rpb,
                                            interpret=True))
    got = ops.jacobi2d_step(torch.from_numpy(a))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, ops.jacobi2d_step(a, device="cpu"))


@pytest.mark.parametrize("shape", [(67, 129), (5, 3), (3, 200), (2, 7),
                                   (9, 1)])
def test_jacobi2d_ragged_matches_reference(shape):
    """Shapes the Pallas wrapper rejects ((R - 2) % rows_per_block != 0, or
    no interior at all) against the reference's own oracle; a grid with no
    interior comes back unchanged."""
    a = grid(shape, seed=sum(shape))
    want = np.asarray(jref.jacobi2d(jnp.asarray(a)))
    got = ops.jacobi2d_step(a, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if min(shape) < 3:
        np.testing.assert_array_equal(got.numpy(), a)


def test_jacobi2d_sweeps_match_reference():
    """Ten sweeps through the wrapper against the reference's ``iters``."""
    a = grid((34, 40), seed=4)
    want = np.asarray(jref.jacobi2d(jnp.asarray(a), iters=10))
    got = torch.from_numpy(a)
    for _ in range(10):
        got = ops.jacobi2d_step(got)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("R,C", [(10, 128), (40, 512)])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_pathfinder_matches_pallas_interpret(R, C, dtype):
    w = wall((R, C), seed=R + C, dtype=dtype)
    want = np.asarray(ref_ops.pathfinder(w, interpret=True))
    got = ops.pathfinder(torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (C,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("R,C", [(1, 5), (2, 1), (23, 3), (45, 1001)])
def test_pathfinder_ragged_matches_reference(R, C):
    """One row (the wall row itself), one column (both neighbours +inf) and
    widths off any tiling, against the reference's oracle; integer walls
    make every sum exact, so the match is exact."""
    w = wall((R, C), seed=R * C, dtype="int32")
    want = np.asarray(jref.pathfinder(jnp.asarray(w)))
    got = ops.pathfinder(w, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_take_plain_path_on_cpu_only():
    a = torch.from_numpy(grid((12, 9), 0))
    w = torch.from_numpy(wall((6, 11), 0, "int32"))
    for fn, arg, plain in ((j2_mod.jacobi2d_step, a, ref.jacobi2d),
                           (path_mod.pathfinder, w, ref.pathfinder)):
        before = fn.launches
        assert torch.equal(fn(arg), plain(arg))
        assert fn.launches == before                 # no kernel launched


def _bad_calls():
    """(wrapper, operand) pairs each of which must raise ValueError."""
    a = torch.from_numpy(grid((12, 10), 0))
    w = torch.from_numpy(wall((6, 10), 0, "int32"))
    meta = torch.device("meta")
    return {
        "j2_dtype": (j2_mod.jacobi2d_step, a.double()),
        "j2_int": (j2_mod.jacobi2d_step, w),
        "j2_rank": (j2_mod.jacobi2d_step, a.reshape(-1)),
        "j2_stride": (j2_mod.jacobi2d_step, a[:, ::2]),
        "j2_device": (j2_mod.jacobi2d_step, a.to(meta)),
        "j2_list": (j2_mod.jacobi2d_step, a.tolist()),
        "path_dtype": (path_mod.pathfinder, w.long()),
        "path_rank": (path_mod.pathfinder, w.reshape(2, 3, 10)),
        "path_no_rows": (path_mod.pathfinder, w[:0]),
        "path_stride": (path_mod.pathfinder, w.t()),
        "path_device": (path_mod.pathfinder, w.to(meta)),
    }


@pytest.mark.parametrize("bad", sorted(_bad_calls()))
def test_wrappers_reject_bad_operands(bad):
    fn, arg = _bad_calls()[bad]
    with pytest.raises(ValueError):
        fn(arg)

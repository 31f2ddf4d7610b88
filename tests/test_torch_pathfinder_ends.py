"""Port parity: pathfinder's end value, the Pallas kernel's 3.0e38.

The Pallas kernel (``repro/kernels/pathfinder.py:17``, ``_INF = 3.0e38``),
which ``repro.kernels.ops.pathfinder`` reaches, holds the columns past both
ends of a cost row at float32 3.0e38; ``repro.kernels.ref.pathfinder`` pads
with ``inf``.  The two part wherever a cost and both its neighbours reach
3e38.  The port follows the Pallas kernel: ``ops.pathfinder(...,
device="cpu")`` (the plain version) is held against
``repro.kernels.ops.pathfinder(..., interpret=True)`` exactly, NaN where
NaN, on walls of +inf rows and columns, values near 3e38, -inf and NaN.
The CUDA kernels are held to the plain version on the same walls by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

INF = np.inf


def special_wall(kind):
    rng = np.random.RandomState(len(kind))
    w = rng.uniform(0, 10, (12, 9)).astype(np.float32)
    if kind == "inf_row":
        w[5] = INF
    elif kind == "inf_columns":
        w[:, 0] = INF
        w[:, 4] = INF
    elif kind == "near_end":
        w[rng.rand(12, 9) < 0.4] = 3e38
        w[rng.rand(12, 9) < 0.2] = 2.9e38
        w[rng.rand(12, 9) < 0.1] = 3.4e38
    elif kind == "neg_inf":
        w[3, 2] = -INF
        w[7, 8] = -INF
        w[9] = INF
    elif kind == "nan":
        w[2, 4] = np.nan
        w[6, 0] = np.nan
        w[8] = INF
    return w


# the two walls of the fault, and walls with special values throughout
WALLS = {
    "one_column": np.array([[INF], [1], [1]], np.float32),
    "two_columns": np.array([[INF, INF], [1, 1]], np.float32),
    **{k: special_wall(k) for k in ("inf_row", "inf_columns", "near_end",
                                    "neg_inf", "nan")},
}


@pytest.mark.parametrize("name", sorted(WALLS))
def test_pathfinder_ends_match_pallas(name):
    w = WALLS[name]
    want = np.asarray(ref_ops.pathfinder(w, interpret=True))
    got = ops.pathfinder(w, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (w.shape[1],)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fault_walls_part_from_ref():
    """Where the reference's two oracles part: ``ref.pathfinder`` gives
    inf, the Pallas kernel and the port float32 3.0e38."""
    end = np.float32(3.0e38)
    for name in ("one_column", "two_columns"):
        w = WALLS[name]
        np.testing.assert_array_equal(
            np.asarray(jref.pathfinder(jnp.asarray(w))),
            np.full(w.shape[1], INF, np.float32))
        np.testing.assert_array_equal(
            ops.pathfinder(w, device="cpu").numpy(),
            np.full(w.shape[1], end))
    assert np.float32(ref.PATH_END) == end


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_pathfinder_ends_widened(dtype):
    """A 16-bit wall with +inf rows and columns, widened exactly: equal to
    the Pallas kernel on the same wall."""
    w = special_wall("inf_columns")
    w[9] = INF
    t = torch.from_numpy(w).to(getattr(torch, dtype))
    want = np.asarray(ref_ops.pathfinder(
        jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype)),
        interpret=True))
    np.testing.assert_array_equal(ops.pathfinder(t).numpy(), want)

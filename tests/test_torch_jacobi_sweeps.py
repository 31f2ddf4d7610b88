"""Port parity: Jacobi-2D's many-sweep entry, ``ops.jacobi2d(a, iters)``.

On the CPU the wrapper takes its plain version, only because the tensors
lie on the CPU: ``iters`` sweeps, a 16-bit grid rounded to its type at the
end of every sweep.  It is held against the reference's
``repro.kernels.ref.jacobi2d(a, iters)`` at its 1e-6 (float32) and bit for
bit against ``iters`` calls of the port's own ``jacobi2d_step`` in float32,
bfloat16 and float16.  The reference adds the five terms in the 16-bit type
itself, so a 16-bit grid is held to it at 1e-6 plus one unit of the type
over a few sweeps; the two round apart one unit at a time, so more sweeps
drift further (about two units after 50).  The route each grid takes on the
card (one cluster launch, a launch every few sweeps on tiles, or one launch a
sweep) is chosen on the host and checked here; the kernels are held against
the plain version on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import jacobi2d as j2_mod
from repro_torch.kernels import ops

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def grid(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape,iters", [((34, 40), 1), ((34, 40), 7),
                                         ((66, 129), 40), ((5, 3), 3),
                                         ((2, 7), 4), ((164, 164), 25)])
def test_jacobi2d_float32_matches_reference(shape, iters):
    a = grid(shape, seed=sum(shape) + iters)
    want = np.asarray(jref.jacobi2d(jnp.asarray(a), iters=iters))
    got = ops.jacobi2d(a, iters, device="cpu")
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("iters", [1, 2, 10])
def test_jacobi2d_16bit_matches_reference(dtype, iters):
    """1e-6 plus one unit of the 16-bit type: the reference sums in that
    type, the port in float32 rounded once a sweep."""
    t, j = DTYPES[dtype]
    a = grid((34, 40), seed=iters)
    want = np.asarray(jref.jacobi2d(jnp.asarray(a).astype(j),
                                    iters=iters).astype(jnp.float32))
    got = ops.jacobi2d(torch.from_numpy(a).to(t), iters)
    assert got.dtype == t
    tol = 1e-6 + torch.finfo(t).eps
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,iters", [((34, 40), 9), ((3, 3), 2),
                                         ((67, 5), 17)])
def test_jacobi2d_equals_its_sweeps_one_by_one(dtype, shape, iters):
    """``iters`` sweeps at once equal ``iters`` calls of ``jacobi2d_step``
    bit for bit: a 16-bit grid is rounded at the end of every sweep, not
    once at the end."""
    t = DTYPES[dtype][0]
    a = torch.from_numpy(grid(shape, seed=iters)).to(t)
    want = a
    for _ in range(iters):
        want = ops.jacobi2d_step(want)
    got = ops.jacobi2d(a, iters)
    assert got.dtype == t and torch.equal(got, want)
    if dtype != "float32" and shape == (34, 40):   # not widened once
        once = a.float()
        for _ in range(iters):
            once = ops.jacobi2d_step(once)
        assert not torch.equal(got, once.to(t))


def test_jacobi2d_no_sweeps_and_the_plain_path():
    a = torch.from_numpy(grid((12, 9), 0))
    got = j2_mod.jacobi2d(a, 0)
    assert torch.equal(got, a) and got.data_ptr() != a.data_ptr()
    counts = (j2_mod.jacobi2d.launches, j2_mod.jacobi2d.loop_launches)
    j2_mod.jacobi2d(a, 5)
    assert (j2_mod.jacobi2d.launches, j2_mod.jacobi2d.loop_launches) == \
        counts                                         # no kernel launched


@pytest.mark.parametrize("bad", ["float64", "int32", "rank", "iters"])
def test_jacobi2d_rejects_bad_operands(bad):
    a = torch.from_numpy(grid((12, 9), 0))
    args = {"float64": (a.double(), 1), "int32": (a.int(), 1),
            "rank": (a.reshape(-1), 1), "iters": (a, -1)}[bad]
    with pytest.raises(ValueError):
        j2_mod.jacobi2d(*args)


def test_jacobi2d_routes_refuse_what_their_kernels_cannot_take():
    """A CTA's halo comes from its neighbours' own rows, so k is at most a
    CTA's rows; a cluster holds 16 CTAs at most; and a route's kernels take
    a CUDA grid only (the CPU's plain version is ``jacobi2d``'s)."""
    a = torch.from_numpy(grid((37, 131), 0))
    with pytest.raises(ValueError, match="sweeps between barriers"):
        j2_mod.cluster(a, 10, 16, 4)
    with pytest.raises(ValueError, match="sweeps between barriers"):
        j2_mod.cluster(a, 10, 32, 1)
    for call in (lambda: j2_mod.cluster(a, 10, 16, 2),
                 lambda: j2_mod.loop(a, 10)):
        with pytest.raises(ValueError, match="CUDA grid"):
            call()


def largest_square(dtype):
    """The widest square grid of ``dtype`` the cluster route takes."""
    n = 3
    while j2_mod.route(n + 1, n + 1, dtype).name == "cluster":
        n += 1
    return n


@pytest.mark.parametrize("R,C,dtype,want", [
    (164, 164, torch.float32, ("cluster", 16, 8)),   # RiVec's app grid
    (3, 3, torch.float32, ("cluster", 2, 2)),        # k <= a CTA's rows
    (1, 5, torch.bfloat16, ("cluster", 1, 1)),
    (5, 5, torch.float16, ("cluster", 4, 2)),
    (600, 600, torch.float32, ("cluster", 16, 2)),   # k shrinks to fit
    (2_800, 2_800, torch.float32, ("tiled", 0, 8)),  # PolyBench EXTRALARGE
    (16, 5_811, torch.float32, ("cluster", 16, 1)),  # one row a CTA
    (16, 5_812, torch.float32, ("tiled", 0, 8)),
    (17, 3_000, torch.float32, ("tiled", 0, 8))])    # room for k = 1 only
def test_jacobi2d_route(R, C, dtype, want):
    """The largest power of two up to 16 and R of CTAs, and the most
    sweeps between barriers up to MAX_K and a CTA's rows, where two
    buffers of a CTA's rows and halo rows and its neighbours' inboxes fit
    227 KB, two at least where a CTA holds two rows or more; else, for
    many sweeps, the tiled route (MAX_K_TILED sweeps a launch, on the
    tile its halos leave)."""
    rt = j2_mod.route(R, C, dtype)
    assert (rt.name, rt.ctas, rt.k) == want
    if rt.name == "cluster":
        assert j2_mod.cluster_bytes(R, C, dtype.itemsize, rt.ctas, rt.k) \
            <= j2_mod.MAX_SMEM
    if rt.name == "tiled":
        assert rt == j2_mod.tiled_route(R, C, dtype)


@pytest.mark.parametrize("dtype,n,past", [(torch.float32, 618, "k"),
                                          (torch.bfloat16, 720, "points"),
                                          (torch.float16, 720, "points")])
def test_jacobi2d_cluster_takes_grids_to_618_float32(dtype, n, past):
    """The plan's cluster takes a float32 grid to 618 x 618, past which 16
    CTAs' shared memory (3.6 MB) holds it twice with one halo row a side
    only, and a 16-bit one to 720 x 720, past which a CTA would hold more
    than MAX_CTA_POINTS points; one launch a sweep ran faster past both,
    so the plan sends such grids to the tiled route, unless the cluster
    is asked for."""
    assert largest_square(dtype) == n
    assert j2_mod.route(n + 1, n + 1, dtype).name == "tiled"
    forced = j2_mod.route(n + 1, n + 1, dtype, 16)
    assert forced.name == "cluster"
    if past == "k":
        assert forced.k == 1
    else:
        assert -(-(n + 1) // 16) * (n + 1) > j2_mod.MAX_CTA_POINTS

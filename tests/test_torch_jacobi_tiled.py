"""Port parity: Jacobi-2D's tiled route (temporal blocking past the cluster).

On the card, ``jacobi2d(a, iters)`` sends a grid that no cluster holds to
the tiled route: ``ceil(iters / k)`` launches of ``k`` sweeps, each CTA
holding its tile and ``k`` halo rows and columns a side in two shared
buffers, updating the shrinking region sweep by sweep and storing only its
tile.  The plan is chosen on the host and checked here.  ``tiled_mirror``
runs the kernel's schedule in torch on the CPU (the same tiles, halos,
regions, buffers and last partial launch, with every point outside the
grid, and every point of the second buffer no sweep wrote but the held
ones, a NaN that would spread if read) and is held bit for bit against the
port's plain version and, at 1e-6 (plus two units of a 16-bit type, which
the reference sums in), against the reference's
``repro.kernels.ref.jacobi2d``.  The kernel itself is held against the
plain version on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import jacobi2d as j2_mod
from repro_torch.kernels import ref

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
# what a CTA may hold on an H100 (opt-in), and what an SM holds for its
# CTAs (each also reserving 1 KB)
SM_SMEM, CTA_RESERVED = 233_472, 1_024


def grid(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def tiled_mirror(a, iters, k, tile):
    """The tiled kernel's schedule in torch: ``ceil(iters / k)`` launches
    between two device buffers, each tile loaded with ``k`` halo rows and
    columns into the first shared buffer and its grid-boundary points into
    the second (NaN elsewhere, and outside the grid), ``kb`` sweeps on the
    region that shrinks by one a sweep, and the tile stored."""
    R, C = a.shape
    tr, tc = tile
    n = -(-iters // k)
    bufs = (torch.empty_like(a), torch.empty_like(a))   # out, tmp
    src = a
    for i in range(n):
        kb = k if i + 1 < n else iters - (n - 1) * k
        dst = bufs[(n - 1 - i) % 2]
        for r0 in range(0, R, tr):
            for c0 in range(0, C, tc):
                H, W = tr + 2 * k, tc + 2 * k
                shared = torch.full((H, W), float("nan"), dtype=a.dtype)
                g0, g1 = max(r0 - k, 0), min(r0 + tr + k, R)
                h0, h1 = max(c0 - k, 0), min(c0 + tc + k, C)
                shared[g0 - r0 + k:g1 - r0 + k, h0 - c0 + k:h1 - c0 + k] = \
                    src[g0:g1, h0:h1]
                # the second buffer holds the grid's boundary points only:
                # every other point a sweep reads, the sweep before wrote
                second = torch.full_like(shared, float("nan"))
                for g in {0, R - 1} & set(range(r0 - k, r0 + tr + k)):
                    second[g - r0 + k] = shared[g - r0 + k]
                for g in {0, C - 1} & set(range(c0 - k, c0 + tc + k)):
                    second[:, g - c0 + k] = shared[:, g - c0 + k]
                buf = [shared, second]
                lo_r, hi_r = k + 1 - r0, k + R - 2 - r0
                lo_c, hi_c = k + 1 - c0, k + C - 2 - c0
                cur = 0
                for j in range(1, kb + 1):
                    ext = kb - j
                    lo, hi = max(k - ext, lo_r), min(k + tr - 1 + ext, hi_r)
                    clo = max(k - ext, lo_c)
                    chi = min(k + tc - 1 + ext, hi_c)
                    if lo <= hi and clo <= chi:
                        w = buf[cur].float()
                        rows, cols = slice(lo, hi + 1), slice(clo, chi + 1)
                        v = 0.2 * ((((w[rows, cols]
                                      + w[rows, clo - 1:chi])
                                     + w[rows, clo + 1:chi + 2])
                                    + w[lo - 1:hi, cols])
                                   + w[lo + 1:hi + 2, cols])
                        buf[1 - cur][rows, cols] = v.to(a.dtype)
                    cur = 1 - cur
                nr, nc = min(tr, R - r0), min(tc, C - c0)
                dst[r0:r0 + nr, c0:c0 + nc] = buf[cur][k:k + nr, k:k + nc]
        src = dst
    return src


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("iters", [1, 7, 10])
def test_tiled_schedule_matches_plain_and_reference(dtype, iters):
    """A ragged 37 x 53 grid on 8 x 16 tiles (the last row and column of
    tiles partial) with 3 sweeps a launch: 1, 7 (a last launch of one
    sweep) and 10 sweeps."""
    t, j = DTYPES[dtype]
    a = torch.from_numpy(grid((37, 53), seed=iters)).to(t)
    got = tiled_mirror(a, iters, 3, (8, 16))
    assert got.dtype == t and torch.equal(got, ref.jacobi2d(a, iters))
    assert not torch.isnan(got).any()
    want = np.asarray(jref.jacobi2d(jnp.asarray(a.float().numpy()).astype(j),
                                    iters=iters).astype(jnp.float32))
    # the reference sums a 16-bit grid in its type, the port in float32
    # rounded once a sweep: they drift apart a unit at a time (1.75 units
    # of float16 after 10 sweeps here)
    tol = 1e-6 if dtype == "float32" else 1e-6 + 2 * torch.finfo(t).eps
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,k,tile,iters", [
    ((5, 3), 2, (2, 2), 5),        # tiles smaller than the halo
    ((1, 9), 3, (4, 4), 4),        # no interior: a copy
    ((40, 40), 8, (24, 24), 17),   # the plan's k, one tile past the last
    ((33, 65), 4, (32, 64), 9)])   # tile + 1 each way
def test_tiled_schedule_on_edge_shapes(shape, k, tile, iters):
    a = torch.from_numpy(grid(shape, seed=iters))
    assert torch.equal(tiled_mirror(a, iters, k, tile),
                       ref.jacobi2d(a, iters))


def test_tiled_schedule_at_the_plans_tile():
    """The plan's float32 tile and k on a grid of 2 x 2 tiles and a
    ragged edge, 20 sweeps (2 full launches and one of 4)."""
    rt = j2_mod.tiled_route(2_800, 2_800, torch.float32)
    R, C = 2 * rt.tile[0] + 5, 2 * rt.tile[1] - 3
    a = torch.from_numpy(grid((R, C), seed=3))
    assert torch.equal(tiled_mirror(a, 20, rt.k, rt.tile),
                       ref.jacobi2d(a, 20))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_tiled_route_fits_two_ctas_an_sm(dtype):
    """The tile and its halos, double-buffered, fit a CTA's 227 KB at
    every k the plan gives, on every grid, and two such CTAs fit an SM."""
    for R, C in ((2_800, 2_800), (721, 721), (619, 619), (16, 5_812)):
        for iters in range(2, 2 * j2_mod.MAX_K_TILED + 2):
            rt = j2_mod.tiled_route(R, C, dtype, iters)
            assert rt.k == min(iters, j2_mod.MAX_K_TILED)
            assert min(rt.tile) > 0
            assert (rt.tile[0] + 2 * rt.k, rt.tile[1] + 2 * rt.k) in \
                j2_mod.TILED_BUFS[dtype.itemsize]
            nbytes = j2_mod.tiled_bytes(rt.tile, rt.k, dtype.itemsize)
            assert nbytes <= j2_mod.MAX_SMEM
            assert 2 * (nbytes + CTA_RESERVED) <= SM_SMEM


@pytest.mark.parametrize("R,C,dtype,tile", [
    (2_800, 2_800, torch.float32, (96, 112)),    # 750 tiles
    (2_800, 2_800, torch.bfloat16, (96, 240)),   # 360
    (721, 721, torch.bfloat16, (40, 112)),       # 32, then 56, then 133
    (619, 619, torch.float32, (40, 112)),        # 42, then 96: the last
    (1_000, 1_000, torch.float32, (40, 112))])   # 99, then 225
def test_tiled_route_takes_the_largest_tile_that_fills_the_card(R, C, dtype,
                                                                 tile):
    """The first buffers of TILED_BUFS that cut the grid into N_SMS tiles
    or more, else the smallest."""
    rt = j2_mod.tiled_route(R, C, dtype)
    assert rt.tile == tile


@pytest.mark.parametrize("R,C,dtype,iters,want", [
    (2_800, 2_800, torch.float32, 1_000, "tiled"),   # PolyBench EXTRALARGE
    (2_800, 2_800, torch.bfloat16, 1_000, "tiled"),
    (2_800, 2_800, torch.float32, 1, "loop"),        # one sweep
    (619, 619, torch.float32, None, "tiled"),        # just past the cluster
    (721, 721, torch.float16, None, "tiled"),
    (618, 618, torch.float32, 1_000, "cluster"),     # the cluster's widest
    (164, 164, torch.float32, 4_000, "cluster"),     # RiVec's app grid
    (2_097_123, 3, torch.float32, 2, "loop")])       # narrower than a tile
def test_tiled_route_plan(R, C, dtype, iters, want):
    """Grids past the cluster take the tiled route for two sweeps or more
    where both sides are at least MIN_TILED_SIDE; the cluster keeps its
    grids; one sweep, and narrow grids, take the loop."""
    rt = j2_mod.route(R, C, dtype, iters=iters)
    assert rt.name == want
    if want == "tiled":
        assert rt == j2_mod.tiled_route(R, C, dtype, iters)
        k = rt.k
        launches = -(-(iters or k) // k)
        assert launches * k >= (iters or k) > (launches - 1) * k
        # the tiles cover the grid
        tr, tc = rt.tile
        assert -(-R // tr) * tr >= R and -(-C // tc) * tc >= C


def test_polybench_takes_125_launches():
    rt = j2_mod.route(2_800, 2_800, torch.float32, iters=1_000)
    assert (rt.k, -(-1_000 // rt.k)) == (8, 125)


def test_tiled_refuses_what_its_kernel_cannot_take():
    a = torch.from_numpy(grid((37, 131), 0))
    for k, tile, threads in ((0, (8, 8), 512), (2, (0, 8), 512),
                             (8, (200, 200), 512), (2, (8, 8), 48),
                             (2, (8, 8), 1024)):
        with pytest.raises(ValueError, match="tiled route"):
            j2_mod.tiled(a, 10, k, tile, threads=threads)
    with pytest.raises(ValueError, match="CUDA grid"):
        j2_mod.tiled(a, 10, 2, (8, 8))


def test_cpu_grids_launch_no_tiled_kernel():
    a = torch.from_numpy(grid((700, 700), 1))
    before = j2_mod.jacobi2d.tiled_launches
    assert torch.equal(j2_mod.jacobi2d(a, 3), ref.jacobi2d(a, 3))
    assert j2_mod.jacobi2d.tiled_launches == before

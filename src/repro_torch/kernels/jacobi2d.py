"""Jacobi-2D sweeps: CUDA kernels + wrappers.

Replaces ``repro/kernels/jacobi2d.py:32`` (``jacobi2d_step``,
``pallas_call`` at ``:45``): every interior point of a float32, bfloat16 or
float16 ``[R, C]`` grid becomes the mean of itself and its four
neighbours; boundary rows and columns are held.  A 16-bit grid is summed in
float32 and rounded to its type once, on the store.  The Pallas wrapper's
halo strips and its ``(R - 2) % rows_per_block`` requirement are gone: the
one-sweep kernel (``csrc/jacobi2d.cu``) reads the neighbouring rows in
place, writes a fresh output and takes any ``R, C``; a grid with no
interior comes back as a copy.  Bound on an H100: bytes, 8 B a point (one
read, one write).  Its threads take a row in 16-byte chunks (8 16-bit or 4
float32 points) where ``step_width`` allows, else in one-point chunks (the
width-one route, counted apart by ``jacobi2d_step.width1_launches``).

``jacobi2d(a, iters)`` is the port's counterpart of the reference's
``repro/kernels/ref.py:29`` (``jacobi2d(a, iters=1)``), which has no Pallas
kernel.  It takes one of three routes, which ``route`` picks on the host:

- ``cluster``: all sweeps in one launch of one thread-block cluster of up
  to 16 CTAs, the grid double-buffered in their shared memory with K halo
  rows a side, one cluster barrier every K sweeps; for every grid whose
  buffers fit the cluster with K >= 2 and whose CTAs hold at most 32,768
  points (float32 to 618 x 618, 16-bit to 720 x 720), where it ran faster
  than the loop.  Counted by ``jacobi2d.launches``.
- ``tiled``: temporal blocking for the grids past the cluster, as
  ``iters >= 2`` sweeps: ``ceil(iters / k)`` launches of the tiled kernel,
  each running ``k`` sweeps (the last the rest) on tiles held in shared
  memory with ``k`` halo rows and columns a side, between two buffers in
  device memory; counted by ``jacobi2d.tiled_launches``.
- ``loop``: the one-sweep kernel ``iters`` times, for one sweep and for
  the grids too narrow for a tile; counted by ``jacobi2d.loop_launches``,
  one a sweep.

The kernels are built with ``-fmad=false``, sum in the plain version's
order and round a 16-bit grid at the end of every sweep, so ``iters``
sweeps equal ``iters`` sweeps of the plain version bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch import _build, _device
from repro_torch.kernels import _check, ref

NAME = "jacobi2d_step"
# the C entry points' code for each grid type
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the opt-in shared memory of one CTA, and the most CTAs a cluster holds
# on an H100 (past 8 only by the non-portable size attribute)
MAX_SMEM, MAX_CTAS = 232_448, 16
# sweeps between two cluster barriers, at most: at the app's 164 x 164 on
# 16 CTAs, 4,000 sweeps took 7.637 ms at 1, 3.824 at 4, 3.522 at 8 and
# 3.525 at 11 (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W)
MAX_K = 8
# the most points a CTA of the plan's cluster holds: 16 SMs sweep a grid
# that 132 take one launch at a time, so past about this many a CTA one
# launch a sweep ran faster (896 x 896 bfloat16, 50,176 a CTA: 5.63 against
# the loop's 4.52-4.59 us a sweep; 618 x 618 float32, 24,102: 2.94-2.97
# against 4.04-4.29; chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W)
MAX_CTA_POINTS = 32_768
# The tiled route: each of a CTA's two shared buffers holds (rows,
# columns) points, a tile and k halo rows and columns a side, the first of
# TILED_BUFS[itemsize] that cuts the grid into N_SMS tiles or more (else
# the last): 112 KB in all, two CTAs of TILED_THREADS an SM, or 56 KB.  Up
# to MAX_K_TILED sweeps a launch.  PolyBench's 1,000 sweeps of 2,800 x
# 2,800 took 9.38 ms at k 8 (float32, 96 x 112 tiles), 9.74 at 12, 10.09
# at 16 and 11.45 at 4; 10.11 with 256 threads, 9.99 on 40 x 112 tiles and
# 10.97 on buffers of 224 KB (one CTA an SM); bfloat16 on 96 x 240 tiles
# 9.05 at k 8 (scripts/jacobi2d_variants.py, NVIDIA H100 80GB HBM3, 700 W).
TILED_BUFS = {4: ((112, 128), (56, 128)),
              2: ((112, 256), (112, 128), (56, 128))}
MAX_K_TILED, TILED_THREADS, N_SMS = 8, 512, 132
# the narrowest side of a grid the plan gives the tiled route: 100,000 x 8
# float32 took 9.35 us a sweep there against the loop's 9.73 (100,000 x
# 16: 9.46 against 9.30, 8.55 against 9.08 in another run), 2,097,123 x 3
# 233.1 against 137.3 (the same script and card)
MIN_TILED_SIDE = 8


class Route(NamedTuple):
    """How ``jacobi2d`` runs a grid (``route``)."""
    name: str          # "cluster", "tiled" or "loop"
    ctas: int          # the cluster's CTAs (0 on the other routes)
    k: int             # sweeps between cluster barriers, or a launch of
                       # the tiled route (0: loop route)
    tile: tuple = (0, 0)   # the tiled route's tile, rows x columns


def cluster_bytes(R: int, C: int, itemsize: int, ctas: int, k: int) -> int:
    """One CTA's shared memory on the cluster route: two buffers of its
    ``ceil(R / ctas)`` rows and ``k`` halo rows a side, and two parities of
    ``k`` rows from each neighbour."""
    return (2 * (-(-R // ctas) + 2 * k) + 4 * k) * C * itemsize


def tiled_pitch(tile: tuple, k: int, itemsize: int) -> int:
    """Points a row of a tiled CTA's buffer: the tile's columns and ``k``
    halo columns a side, rounded up to whole 16-byte chunks."""
    v = 16 // itemsize
    return -(-(tile[1] + 2 * k) // v) * v


def tiled_bytes(tile: tuple, k: int, itemsize: int) -> int:
    """One CTA's shared memory on the tiled route: two buffers of a
    ``tile`` with ``k`` halo rows and columns a side."""
    return 2 * (tile[0] + 2 * k) * tiled_pitch(tile, k, itemsize) * itemsize


def tiled_route(R: int, C: int, dtype: torch.dtype,
                iters: int | None = None) -> Route:
    """The tiled route for ``iters`` sweeps (many where None) of an [R, C]
    grid: up to MAX_K_TILED sweeps a launch, on the tile that leaves room
    for their halos in the first of TILED_BUFS that gives N_SMS tiles or
    more (a 721 x 721 bfloat16 grid took 2.98 us a sweep on 40 x 112
    tiles, against the loop's 6.84, where on 96 x 240 tiles, 32 CTAs, the
    kernel's first form took 4.36 against 3.78; scripts/
    jacobi2d_variants.py, NVIDIA H100 80GB HBM3, 700 W)."""
    k = MAX_K_TILED if iters is None else max(1, min(MAX_K_TILED, iters))
    for rows, cols in TILED_BUFS[dtype.itemsize]:
        tile = (rows - 2 * k, cols - 2 * k)
        if -(-R // tile[0]) * -(-C // tile[1]) >= N_SMS:
            break
    return Route("tiled", 0, k, tile)


def route(R: int, C: int, dtype: torch.dtype, ctas: int | None = None,
          iters: int | None = None) -> Route:
    """The cluster route with ``ctas`` CTAs (by default the largest power
    of two up to 16 and R) and the most sweeps between barriers, up to
    MAX_K and a CTA's rows, whose buffers fit a CTA's shared memory.  By
    default a grid whose CTAs would hold more than MAX_CTA_POINTS points,
    or that leaves room for one sweep between barriers only where a CTA
    holds more than one row, does not take the cluster: one launch a sweep
    ran faster there (645 x 645 float32 at one sweep between barriers:
    3.68 against 3.98 us a sweep, where 512 x 512 at six took 2.20 against
    the loop's 3.38; chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).  Such a
    grid takes the tiled route (``tiled_route``) for ``iters`` sweeps (many
    where None) when both its sides are at least MIN_TILED_SIDE and there
    are two sweeps or more, else the loop route."""
    plan = ctas is None
    if plan:
        ctas = 1 << min(MAX_CTAS.bit_length() - 1, R.bit_length() - 1)
    rpc = -(-R // ctas)
    for k in range(min(MAX_K, rpc), 0, -1):
        if cluster_bytes(R, C, dtype.itemsize, ctas, k) <= MAX_SMEM:
            if plan and (k < min(2, rpc) or rpc * C > MAX_CTA_POINTS):
                break
            return Route("cluster", ctas, k)
    if plan and min(R, C) >= MIN_TILED_SIDE and (iters is None
                                                  or iters >= 2):
        return tiled_route(R, C, dtype, iters)
    return Route("loop", 0, 0)


def step_width(C: int, dtype: torch.dtype, *pointers: int) -> int:
    """Points a chunk of the one-sweep kernel for a grid of ``C`` columns
    whose buffers start at ``pointers``: 16 bytes' worth (8 16-bit or 4
    float32 points, the vector route) where ``C`` is a multiple of that and
    every pointer is 16-byte aligned, else 1 (the width-one route: the
    same kernel, one point a chunk)."""
    v = 16 // dtype.itemsize
    return v if C % v == 0 and all(p % 16 == 0 for p in pointers) else 1


def _lib():
    lib = _build.load("jacobi2d")
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.jacobi2d_launch.argtypes = [p, p, i, i, i, i, p]
        lib.jacobi2d_loop_launch.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.jacobi2d_cluster_launch.argtypes = [p, p, i, i, i, i, i, i, p]
        lib.jacobi2d_clusters_fit.argtypes = [i, i, i, i, i,
                                              ctypes.POINTER(i)]
        lib.jacobi2d_tiled_launch.argtypes = [p, p, p, i, i, i, i, i, i, i,
                                              i, p]
        for fn in (lib.jacobi2d_launch, lib.jacobi2d_loop_launch,
                   lib.jacobi2d_cluster_launch, lib.jacobi2d_clusters_fit,
                   lib.jacobi2d_tiled_launch):
            fn.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _check_grid(a):
    _check.tensor(NAME, "a", a, DTYPES, 2)
    R, C = a.shape
    if R > _check.INT32_MAX - 32 or C > _check.INT32_MAX - 32:
        raise ValueError(f"{NAME}: grid {tuple(a.shape)} too large "
                         "(R and C < 2^31)")


def jacobi2d_step(a):
    """One sweep of the float32, bfloat16 or float16 ``[R, C]`` grid ``a``
    into a new tensor of its type.  CUDA tensors launch the kernel at
    ``step_width`` (counted by ``jacobi2d_step.launches`` on the vector
    route, ``.width1_launches`` at width one); CPU tensors take the plain
    version."""
    _check_grid(a)
    if _check.device_kind(NAME, a) == "cpu":
        return ref.jacobi2d(a)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    width = step_width(a.shape[1], a.dtype, a.data_ptr(), out.data_ptr())
    lib = _lib()
    code = _device.launch(lib.jacobi2d_launch, a, a.data_ptr(),
                          out.data_ptr(), *a.shape, DTYPES[a.dtype], width)
    _build.check(lib, code, NAME)
    if width == 1:
        jacobi2d_step.width1_launches += 1
    else:
        jacobi2d_step.launches += 1
    return out


@functools.lru_cache(maxsize=64)
def clusters_fit(R: int, C: int, dtype: torch.dtype, ctas: int, k: int,
                 device: int = 0) -> int:
    """How many clusters of ``ctas`` CTAs in blocks of ``k`` sweeps for
    this grid card ``device`` holds at once (0: such a cluster cannot be
    scheduled)."""
    lib, n = _lib(), ctypes.c_int(0)
    with torch.cuda.device(device):
        code = lib.jacobi2d_clusters_fit(R, C, DTYPES[dtype], ctas, k,
                                         ctypes.byref(n))
    _build.check(lib, code, NAME)
    return n.value


def jacobi2d(a, iters: int = 1):
    """``iters`` sweeps of the float32, bfloat16 or float16 ``[R, C]`` grid
    ``a`` into a new tensor of its type, each rounded to it as one sweep of
    ``jacobi2d_step`` is.  CUDA tensors take ``route``; CPU tensors take
    the plain version."""
    _check_grid(a)
    iters = int(iters)
    if iters < 0:
        raise ValueError(f"jacobi2d: iters = {iters} must be >= 0")
    if _check.device_kind(NAME, a) == "cpu":
        return ref.jacobi2d(a, iters).clone()
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    R, C = a.shape
    rt = route(R, C, a.dtype, iters=iters)
    # the plan's cluster halves where the card cannot schedule it (16 CTAs
    # take 16 SMs of one GPC)
    while rt.name == "cluster" and rt.ctas > 1 and clusters_fit(
            R, C, a.dtype, rt.ctas, rt.k, a.get_device()) < 1:
        rt = route(R, C, a.dtype, rt.ctas // 2)
    if rt.name == "cluster":
        return cluster(a, iters, rt.ctas, rt.k, out)
    if rt.name == "tiled":
        return tiled(a, iters, rt.k, rt.tile, out)
    return loop(a, iters, out)


def _check_cuda(a):
    _check_grid(a)
    if _check.device_kind(NAME, a) != "cuda":
        raise ValueError(f"jacobi2d: a route's kernels take a CUDA grid, "
                         f"not one on {a.device}")


def cluster(a, iters: int, ctas: int, k: int, out=None):
    """The cluster route on a CUDA grid: ``iters`` sweeps in one launch of
    a cluster of ``ctas`` CTAs, ``k`` sweeps between barriers, into
    ``out`` (new where None), counted by ``jacobi2d.launches``; any
    ``ctas`` and ``k`` whose buffers fit, so it also times the plan's
    alternatives."""
    _check_grid(a)
    R, C = a.shape
    if not 1 <= ctas <= MAX_CTAS or not 1 <= k <= -(-R // ctas) or \
            cluster_bytes(R, C, a.element_size(), ctas, k) > MAX_SMEM:
        raise ValueError(f"jacobi2d: no cluster of {ctas} CTAs with {k} "
                         f"sweeps between barriers for a {R} x {C} grid")
    _check_cuda(a)
    if clusters_fit(R, C, a.dtype, ctas, k, a.get_device()) < 1:
        raise ValueError(f"jacobi2d: a cluster of {ctas} CTAs for a {R} x "
                         f"{C} grid cannot be scheduled")
    out = torch.empty_like(a) if out is None else out
    lib = _lib()
    code = _device.launch(lib.jacobi2d_cluster_launch, a, a.data_ptr(),
                          out.data_ptr(), R, C, DTYPES[a.dtype], iters, ctas,
                          k)
    _build.check(lib, code, "jacobi2d")
    jacobi2d.launches += 1
    return out


def tiled(a, iters: int, k: int, tile: tuple, out=None,
          threads: int = TILED_THREADS):
    """The tiled route on a CUDA grid: ``iters`` sweeps in
    ``ceil(iters / k)`` launches of ``k`` sweeps (the last the rest) on
    tiles of ``tile`` (rows, columns) points with ``k`` halo rows and
    columns a side, ``threads`` a CTA, into ``out`` (new where None),
    counted by ``jacobi2d.tiled_launches``; any tile and ``k`` whose
    buffers fit, so it also times the plan's alternatives."""
    _check_grid(a)
    R, C = a.shape
    tr, tc = tile
    if min(tr, tc, k) < 1 or not 32 <= threads <= TILED_THREADS or \
            threads % 32 or \
            tiled_bytes(tile, k, a.element_size()) > MAX_SMEM:
        raise ValueError(f"jacobi2d: no tiled route of {tr} x {tc} tiles "
                         f"with {k} sweeps a launch ({threads} threads)")
    _check_cuda(a)
    out = torch.empty_like(a) if out is None else out
    if iters == 0 or a.numel() == 0:
        return out.copy_(a)
    n = -(-iters // k)
    tmp = torch.empty_like(a) if n > 1 else out
    lib = _lib()
    code = _device.launch(lib.jacobi2d_tiled_launch, a, a.data_ptr(),
                          out.data_ptr(), tmp.data_ptr(), R, C,
                          DTYPES[a.dtype], iters, tr, tc, k, threads)
    _build.check(lib, code, "jacobi2d")
    jacobi2d.tiled_launches += n
    return out


def loop(a, iters: int, out=None):
    """The loop route on a CUDA grid: ``iters`` launches of the one-sweep
    kernel at ``step_width`` into ``out`` (new where None), counted by
    ``jacobi2d.loop_launches``; any grid, so it also times the route a
    cluster replaces."""
    _check_cuda(a)
    out = torch.empty_like(a) if out is None else out
    if iters == 0 or a.numel() == 0:
        return out.copy_(a)
    tmp = torch.empty_like(a) if iters > 1 else out
    ptrs = (a.data_ptr(), out.data_ptr(), tmp.data_ptr())
    lib = _lib()
    code = _device.launch(lib.jacobi2d_loop_launch, a, *ptrs, *a.shape,
                          DTYPES[a.dtype],
                          step_width(a.shape[1], a.dtype, *ptrs), iters)
    _build.check(lib, code, "jacobi2d")
    jacobi2d.loop_launches += iters
    return out


jacobi2d_step.launches = 0
jacobi2d_step.width1_launches = 0
jacobi2d.launches = 0
jacobi2d.loop_launches = 0
jacobi2d.tiled_launches = 0

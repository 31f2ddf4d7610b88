"""Streamcluster dist (pairwise squared distances): CUDA kernel + wrapper.

Replaces ``repro/kernels/streamcluster.py:29`` (``streamcluster_dist``,
``pallas_call`` at ``:36``): ``max(|p|^2 + |c|^2 - 2 p.c, 0)`` for points
``[M,D]`` and centers ``[N,D]``, float32, bfloat16 or float16, into
float32 ``[M,N]``.

The CUDA kernel (``csrc/streamcluster.cu``) runs the products on the
tensor cores (``wgmma``), one 128 x 128 output tile at a time on
persistent CTAs, with the row norms formed from the tiles it holds (no
pre-pass), the distance formed from the accumulators and the output
stored by TMA.  ``path`` names the route, from the type, D and the
pointers' alignment, each with its own launch counter:

- ``wgmma/tma``: bfloat16 and float16 (float32 sums), the operands' panels
  by TMA; rows 16-byte aligned (D % 8 == 0, aligned bases).  Counted by
  ``streamcluster_dist.launches``.
- ``wgmma/ld``: the same for the other 16-bit operands, the panels by
  plain loads.  Counted by ``streamcluster_dist.ld_launches``.
- ``3xtf32/tma`` and ``3xtf32/ld``: float32 as 3xTF32 (each operand split
  into two TF32 values, three TF32 products a product, float32's
  accuracy; plain TF32 misses the reference's 2e-4 bar), the panels by TMA
  where D % 4 == 0 and the bases are 16-byte aligned, else by plain loads.
  Counted by ``streamcluster_dist.tf32_launches``.

Operands the kernel does not take as they are (64-bit, mixed or integer
types) are converted first by the reference's rule (``_promote``).  Bound
on an H100 at PARSEC simlarge (16,384 points x 4,096 centers x 128
dimensions): the 268 MB float32 output (0.080 ms) for 16-bit operands,
the 3xTF32 products (3 x 17.2 GFLOP at 495 TFLOP/s, 0.104 ms) for
float32.  The Pallas kernel's ``M % bm`` and ``N % bn`` requirements are
gone: ragged tiles are masked.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build, _device
from repro_torch.kernels import _check, _promote, ref

NAME = "streamcluster_dist"
# the C entry point's code for each input type
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# how the kernel fills its panels (the C entry point's ``load`` code), and
# the launch counter of each route
LOADS = {"wgmma/tma": 0, "wgmma/ld": 2, "3xtf32/tma": 0, "3xtf32/ld": 2}
COUNTERS = {"wgmma/tma": "launches", "wgmma/ld": "ld_launches",
            "3xtf32/tma": "tf32_launches", "3xtf32/ld": "tf32_launches"}


def _check_args(points, centers):
    _check.tensor(NAME, "points", points, DTYPES, 2)
    _check.tensor(NAME, "centers", centers, (points.dtype,), 2,
                  points.device)
    if points.shape[1] != centers.shape[1]:
        raise ValueError(f"{NAME}: points {tuple(points.shape)} and centers "
                         f"{tuple(centers.shape)} differ in D")
    # the kernel forms tile offsets (up to a 128-row tile past M or N) in int
    if max(points.shape[0], centers.shape[0], points.shape[1]) \
            > _check.INT32_MAX - 128:
        raise ValueError(f"{NAME}: M, N and D must fit int32")


def path(points, centers) -> str:
    """The kernel's route for these operands (of one type the kernel
    takes), a key of ``LOADS``: rows are D elements apart, so D and the
    base pointers decide whether every row is 16-byte aligned."""
    kernel = "3xtf32" if points.dtype == torch.float32 else "wgmma"
    aligned = points.shape[-1] * points.element_size() % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (points, centers))
    return f"{kernel}/tma" if aligned else f"{kernel}/ld"


def _lib():
    lib = _build.load("streamcluster")
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.streamcluster_dist_launch.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.streamcluster_dist_launch.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def streamcluster_dist(points, centers):
    """float32 ``[M,N]`` squared distances.  CUDA tensors launch the kernel
    of ``path``; CPU tensors take the plain version."""
    (points, centers), _ = _promote.promote((points, centers), DTYPES)
    _check_args(points, centers)
    if _check.device_kind(NAME, points) == "cpu":
        return ref.streamcluster_dist(points, centers)
    (M, D), N = points.shape, centers.shape[0]
    out = torch.empty(M, N, dtype=torch.float32, device=points.device)
    if M == 0 or N == 0:
        return out
    if D == 0:
        return out.zero_()
    route = path(points, centers)
    lib = _lib()
    code = _device.launch(lib.streamcluster_dist_launch, points,
                          points.data_ptr(), centers.data_ptr(),
                          out.data_ptr(), M, N, D, DTYPES[points.dtype],
                          LOADS[route])
    _build.check(lib, code, NAME)
    counter = COUNTERS[route]
    setattr(streamcluster_dist, counter,
            getattr(streamcluster_dist, counter) + 1)
    return out


streamcluster_dist.launches = 0
streamcluster_dist.ld_launches = 0
streamcluster_dist.tf32_launches = 0

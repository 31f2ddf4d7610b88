"""Streamcluster dist (pairwise squared distances): CUDA kernel + wrapper.

Replaces ``repro/kernels/streamcluster.py:29`` (``streamcluster_dist``,
``pallas_call`` at ``:36``): ``max(|p|^2 + |c|^2 - 2 p.c, 0)`` for points
``[M,D]`` and centers ``[N,D]``, float32, bfloat16 or float16, into
float32 ``[M,N]``.

The CUDA kernel (``csrc/streamcluster.cu``) is a row-norm pre-pass into a
scratch ``[M+N]`` buffer, then a tiled float32 SIMT product (128 x 128
output tiles, 8 x 8 per thread, D staged through shared memory 16 at a
time) whose epilogue forms the distance.  bfloat16 and float16 inputs are
widened as they are loaded.  Bound on an H100: operations, 2*M*N*D
multiply-adds (17.2 GFLOP at PARSEC simlarge's 16,384 points x 4,096
centers x 128 dimensions, 0.26 ms at 67 TFLOP/s).  Tensor cores are not used: TF32 misses
the reference's 2e-4 bar.  The Pallas kernel's ``M % bm`` and ``N % bn``
requirements are gone: ragged tiles are masked.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import _check, _promote, ref

NAME = "streamcluster_dist"
# the C entry point's code for each input type
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


def _lib():
    lib = _build.load("streamcluster")
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.streamcluster_dist_launch.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.streamcluster_dist_launch.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def streamcluster_dist(points, centers):
    """float32 ``[M,N]`` squared distances.  CUDA tensors launch the kernel;
    CPU tensors take the plain version."""
    (points, centers), _ = _promote.promote((points, centers), DTYPES)
    _check_args(points, centers)
    if _check.device_kind(NAME, points) == "cpu":
        return ref.streamcluster_dist(points, centers)
    (M, D), N = points.shape, centers.shape[0]
    out = torch.empty(M, N, dtype=torch.float32, device=points.device)
    if M == 0 or N == 0:
        return out
    norms = torch.empty(M + N, dtype=torch.float32, device=points.device)
    lib = _lib()
    with torch.cuda.device(points.device):
        code = lib.streamcluster_dist_launch(
            points.data_ptr(), centers.data_ptr(), norms.data_ptr(),
            out.data_ptr(), M, N, D, DTYPES[points.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, NAME)
    streamcluster_dist.launches += 1
    return out


streamcluster_dist.launches = 0

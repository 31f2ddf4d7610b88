"""Particle-filter find-index (vfirst.m / vpopc.m): CUDA kernel + wrapper.

Replaces ``repro/kernels/particlefilter.py:31`` (``find_index``,
``pallas_call`` at ``:36``): for each query ``u_j``, ``count(cdf < u_j)``
over the N CDF entries, clamped to N-1.  On a monotone CDF that is the first
index with ``cdf >= u_j``; the kernel keeps the count rather than a binary
search, so it agrees with the reference on any input.

The CUDA kernel (``csrc/particlefilter.cu``) gives each query one thread;
a block stages the CDF through shared memory in 2,048-entry tiles and every
thread compares its query against each staged entry.  Bound on an H100:
operations, one compare and one add per (query, entry) pair: 2e10 at
Rodinia's 100,000 particles x 100,000 queries, 0.30 ms at 67 TFLOP/s.  The
Pallas kernel's tile requirements (``M % bu``, ``N % bc``) are gone: the
last CDF tile is padded with +inf and queries past M are masked.  The
output is exact.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import _check, ref

NAME = "find_index"


def _lib():
    lib = _build.load("particlefilter")
    if not getattr(lib, "_repro_typed", False):
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.find_index_launch.argtypes = [p, p, p, ll, ll, p]
        lib.find_index_launch.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def find_index(cdf, u):
    """int32 ``[M]``: ``min(count(cdf < u_j), N - 1)`` for float32 ``cdf``
    ``[N]`` and queries ``u`` ``[M]``.  CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    _check.tensor(NAME, "cdf", cdf, (torch.float32,), 1)
    _check.tensor(NAME, "u", u, (torch.float32,), 1, cdf.device)
    if cdf.numel() > _check.INT32_MAX:
        raise ValueError(f"{NAME}: N = {cdf.numel()} does not fit the int32 "
                         "output")
    if _check.device_kind(NAME, cdf) == "cpu":
        return ref.particlefilter_findindex(cdf, u)
    out = torch.empty(u.shape, dtype=torch.int32, device=u.device)
    if u.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(u.device):
        code = lib.find_index_launch(
            cdf.data_ptr(), u.data_ptr(), out.data_ptr(), cdf.numel(),
            u.numel(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, NAME)
    find_index.launches += 1
    return out


find_index.launches = 0

"""Particle-filter find-index (vfirst.m / vpopc.m): CUDA kernels + wrapper.

Replaces ``repro/kernels/particlefilter.py:31`` (``find_index``,
``pallas_call`` at ``:36``): for each query ``u_j``, ``count(cdf < u_j)``
over the N CDF entries, clamped to N-1.  The reference's contract is a
monotone CDF, where that count is the first index with ``cdf >= u_j``; the
port computes the count exactly on every input.

One C entry (``csrc/particlefilter.cu``) launches two kernels.  The first
checks on the device whether the CDF is non-decreasing (``cdf[i] <=
cdf[i+1]`` for every i, so a NaN fails) and writes one flag per block into
``FLAG_SLOTS`` slots.  The second reads the slots: where all pass, each
thread finds its query's lower bound (a sample of every 64th entry in
shared memory, then a window of 64 from L2), which equals the count on
such a CDF; where any fails, each thread counts its query against every
entry, the CDF staged through shared memory.  Bound on an H100, what the
input needs: on a non-decreasing CDF the bytes, 1.2 MB at Rodinia's 100,000
particles x 100,000 queries; otherwise the 2e10 compares and adds, 0.30 ms
at 67 TFLOP/s.  The Pallas kernel's tile requirements (``M % bu``, ``N %
bc``) are gone.  The output is exact on both paths.

A CDF or queries in bfloat16 or float16, or of two float types, are
widened to float32 first: exactly, so the counts are those of the
reference, which compares in the wider type.

The wrapper never reads the flags (that would wait for the card): it keeps
the last call's buffer as ``find_index.last_flags`` (the flags lead the
allocation the output is a view of), and ``searched`` tells, after a
synchronize, which path that call took.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build, _device
from repro_torch.kernels import _check, _promote, ref

NAME = "find_index"
# one block of the monotonicity check, and one flag, per SM of an H100
FLAG_SLOTS = 132


def _lib():
    lib = _build.load("particlefilter")
    if not getattr(lib, "_repro_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.find_index_launch.argtypes = [p, p, p, p, i, ll, ll, p]
        lib.find_index_launch.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def find_index(cdf, u):
    """int32 ``[M]``: ``min(count(cdf < u_j), N - 1)`` for a ``cdf``
    ``[N]`` and queries ``u`` ``[M]`` of float32, bfloat16 or float16 (the
    16-bit ones widened to float32).  CUDA tensors launch the kernels; CPU
    tensors take the plain version."""
    cdf, u = _promote.widen(cdf), _promote.widen(u)
    _check.tensor(NAME, "cdf", cdf, (torch.float32,), 1)
    _check.tensor(NAME, "u", u, (torch.float32,), 1, cdf.device)
    if cdf.numel() > _check.INT32_MAX:
        raise ValueError(f"{NAME}: N = {cdf.numel()} does not fit the int32 "
                         "output")
    # is_cuda first: the device's name costs the CUDA path a host microsecond
    if not cdf.is_cuda and _check.device_kind(NAME, cdf) == "cpu":
        return ref.particlefilter_findindex(cdf, u)
    m = u.numel()
    if m == 0:
        find_index.last_flags = None
        return torch.empty(0, dtype=torch.int32, device=u.device)
    # the flags, then the output, in one allocation: a call's host time
    # (~0.03 ms) sets the pace of back-to-back calls, not the card's
    buf = torch.empty(FLAG_SLOTS + m, dtype=torch.int32, device=u.device)
    lib = _lib()
    ptr = buf.data_ptr()
    code = _device.launch(lib.find_index_launch, u, cdf.data_ptr(),
                          u.data_ptr(), ptr + 4 * FLAG_SLOTS, ptr,
                          FLAG_SLOTS, cdf.numel(), m)
    _build.check(lib, code, NAME)
    find_index.last_flags = buf
    find_index.launches += 1
    return buf[FLAG_SLOTS:]


def searched(flags) -> bool:
    """Whether the call that wrote ``flags`` (``find_index.last_flags``: its
    first ``FLAG_SLOTS`` ints) took the search path: every slot passed the
    monotonicity check.  Reads the card, so call it after the call has
    finished."""
    if flags is None:
        raise ValueError(f"{NAME}: no flags (the last call launched "
                         "nothing)")
    return bool((flags[:FLAG_SLOTS] != 0).all())


find_index.launches = 0
find_index.last_flags = None

"""Jacobi-2D (one 5-point sweep): CUDA kernel + wrapper.

Replaces ``repro/kernels/jacobi2d.py:32`` (``jacobi2d_step``,
``pallas_call`` at ``:45``): every interior point of a float32 or bfloat16
``[R, C]`` grid becomes the mean of itself and its four neighbours; boundary
rows and columns are held.  A bfloat16 grid is summed in float32 and
rounded once, on the store.  The Pallas wrapper's halo strips and its
``(R - 2) % rows_per_block`` requirement are gone: the CUDA kernel
(``csrc/jacobi2d.cu``) reads the neighbouring rows in place, writes a fresh
output and takes any ``R, C``; a grid with no interior comes back as a copy.
Bound on an H100: bytes, 8 B a point (one read, one write).  Built with
``-fmad=false`` and summed in the plain version's order, so a sweep equals
the plain version bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import _check, ref

NAME = "jacobi2d_step"
DTYPES = (torch.float32, torch.bfloat16)
# a block covers 32 rows; gridDim.y is at most 65,535
MAX_ROWS = 65_535 * 32


def _lib():
    lib = _build.load("jacobi2d")
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.jacobi2d_launch.argtypes = [p, p, i, i, i, p]
        lib.jacobi2d_launch.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def jacobi2d_step(a):
    """One sweep of the float32 or bfloat16 ``[R, C]`` grid ``a`` into a new
    tensor of its type.  CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    _check.tensor(NAME, "a", a, DTYPES, 2)
    R, C = a.shape
    if R > MAX_ROWS or C > _check.INT32_MAX - 32:
        raise ValueError(f"{NAME}: grid {tuple(a.shape)} too large "
                         f"(R <= {MAX_ROWS}, C < 2^31)")
    if _check.device_kind(NAME, a) == "cpu":
        return ref.jacobi2d(a)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(a.device):
        code = lib.jacobi2d_launch(a.data_ptr(), out.data_ptr(), R, C,
                                   int(a.dtype == torch.bfloat16),
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, NAME)
    jacobi2d_step.launches += 1
    return out


jacobi2d_step.launches = 0

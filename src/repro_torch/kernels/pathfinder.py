"""Pathfinder (Rodinia's row-by-row dynamic program): CUDA kernel + wrapper.

Replaces ``repro/kernels/pathfinder.py:43`` (``pathfinder``, ``pallas_call``
at ``:46``): from an int32 or float32 wall ``[R, C]``, ``cost = wall[0]``,
then ``cost = wall[i] + min(cost, cost<<1, cost>>1)`` row by row with +inf
past the ends; the result is the last cost row, float32 ``[C]``.

The CUDA kernel (``csrc/pathfinder.cu``) is Rodinia's ghost-zone pyramid:
256-column strips, overlapping by 20 on each side, each advance 20 rows in
shared memory per launch; one call makes ``ceil((R - 1) / 20)`` launches.
Bound on an H100: bytes, the wall read once.  min is exact and each row
adds once, so the kernel equals its plain version bit for bit.  A wall in
bfloat16, float16 or int16 is widened to float32 first, exactly, as the
reference widens each row (``repro/kernels/pathfinder.py:23``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import _check, _promote, ref

NAME = "pathfinder"
DTYPES = (torch.int32, torch.float32)
# wall types the reference widens to float32, row by row
WIDENED = (torch.bfloat16, torch.float16, torch.int16)


def _lib():
    lib = _build.load("pathfinder")
    if not getattr(lib, "_repro_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pathfinder_launch.argtypes = [p, i, p, p, ll, i, p]
        lib.pathfinder_launch.restype = ctypes.c_int
        lib.pathfinder_launches.argtypes = [ll]
        lib.pathfinder_launches.restype = ll
        lib._repro_typed = True
    return lib


def pathfinder(wall):
    """float32 ``[C]``: the last min-cost row of ``wall`` ``[R, C]`` (int32
    or float32, R >= 1; bfloat16, float16 and int16 widened to float32).
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    wall = _promote.widen(wall, WIDENED)
    _check.tensor(NAME, "wall", wall, DTYPES, 2)
    R, C = wall.shape
    if R < 1:
        raise ValueError(f"{NAME}: wall needs at least one row, got shape "
                         f"{tuple(wall.shape)}")
    if C > _check.INT32_MAX - 256:
        raise ValueError(f"{NAME}: C = {C} must fit int32")
    if _check.device_kind(NAME, wall) == "cpu":
        return ref.pathfinder(wall)
    out = torch.empty(C, dtype=torch.float32, device=wall.device)
    if C == 0:
        return out
    scratch = torch.empty_like(out)
    lib = _lib()
    with torch.cuda.device(wall.device):
        code = lib.pathfinder_launch(
            wall.data_ptr(), int(wall.dtype == torch.int32), out.data_ptr(),
            scratch.data_ptr(), R, C, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, NAME)
    pathfinder.launches += lib.pathfinder_launches(R)
    return out


pathfinder.launches = 0

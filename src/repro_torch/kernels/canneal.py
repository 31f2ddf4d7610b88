"""Canneal swap_cost: CUDA kernel + wrapper.

Replaces ``repro/kernels/canneal.py:34`` (``swap_cost``, ``pallas_call`` at
``:41``): for each of B candidate swaps, the manhattan distance of its F
fan-in locations (``fan_idx < 0`` is padding) to two candidate locations,
summed over the valid entries.  Indices ``>= N`` read row N-1, as the
reference's gather clamps them.

The CUDA kernel (``csrc/canneal.cu``) gives each swap one thread, which
walks its index row and gathers the locations through L2: the Pallas kernel
kept the whole table in VMEM, but PARSEC simlarge's 400,000-entry table
(3.2 MB) does not fit a block's shared memory.  Bound on an H100: memory
bandwidth, ~218 MB moved at simlarge (1,920,000 swaps x 22 fan slots), 65
us at 3.35 TB/s.  The Pallas kernel's ``B % block`` requirement is gone.
With integer-valued coordinates every sum is exact, so the kernel equals
the plain version bit for bit.  Locations and candidates in bfloat16,
float16 or int32 are widened to float32 first, as the reference's kernel
widens them (``repro/kernels/canneal.py:19,25-26``); the costs are float32
whatever the inputs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import _check, _promote, ref

NAME = "swap_cost"
# coordinate types the reference widens to float32 inside its kernel
WIDENED = (torch.bfloat16, torch.float16, torch.int32)


def _check_args(locs, fan_idx, cand_a, cand_b):
    _check.tensor(NAME, "locs", locs, (torch.float32,), 2)
    dev = locs.device
    _check.tensor(NAME, "fan_idx", fan_idx, (torch.int32,), 2, dev)
    _check.tensor(NAME, "cand_a", cand_a, (torch.float32,), 2, dev)
    _check.tensor(NAME, "cand_b", cand_b, (torch.float32,), 2, dev)
    N, B = locs.shape[0], fan_idx.shape[0]
    if locs.shape[1] != 2 or N == 0:
        raise ValueError(f"{NAME}: locs must be [N>0, 2], got "
                         f"{tuple(locs.shape)}")
    if N > _check.INT32_MAX or fan_idx.shape[1] > _check.INT32_MAX:
        raise ValueError(f"{NAME}: N and F must fit int32")
    for name, t in (("cand_a", cand_a), ("cand_b", cand_b)):
        if tuple(t.shape) != (B, 2):
            raise ValueError(f"{NAME}: {name} shape {tuple(t.shape)} != "
                             f"({B}, 2)")


def _lib():
    lib = _build.load("canneal")
    if not getattr(lib, "_repro_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.swap_cost_launch.argtypes = [p, p, p, p, p, p, ll, i, i, p]
        lib.swap_cost_launch.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def swap_cost(locs, fan_idx, cand_a, cand_b):
    """``(cost_a, cost_b)``, float32 ``[B]`` each, for float32 ``locs``
    ``[N,2]``, int32 ``fan_idx`` ``[B,F]`` and float32 ``cand_a``/``cand_b``
    ``[B,2]`` (bfloat16, float16 or int32 coordinates widened to float32
    first).  CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    locs, cand_a, cand_b = (_promote.widen(t, WIDENED)
                            for t in (locs, cand_a, cand_b))
    _check_args(locs, fan_idx, cand_a, cand_b)
    if _check.device_kind(NAME, locs) == "cpu":
        return ref.canneal_swap_cost(locs, fan_idx, cand_a, cand_b)
    for name, t in (("locs", locs), ("cand_a", cand_a), ("cand_b", cand_b)):
        _check.aligned(NAME, name, t, 8)       # read as float2
    B, F = fan_idx.shape
    out_a = torch.empty(B, dtype=torch.float32, device=locs.device)
    out_b = torch.empty_like(out_a)
    if B == 0:
        return out_a, out_b
    lib = _lib()
    with torch.cuda.device(locs.device):
        code = lib.swap_cost_launch(
            locs.data_ptr(), fan_idx.data_ptr(), cand_a.data_ptr(),
            cand_b.data_ptr(), out_a.data_ptr(), out_b.data_ptr(), B, F,
            locs.shape[0], torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, NAME)
    swap_cost.launches += 1
    return out_a, out_b


swap_cost.launches = 0

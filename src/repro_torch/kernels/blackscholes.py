"""Black-Scholes option pricing: CUDA kernel + wrapper.

Replaces ``repro/kernels/blackscholes.py:38`` (``blackscholes``, a Pallas
kernel over ``block``-sized VMEM tiles, ``pallas_call`` at ``:45``).  The
CUDA kernel (``csrc/blackscholes.cu``) is a flat grid-stride loop, one
option per thread per iteration: ``sqrtf``, ``logf``, ``expf`` and four
``erff`` per option, then a select on ``is_call != 0``.  There is no tile
requirement: the tail is masked, so any N works.

Bound on an H100: memory bandwidth.  Each option reads 6 x 4 B and writes
4 B; at the PARSEC-large size (6,553,600 evaluations) that is 183.5 MB, or
55 us at 3.35 TB/s.  The arithmetic (~100 float ops per option, 0.66
GFLOP) needs ~10 us at 67 TFLOP/s.  The design is therefore a plain
coalesced stream: consecutive threads read consecutive options, enough
blocks to cover every SM several times, no shared memory.  It is compiled
without ``--use_fast_math``: ``__expf``/``__logf`` would break the 3e-5
tolerance of the reference's tests.  Inputs in bfloat16 or float16 are
widened to float32 first and a boolean ``is_call`` taken as 0 or 1; the
prices come back in ``spot``'s type, the reference's output type
(``repro/kernels/blackscholes.py:50``), rounded once from float32 where
the reference rounds every step in the 16-bit type.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import _promote, ref


def _check_args(args):
    spot = args[0]
    if spot.dim() != 1:
        raise ValueError(f"blackscholes: inputs must be 1-D, got {spot.shape}")
    for name, t in zip(("spot", "strike", "rate", "vol", "time", "is_call"),
                       args):
        dtype = torch.int32 if name == "is_call" else torch.float32
        if t.dtype != dtype:
            raise ValueError(f"blackscholes: {name} must be {dtype}, "
                             f"got {t.dtype}")
        if t.shape != spot.shape:
            raise ValueError(f"blackscholes: {name} shape {tuple(t.shape)} "
                             f"!= {tuple(spot.shape)}")
        if t.device != spot.device:
            raise ValueError(f"blackscholes: {name} on {t.device}, "
                             f"spot on {spot.device}")
        if not t.is_contiguous():
            raise ValueError(f"blackscholes: {name} must be contiguous")


def _lib():
    lib = _build.load("blackscholes")
    if not getattr(lib, "_repro_typed", False):
        p = ctypes.c_void_p
        lib.blackscholes_launch.argtypes = [p, p, p, p, p, p, p,
                                            ctypes.c_longlong, p]
        lib.blackscholes_launch.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def blackscholes(spot, strike, rate, vol, time, is_call):
    """Price N options: ``[N]`` inputs of float32 (bfloat16 and float16
    widened to it), int32 or boolean ``is_call`` (0 put, nonzero call); the
    prices in ``spot``'s type.  CUDA tensors launch the kernel; CPU tensors
    take the plain version."""
    out_dtype = getattr(spot, "dtype", None)
    if isinstance(is_call, torch.Tensor) and is_call.dtype == torch.bool:
        is_call = is_call.to(torch.int32)
    args = (*(_promote.widen(t) for t in (spot, strike, rate, vol, time)),
            is_call)
    _check_args(args)
    spot = args[0]
    if spot.device.type == "cpu":
        return _promote.restore(ref.blackscholes(*args), out_dtype)
    if spot.device.type != "cuda":
        raise ValueError(f"blackscholes: unsupported device {spot.device}")
    out = torch.empty_like(spot)
    if spot.numel() == 0:
        return _promote.restore(out, out_dtype)
    lib = _lib()
    with torch.cuda.device(spot.device):
        code = lib.blackscholes_launch(
            *(t.data_ptr() for t in args), out.data_ptr(), spot.numel(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "blackscholes")
    blackscholes.launches += 1
    return _promote.restore(out, out_dtype)


blackscholes.launches = 0

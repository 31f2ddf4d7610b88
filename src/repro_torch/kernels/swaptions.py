"""Swaptions CumNormalInv (Moro's inverse normal CDF): CUDA kernel + wrapper.

Replaces ``repro/kernels/swaptions.py:42`` (``cum_normal_inv``, a Pallas
kernel over ``block``-sized VMEM tiles, ``pallas_call`` at ``:47``).  The
CUDA kernel (``csrc/swaptions.cu``) is a flat grid-stride loop, one uniform
per thread per iteration: the central rational polynomial and the log-log
tail polynomial, then a select on ``|u - 0.5| < 0.42``.  There is no tile
requirement: the tail of the grid is masked, so any N works.

Bound on an H100: memory bandwidth.  Each element reads and writes 4 B; at
PARSEC simlarge's 42,240,000 uniforms (64 swaptions x 20,000 trials x 11
tenor points x 3 factors) that is 337.9 MB, or 101 us at 3.35 TB/s, while
the ~40 float ops per element need ~25 us at 67 TFLOP/s.  It is compiled
without ``--use_fast_math`` and with ``-fmad=false``, so its float32
arithmetic is the plain version's term by term.  Uniforms in bfloat16 or
float16 are widened to float32 first and the result comes back in their
type (the reference's output type), rounded once from float32 where the
reference rounds every step in the 16-bit type.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import _check, _promote, ref

NAME = "cum_normal_inv"


def _lib():
    lib = _build.load("swaptions")
    if not getattr(lib, "_repro_typed", False):
        p = ctypes.c_void_p
        lib.cum_normal_inv_launch.argtypes = [p, p, ctypes.c_longlong, p]
        lib.cum_normal_inv_launch.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def cum_normal_inv(u):
    """Moro's inverse normal CDF of uniforms ``u`` ``[N]`` in float32
    (bfloat16 and float16 widened to it), in ``u``'s type.  CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    out_dtype = getattr(u, "dtype", None)
    u = _promote.widen(u)
    _check.tensor(NAME, "u", u, (torch.float32,), 1)
    if _check.device_kind(NAME, u) == "cpu":
        return _promote.restore(ref.cum_normal_inv(u), out_dtype)
    out = torch.empty_like(u)
    if u.numel() == 0:
        return _promote.restore(out, out_dtype)
    lib = _lib()
    with torch.cuda.device(u.device):
        code = lib.cum_normal_inv_launch(
            u.data_ptr(), out.data_ptr(), u.numel(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, NAME)
    cum_normal_inv.launches += 1
    return _promote.restore(out, out_dtype)


cum_normal_inv.launches = 0

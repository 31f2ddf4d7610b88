"""Mamba-2 SSD chunk scan: CUDA kernel + wrapper.

Replaces ``repro/kernels/ssd_scan.py:56`` (``ssd_scan``, ``pallas_call`` at
``:66``): for x ``[b,S,H,P]``, dt ``[b,S,H]``, A ``[H]`` and B, C
``[b,S,N]``, the SSD scan y ``[b,S,H,P]`` (D-skip and gating stay outside).
Every input is widened to float32; y has x's type.  ``Q = min(chunk, S)``
and ``S % Q`` must be 0, as in the Pallas wrapper, which raises there too.

The CUDA kernel (``csrc/ssd_scan.cu``) gives each (b, h) one 256-thread
block that walks the sequence in order in tiles of 64 steps, with the
head's ``[P, N]`` state in float32 shared memory; a head wider than 128 is
split into equal P-slices of at most 128 columns, one block each (each
column of the state is independent).  The result depends on
the chunk length only through rounding, so the kernel's tile is its own
(a 256-step decay block would not fit shared memory); the bar against the
plain version, which chunks at Q, is the reference's 4e-3.  x may be
float32, bfloat16 or float16; dt, A, B and C are widened to float32 here
before the launch, and other types of x (64-bit, integers) are converted
first by the reference's rule (``_promote``), y keeping x's type.  Any P;
a block's shared memory (its slice of the state, one tile of x dt, B, C
and the decay block) must fit the card's 227 KB, which bounds N.  Bound on
an H100: operations.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import _check, _promote, ref

NAME = "ssd_scan"
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the opt-in shared memory of one block on an H100
MAX_SMEM = 232_448


def _check_args(x, dt, A, B, C, chunk):
    _check.tensor(NAME, "x", x, X_DTYPES, 4)
    b, S, H, P = x.shape
    for name, t, ndim in (("dt", dt, 3), ("A", A, 1), ("B", B, 3),
                          ("C", C, 3)):
        _check.tensor(NAME, name, t, (torch.float32,), ndim, x.device)
    if dt.shape != (b, S, H) or A.shape != (H,):
        raise ValueError(f"{NAME}: dt {tuple(dt.shape)} and A "
                         f"{tuple(A.shape)} must be [b, S, H] and [H] for x "
                         f"{tuple(x.shape)}")
    if B.shape != C.shape or B.shape[:2] != (b, S):
        raise ValueError(f"{NAME}: B {tuple(B.shape)} and C "
                         f"{tuple(C.shape)} must be [b, S, N] for x "
                         f"{tuple(x.shape)}")
    Q = min(int(chunk), S)
    if Q < 1 or S % Q:
        raise ValueError(f"{NAME}: S = {S} is not a multiple of the chunk "
                         f"length Q = min({chunk}, S)")


def _lib():
    lib = _build.load("ssd_scan")
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.ssd_scan_launch.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [i, i]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
        lib._repro_typed = True
    return lib


def ssd_scan(x, dt, A, B, C, chunk: int = 256):
    """y ``[b,S,H,P]`` in x's type.  CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    (x,), out_dtype = _promote.promote((x,), X_DTYPES)
    dt, A, B, C = (t.to(torch.float32) if isinstance(t, torch.Tensor)
                   and not t.is_complex() else t for t in (dt, A, B, C))
    _check_args(x, dt, A, B, C, chunk)
    if _check.device_kind(NAME, x) == "cpu":
        return _promote.restore(ref.ssd_scan(x, dt, A, B, C, chunk),
                                out_dtype)
    b, S, H, P = x.shape
    N = B.shape[-1]
    if P < 1 or N < 1:
        raise ValueError(f"{NAME}: head dim P = {P} and N = {N} must be "
                         ">= 1")
    if S > _check.INT32_MAX or b * H > _check.INT32_MAX:
        raise ValueError(f"{NAME}: S and b*H must fit int32")
    lib = _lib()
    smem = lib.ssd_scan_smem_bytes(P, N)
    if smem > MAX_SMEM:
        raise ValueError(f"{NAME}: P = {P}, N = {N} need {smem} bytes of "
                         f"shared memory per block, more than {MAX_SMEM}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return _promote.restore(out, out_dtype)
    with torch.cuda.device(x.device):
        code = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), out.data_ptr(), b, S, H, P, N, X_DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, NAME)
    ssd_scan.launches += 1
    return _promote.restore(out, out_dtype)


ssd_scan.launches = 0

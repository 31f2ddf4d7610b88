"""Flash decoding (one query token against a KV cache): CUDA kernel +
wrapper.

Replaces ``repro/kernels/decode_attention.py:51`` (``decode_attention``,
``pallas_call`` at ``:57``): for q ``[B,H,D]`` and a cache k, v
``[B,S,H,D]``, softmax attention over the keys ``ki < kv_len[b]``, masked
with the Pallas kernel's finite -1e30.  At ``kv_len <= 0`` the result is
therefore the mean of V over all S positions, as the Pallas kernel gives it
(``repro/kernels/ref.py`` gives NaN there; the port follows the kernel).
q and the cache are each float32, bfloat16 or float16 (k and v of one
type), computed in float32 and returned in q's type, as the Pallas kernel
widens them.

The CUDA kernel (``csrc/decode_attention.cu``) gives each (b, h) one
256-thread block whose 8 warps stream the keys below ``kv_len`` 8 rows at a
time (16 from a 16-bit cache, 4 at D > 128) with their own online softmax,
merged at the end; keys past ``kv_len`` are not read; a 16-bit cache is
widened as it is loaded, two elements a lane where D is even.  Any S,
D <= 256.  Bound on an H100: bytes, the cache rows the lengths need,
read once.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import _check, ref

NAME = "decode_attention"
MAX_D = 256
# the C entry point's code for each type of q and of the cache
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_args(q, k, v, lens):
    _check.tensor(NAME, "q", q, DTYPES, 3)
    _check.tensor(NAME, "k", k, DTYPES, 4, q.device)
    _check.tensor(NAME, "v", v, (k.dtype,), 4, q.device)
    _check.tensor(NAME, "kv_len", lens, (torch.int32,), 1, q.device)
    B, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"{NAME}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be [B, S, H, D] for q "
                         f"{tuple(q.shape)}")
    if lens.shape[0] != B:
        raise ValueError(f"{NAME}: kv_len has {lens.shape[0]} entries for "
                         f"B = {B}")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"{NAME}: head dim D = {D} must be in 1..{MAX_D}")
    if k.shape[1] < 1 or k.shape[1] > _check.INT32_MAX - 64 \
            or B * H > _check.INT32_MAX:
        raise ValueError(f"{NAME}: S = {k.shape[1]} must be in 1..2^31 and "
                         "B*H must fit int32")


def _lib():
    lib = _build.load("decode_attention")
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_launch.argtypes = [p, p, p, p, p, i, i, i, i,
                                                ctypes.c_float, i, i, p]
        lib.decode_attention_launch.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def decode_attention(q, k, v, kv_len):
    """``[B,H,D]`` in q's type; ``kv_len`` is int32 ``[B]``.  CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    _check_args(q, k, v, kv_len)
    if _check.device_kind(NAME, q) == "cpu":
        return ref.decode_attention(q, k, v, kv_len)
    B, S, H, D = k.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), B, S, H, D, D ** -0.5, DTYPES[q.dtype],
            DTYPES[k.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, NAME)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

"""Flash attention (forward): CUDA kernel + wrapper.

Replaces ``repro/kernels/flash_attention.py:65`` (``flash_attention``,
``pallas_call`` at ``:75``): softmax attention over q, k, v ``[B,S,H,D]``,
causal or not, float32 or bfloat16, with the online softmax in float32 and
the output in the inputs' type.

The CUDA kernel (``csrc/flash_attention.cu``) reads the ``[B,S,H,D]`` layout
in place (no transposes to ``[B*H,S,D]``): one 256-thread block per (b*H +
h, 64-query tile) walks the 64-key tiles, skipping those wholly above the
diagonal when causal, with the running max, sum and accumulator of each row
in registers.  Any S (a ragged last tile is masked) and D <= 128.  A float32
SIMT kernel: TF32 would miss the float32 bar of 2e-4.  Bound on an H100:
operations, 4*D flops per (query, key) pair the mask keeps.  The Pallas
block sizes (``bq``, ``bk``) have no counterpart.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import _check, ref

NAME = "flash_attention"
DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 128
# gridDim.y holds B * H
MAX_BH = 65_535


def _check_args(q, k, v):
    _check.tensor(NAME, "q", q, DTYPES, 4)
    for name, t in (("k", k), ("v", v)):
        _check.tensor(NAME, name, t, (q.dtype,), 4, q.device)
        if t.shape != q.shape:
            raise ValueError(f"{NAME}: {name} {tuple(t.shape)} differs from "
                             f"q {tuple(q.shape)} (Sq = Sk, no GQA)")
    B, S, H, D = q.shape
    if not 1 <= D <= MAX_D:
        raise ValueError(f"{NAME}: head dim D = {D} must be in 1..{MAX_D}")
    if B * H > MAX_BH or S > _check.INT32_MAX - 64:
        raise ValueError(f"{NAME}: B*H = {B * H} must be <= {MAX_BH} and S "
                         "must fit int32")


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i,
                                               ctypes.c_float, i, i, p]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def flash_attention(q, k, v, causal=True):
    """``[B,S,H,D]`` attention output in q's type.  CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    _check_args(q, k, v)
    if _check.device_kind(NAME, q) == "cpu":
        return ref.flash_attention(q, k, v, causal=causal)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, D, D ** -0.5, int(bool(causal)),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, NAME)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

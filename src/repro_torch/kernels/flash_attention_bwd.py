"""Flash attention (backward): CUDA kernel + wrapper.

Replaces no Pallas kernel: the reference differentiates its plain
attention (``repro/models/layers.py:142`` ``_exact_attn``, ``:159``
``_chunked_attn``).  ``flash_attention_bwd`` takes q, k, v, the forward's
output and its row log-sum-exp (``flash_attention.flash_attention_lse``)
and dout, all ``[B,S,H,D]`` but lse ``[B,H,S]``, and returns dq, dk, dv in
the inputs' type, with float32 sums.  ``layers.FlashAttention`` calls it
for every D its forward route takes up to 128 (``route``: chosen by D
alone); wider heads keep the plain route's VJP, counted by
``flash_attention_bwd.plain_vjp_calls``.

The CUDA kernel (``csrc/flash_attention_bwd.cu``), bfloat16 and float16:
one pass over the kept (query, key) pairs on ``wgmma`` with TMA loads, in
three kernels: a pre-pass writes each row's Delta = rowsum(dO * O) and
lse * log2(e) to a scratch buffer; the main kernel (a block a 128-key
tile, walking the query tiles between the causal diagonal and the last)
forms S and dP once a pair and takes dK, dV and dQ's share from them,
adding dQ in float32 into a workspace (``dq_acc``) in ascending key-block
order, each (head, 64-row query tile) paced by an int32 counter; a
post-pass writes dq = dq_acc * scale in the inputs' type.  So two calls
give the same bits.  float32: two passes with no atomics (a dQ pass that
also writes the scratch statistics, then a dK/dV pass) as 3xTF32 on
``mma.sync`` with cp.async loads.  The kernel takes D a multiple of 8 and
16-byte aligned rows: the wrapper zero-pads other D (zero columns add
nothing to a product; the scale stays D's) and copies a misaligned
operand.  A call is a memset and three launches (float32: two), counted
once by ``flash_attention_bwd.launches``.

Bound on an H100: operations, 10 D flops a kept (query, key) pair at the
tensor cores' rate, the 16-bit kernel's own count (float32: 14 D, S and
dP formed in both passes).  On CPU tensors the plain version
(``ref.flash_attention_bwd``) runs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build, _device
from repro_torch.kernels import _check, ref

NAME = "flash_attention_bwd"
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_D = 128          # the widest head the kernel takes
D_STEP = 8           # the kernel's D is a multiple of this (zero-padded)
STAT_ROWS = 128      # the scratch buffer holds two 64-row tiles a 128 rows
DQ_ROWS = 64         # 16-bit: query rows a tile of the dQ workspace


def route(D: int) -> str:
    """The backward of a head of D columns: ``"kernel"`` up to ``MAX_D``,
    else ``"plain_vjp"`` (the plain route's vector-Jacobian product)."""
    return "kernel" if D <= MAX_D else "plain_vjp"


def _lib():
    lib = _build.load(NAME)
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_bwd_launch.argtypes = [
            p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, ctypes.c_float, i,
            i, p]
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _check_args(q, k, v, out, lse, dout):
    _check.tensor(NAME, "q", q, DTYPES, 4)
    for name, t in (("k", k), ("v", v), ("out", out), ("dout", dout)):
        _check.tensor(NAME, name, t, (q.dtype,), 4, q.device)
        if t.shape != q.shape:
            raise ValueError(f"{NAME}: {name} {tuple(t.shape)} differs from "
                             f"q {tuple(q.shape)}")
    B, S, H, D = q.shape
    _check.tensor(NAME, "lse", lse, (torch.float32,), 3, q.device)
    if tuple(lse.shape) != (B, H, S):
        raise ValueError(f"{NAME}: lse {tuple(lse.shape)} is not [B, H, S] "
                         f"= {(B, H, S)}")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"{NAME}: D = {D} outside 1..{MAX_D} (wider heads "
                         "take the plain route's VJP)")
    if B * H > _check.INT32_MAX or S > _check.INT32_MAX - STAT_ROWS:
        raise ValueError(f"{NAME}: B*H = {B * H} and S must fit int32")


def _kernel_operand(t, D_pad):
    """``t`` zero-padded to ``D_pad`` columns, in storage the kernel's
    16-byte loads may read (a fresh copy where ``t`` starts off 16
    bytes)."""
    if t.shape[-1] != D_pad:
        return torch.nn.functional.pad(t, (0, D_pad - t.shape[-1]))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_bwd(q, k, v, out, lse, dout, causal=True):
    """(dq, dk, dv) of causal or full softmax attention at D <= 128, from
    the forward's output and row log-sum-exp.  CUDA tensors launch the
    kernel (counted once a call); CPU tensors take the plain version."""
    q, k, v, out, lse, dout = (t.contiguous()
                               for t in (q, k, v, out, lse, dout))
    _check_args(q, k, v, out, lse, dout)
    if not q.is_cuda and _check.device_kind(NAME, q) == "cpu":
        return ref.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    B, S, H, D = q.shape
    if q.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    D_pad = -(-D // D_STEP) * D_STEP
    ops = [_kernel_operand(t, D_pad) for t in (q, k, v, out, dout)]
    lse = lse if lse.data_ptr() % 16 == 0 else lse.clone()
    grads = [torch.empty_like(t) for t in ops[:3]]
    stats = torch.empty(B * H * (-(-S // STAT_ROWS)) * 2 * STAT_ROWS,
                        dtype=torch.float32, device=q.device)
    dq_acc = dq_count = None
    if q.dtype != torch.float32:
        # dQ's float32 sums, [B*H][query tiles][64-column panels][64][64],
        # and a counter a (head, query tile); no fill: the kernel stores
        # the first key block's share and resets the counters
        tiles = B * H * (-(-S // DQ_ROWS))
        dq_acc = torch.empty(tiles * (1 if D_pad <= 64 else 2) * DQ_ROWS
                             * 64, dtype=torch.float32, device=q.device)
        dq_count = torch.empty(tiles, dtype=torch.int32, device=q.device)
    lib = _lib()
    code = _device.launch(
        lib.flash_attention_bwd_launch, q, *(t.data_ptr() for t in ops),
        lse.data_ptr(), *(g.data_ptr() for g in grads), stats.data_ptr(),
        *(0 if t is None else t.data_ptr() for t in (dq_acc, dq_count)), B,
        S, H, D_pad, D ** -0.5, int(bool(causal)), DTYPES[q.dtype])
    _build.check(lib, code, NAME)
    flash_attention_bwd.launches += 1
    if D_pad != D:
        grads = [g[..., :D] for g in grads]
    return tuple(grads)


flash_attention_bwd.launches = 0
flash_attention_bwd.plain_vjp_calls = 0

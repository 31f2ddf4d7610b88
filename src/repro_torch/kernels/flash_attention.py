"""Flash attention (forward): CUDA kernel + wrapper.

Replaces ``repro/kernels/flash_attention.py:65`` (``flash_attention``,
``pallas_call`` at ``:75``): softmax attention over q, k, v ``[B,S,H,D]``,
causal or not, float32, bfloat16 or float16, with the online softmax in
float32 and the output in the inputs' type.

The CUDA kernel (``csrc/flash_attention.cu``) reads the ``[B,S,H,D]`` layout
in place (no transposes to ``[B*H,S,D]``) and runs every product on the
tensor cores: one block per (b*H + h, 128-query tile), a loader warpgroup
filling a ring of K/V tiles and two consumer warpgroups of 64 rows each,
skipping the key tiles wholly above the diagonal when causal.  bfloat16
and float16 run on ``wgmma``; float32 as 3xTF32 on ``mma.sync`` (three TF32
products per product keep float32's accuracy).  The routes, by type and
D (any S):

- every type at D 1..128: ``wgmma/*`` (16-bit) or ``3xtf32/*`` (float32),
  counted by ``flash_attention.launches``;
- bfloat16 and float16 at D 129..256: the wgmma kernel's D-256
  instantiation (``wgmma256/*``: 48-key tiles, three stages), counted by
  ``flash_attention.wgmma256_launches``;
- bfloat16 and float16 at D 257..512: its D-512 instantiation
  (``wgmma512/*``: 64 query rows a block, both consumer warpgroups
  computing the same scores and each half of the output's panels; 32-key
  tiles, two stages), counted by ``flash_attention.wgmma512_launches``;
- float32 past 128 and every type past 512: a float32 SIMT kernel
  (``csrc/flash_attention_wide.cu``, ``simt/wide``), counted by
  ``flash_attention.wide_launches``, which splits D past 256 into output
  slices of 256 columns.

``path`` names the route and, on the tensor cores, how the tiles are
loaded, from the type, D and the pointers' alignment.

Operands the kernels do not take as they are (64-bit, mixed or integer
types) are converted first by the reference's rule (``_promote``): the
output has q's type.  Bound on an H100: operations, 4*D flops per (query,
key) pair the mask keeps.  The Pallas block sizes (``bq``, ``bk``) have no
counterpart.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import _check, _promote, ref

NAME = "flash_attention"
# the C entry points' code for each input type
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the widest head of the tensor-core kernels in every type, of the 16-bit
# kernel's D-256 instantiation, and in the 16-bit types (the D-512 one)
MAX_D_TC, MAX_D_256, MAX_D_TC16 = 128, 256, 512
# at most this many heads B * H (the C entry point also refuses a grid of
# more than 2^31 - 1 blocks, query tiles x B * H)
MAX_BH = 65_535
# How the tensor-core kernel loads its tiles (the C entry point's ``load``
# code), by path: 16-bit types by TMA where rows are 16-byte aligned, by
# 4-byte cp.async where they are 4-byte aligned, else by plain loads;
# float32 by 16- or 4-byte cp.async.  The products run on the tensor cores
# on every path; ``wgmma256`` and ``wgmma512`` are the 16-bit kernel's D-256
# and D-512 instantiations.  Float32 heads wider than MAX_D_TC and any head
# wider than MAX_D_TC16 take the path WIDE.
LOADS = {"wgmma/tma": 0, "wgmma/cp.async": 4, "wgmma/ld": 2,
         "wgmma256/tma": 0, "wgmma256/cp.async": 4, "wgmma256/ld": 2,
         "wgmma512/tma": 0, "wgmma512/cp.async": 4, "wgmma512/ld": 2,
         "3xtf32/cp.async16": 16, "3xtf32/cp.async4": 4}
WIDE = "simt/wide"


def _check_args(q, k, v):
    _check.tensor(NAME, "q", q, DTYPES, 4)
    for name, t in (("k", k), ("v", v)):
        _check.tensor(NAME, name, t, (q.dtype,), 4, q.device)
        if t.shape != q.shape:
            raise ValueError(f"{NAME}: {name} {tuple(t.shape)} differs from "
                             f"q {tuple(q.shape)} (Sq = Sk, no GQA)")
    B, S, H, D = q.shape
    if D < 1:
        raise ValueError(f"{NAME}: head dim D = {D} must be >= 1")
    if B * H > MAX_BH or S > _check.INT32_MAX - 64:
        raise ValueError(f"{NAME}: B*H = {B * H} must be <= {MAX_BH} and S "
                         "must fit int32")


def _alignment(*ts) -> int:
    """The largest of 16, 8, 4, 2, 1 bytes that every data pointer is a
    multiple of."""
    a = 16
    for t in ts:
        while t.data_ptr() % a:
            a //= 2
    return a


def path(q, k, v) -> str:
    """The kernel's path for these operands (of one type the kernels
    take): ``WIDE`` for float32 above ``MAX_D_TC`` and any type above
    ``MAX_D_TC16``, else a key of ``LOADS`` (a row of one head starts at a
    multiple of D elements, so D and the base pointers decide its
    alignment)."""
    D, a = q.shape[-1], _alignment(q, k, v)
    f32 = q.dtype == torch.float32
    if D > MAX_D_TC16 or (f32 and D > MAX_D_TC):
        return WIDE
    if not f32:
        kernel = ("wgmma" if D <= MAX_D_TC else
                  "wgmma256" if D <= MAX_D_256 else "wgmma512")
        if D % 8 == 0 and a >= 16:
            return f"{kernel}/tma"
        return f"{kernel}/cp.async" if D % 2 == 0 and a >= 4 \
            else f"{kernel}/ld"
    return "3xtf32/cp.async16" if D % 4 == 0 and a >= 16 else \
        "3xtf32/cp.async4"


def _lib(name="flash_attention"):
    lib = _build.load(name)
    if not getattr(lib, "_repro_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "flash_attention":
            fn = lib.flash_attention_launch
            fn.argtypes = [p, p, p, p, i, i, i, i, f, i, i, i, p]
        else:
            fn = lib.flash_attention_wide_launch
            fn.argtypes = [p, p, p, p, i, i, i, i, f, i, i, p]
        fn.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def flash_attention(q, k, v, causal=True):
    """``[B,S,H,D]`` attention output in q's type.  CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    (q, k, v), out_dtype = _promote.promote((q, k, v), DTYPES)
    _check_args(q, k, v)
    if _check.device_kind(NAME, q) == "cpu":
        return _promote.restore(ref.flash_attention(q, k, v, causal=causal),
                                out_dtype)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return _promote.restore(out, out_dtype)
    route = path(q, k, v)
    lib = _lib("flash_attention_wide" if route == WIDE else "flash_attention")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, D, D ** -0.5, int(bool(causal)), DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == WIDE:
            code = lib.flash_attention_wide_launch(*args, stream)
        else:
            code = lib.flash_attention_launch(*args, LOADS[route], stream)
    _build.check(lib, code, NAME)
    if route == WIDE:
        flash_attention.wide_launches += 1
    elif D > MAX_D_256:
        flash_attention.wgmma512_launches += 1
    elif D > MAX_D_TC:
        flash_attention.wgmma256_launches += 1
    else:
        flash_attention.launches += 1
    return _promote.restore(out, out_dtype)


flash_attention.launches = 0
flash_attention.wgmma256_launches = 0
flash_attention.wgmma512_launches = 0
flash_attention.wide_launches = 0

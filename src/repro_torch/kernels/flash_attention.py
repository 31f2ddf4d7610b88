"""Flash attention (forward): CUDA kernel + wrapper.

Replaces ``repro/kernels/flash_attention.py:65`` (``flash_attention``,
``pallas_call`` at ``:75``): softmax attention over q, k, v ``[B,S,H,D]``,
causal or not, float32, bfloat16 or float16, with the online softmax in
float32 and the output in the inputs' type.

The CUDA kernel (``csrc/flash_attention.cu``) reads the ``[B,S,H,D]`` layout
in place (no transposes to ``[B*H,S,D]``) and runs every product on the
tensor cores: a loader warpgroup filling a ring of K/V tiles and two
consumer warpgroups, skipping the key tiles wholly above the diagonal when
causal.  bfloat16 and float16 run on ``wgmma``; float32 as 3xTF32 on
``mma.sync`` (three TF32 products per product keep float32's accuracy).
The routes, by type and D (any S):

- every type at D 1..128: ``wgmma/*`` (16-bit) or ``3xtf32/*`` (float32),
  128 query rows a block, counted by ``flash_attention.launches``;
- float32 at D 129..256: the 3xTF32 kernel's D-256 instantiation
  (``3xtf32_256/*``: 64 query rows a block, two warps on each 16 rows
  each holding half the output's columns; 32-key tiles, two stages),
  counted by ``flash_attention.tf32_256_launches``;
- bfloat16 and float16 at D 129..256: the wgmma kernel's D-256
  instantiation (``wgmma256/*``: 48-key tiles, three stages), counted by
  ``flash_attention.wgmma256_launches``;
- bfloat16 and float16 at D 257..512: its D-512 instantiation
  (``wgmma512/*``: 64 query rows a block, both consumer warpgroups
  computing the same scores and each half of the output's panels; 32-key
  tiles, two stages), counted by ``flash_attention.wgmma512_launches``;
- bfloat16 and float16 past 512: the sliced kernel (``wgmma_sliced/*``:
  output slices of at most 512 columns, one block each, every block
  computing the scores over all of D with Q resident or streamed, as
  ``slice_plan`` says), counted by ``flash_attention.sliced_launches``;
- float32 past 256: the 3xTF32 sliced kernel (``3xtf32_sliced/*``: 32
  query rows a block, 16-key tiles, output slices of at most 512 columns,
  one block each, four warps on each 16 rows splitting D for the scores
  and summing their partial scores in one order; Q resident or streamed,
  as ``tf32_slice_plan`` says), counted by
  ``flash_attention.tf32_sliced_launches``.

``path`` names the route and how the tiles are loaded, from the type, D
and the pointers' alignment.

Operands the kernels do not take as they are (64-bit, mixed or integer
types) are converted first by the reference's rule (``_promote``): the
output has q's type.  Bound on an H100: operations, 4*D flops per (query,
key) pair the mask keeps.  The Pallas block sizes (``bq``, ``bk``) have no
counterpart.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import _build, _device
from repro_torch.kernels import _check, _promote, ref

NAME = "flash_attention"
# the C entry points' code for each input type
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the widest head of the tensor-core kernels in every type (128 query rows
# a block), of their D-256 instantiations, and of the 16-bit D-512 one;
# the 16-bit types past it, and float32 past MAX_D_256, take the sliced
# kernels
MAX_D_TC, MAX_D_256, MAX_D_512 = 128, 256, 512
# How the tensor-core kernel loads its tiles (the C entry point's ``load``
# code), by path: 16-bit types by TMA where rows are 16-byte aligned, by
# 4-byte cp.async where they are 4-byte aligned, else by plain loads;
# float32 by 16- or 4-byte cp.async.  The products run on the tensor cores
# on every path; ``wgmma256`` and ``wgmma512`` are the 16-bit kernel's D-256
# and D-512 instantiations, ``wgmma_sliced`` its sliced kernel,
# ``3xtf32_256`` the float32 kernel's D-256 instantiation and
# ``3xtf32_sliced`` its sliced kernel.
LOADS = {"wgmma/tma": 0, "wgmma/cp.async": 4, "wgmma/ld": 2,
         "wgmma256/tma": 0, "wgmma256/cp.async": 4, "wgmma256/ld": 2,
         "wgmma512/tma": 0, "wgmma512/cp.async": 4, "wgmma512/ld": 2,
         "wgmma_sliced/tma": 0, "wgmma_sliced/cp.async": 4,
         "wgmma_sliced/ld": 2,
         "3xtf32/cp.async16": 16, "3xtf32/cp.async4": 4,
         "3xtf32_256/cp.async16": 16, "3xtf32_256/cp.async4": 4,
         "3xtf32_sliced/cp.async16": 16, "3xtf32_sliced/cp.async4": 4}
# the launch counter of each route's kernel
COUNTERS = {"wgmma": "launches", "3xtf32": "launches",
            "3xtf32_256": "tf32_256_launches",
            "wgmma256": "wgmma256_launches", "wgmma512": "wgmma512_launches",
            "wgmma_sliced": "sliced_launches",
            "3xtf32_sliced": "tf32_sliced_launches"}

# The sliced kernel's shared memory (csrc/flash_attention.cu, SlicedSmem):
# what a block may use on an H100, the alignment and the barriers' 1024
# bytes each, a 64-column panel of the 64 query rows and of a 32-key tile,
# and the most chunks its barriers allow.
SMEM_MAX, SMEM_FIXED = 232_448, 2 * 1024
PANEL_Q, PANEL_K, RING_MAX = 64 * 128, 32 * 128, 48


class Slices(NamedTuple):
    """The sliced kernel's plan for a head of D columns."""
    n: int            # output slices, one block each per query tile
    panels: int       # 64-column panels a slice (the last may hold fewer)
    q_resident: bool  # Q's panels stay in shared memory, else each chunk
                      # of the ring carries Q's panels beside K's
    chunk: int        # panels of a key tile a chunk of the ring holds
    ring: int         # chunks in the ring


def slice_plan(D: int) -> Slices:
    """Slices of at most 8 panels, the same count each where D allows
    (D 640: 2 x 5, not 8 + 2).  Q stays resident while Q and two key
    tiles of K fit beside V's two stages (up to D 704): a chunk is then a
    whole key tile and the ring its two stages.  Wider, a chunk is three
    panels of K and three of Q, as many as what is left holds (at D
    1,024 chunks of 3 ran faster than of 2 or 1 on an H100: PERF.md)."""
    nq = -(-D // 64)
    panels = -(-nq // -(-nq // 8))
    room = SMEM_MAX - SMEM_FIXED - 2 * panels * PANEL_K
    n = -(-nq // panels)
    if nq * PANEL_Q + 2 * nq * PANEL_K <= room:
        return Slices(n, panels, True, nq, 2)
    chunk = min(3, nq)
    ring = min(RING_MAX, room // (chunk * (PANEL_K + PANEL_Q)))
    return Slices(n, panels, False, chunk, ring)


# The float32 sliced kernel's (csrc/flash_attention.cu, F32SlicedSmem): 32
# query rows and 16-key tiles of 64-column panels whose rows are padded by
# 4 floats, and the consumer warps' partial scores (two buffers of 8 x 16
# x 16 floats) beside the barriers and the alignment.
F32_PANEL_Q, F32_PANEL_K = 32 * 68 * 4, 16 * 68 * 4
F32_SMEM_FIXED = SMEM_FIXED + 2 * 8 * 16 * 16 * 4


def tf32_slice_plan(D: int) -> Slices:
    """The float32 sliced kernel's plan: slices as ``slice_plan`` cuts
    them (at most 8 panels, the same count each where D allows), V's two
    stages of a slice's 16-key rows, and Q resident while it fits beside
    two chunks of three panels of K (or of the whole tile, if shorter): a
    chunk then as many panels of a key tile as fit twice (the whole tile
    to D 576), the ring as many chunks as fit (to D 896).  Wider, chunks
    of three panels of K and Q's beside them."""
    nq = -(-D // 64)
    panels = -(-nq // -(-nq // 8))
    n = -(-nq // panels)
    room = (SMEM_MAX - F32_SMEM_FIXED
            - 2 * 16 * (64 * panels + 4) * 4)
    left = room - nq * F32_PANEL_Q
    if left >= 2 * min(3, nq) * F32_PANEL_K:
        chunk = min(nq, left // (2 * F32_PANEL_K))
        return Slices(n, panels, True, chunk,
                      min(RING_MAX, left // (chunk * F32_PANEL_K)))
    pair = F32_PANEL_K + F32_PANEL_Q
    chunk = min(3, nq, room // (2 * pair))
    return Slices(n, panels, False, chunk,
                  min(RING_MAX, room // (chunk * pair)))


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
    # the grid is one-dimensional: the C entry points refuse only more than
    # 2^31 - 1 blocks (query tiles x B * H, x slices)
    if B * H > _check.INT32_MAX or S > _check.INT32_MAX - 64:
        raise ValueError(f"{NAME}: B*H = {B * H} and S must fit int32")


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
    take), a key of ``LOADS`` (a row of one head starts at a multiple of D
    elements, so D and the base pointers decide its alignment)."""
    D, a = q.shape[-1], _alignment(q, k, v)
    if q.dtype == torch.float32:
        kernel = ("3xtf32" if D <= MAX_D_TC else "3xtf32_256"
                  if D <= MAX_D_256 else "3xtf32_sliced")
        return f"{kernel}/cp.async16" if D % 4 == 0 and a >= 16 else \
            f"{kernel}/cp.async4"
    kernel = ("wgmma" if D <= MAX_D_TC else "wgmma256" if D <= MAX_D_256
              else "wgmma512" if D <= MAX_D_512 else "wgmma_sliced")
    if D % 8 == 0 and a >= 16:
        return f"{kernel}/tma"
    return f"{kernel}/cp.async" if D % 2 == 0 and a >= 4 else f"{kernel}/ld"


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_repro_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, f, i,
                                               i, i, p]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_sliced_launch.argtypes = [
            p, p, p, p, i, i, i, i, f, i, i, i, i, i, i, i, i, p]
        lib.flash_attention_sliced_launch.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def flash_attention(q, k, v, causal=True):
    """``[B,S,H,D]`` attention output in q's type.  CUDA tensors launch the
    kernel of their route (``path``); CPU tensors take the plain version."""
    (q, k, v), out_dtype = _promote.promote((q, k, v), DTYPES)
    _check_args(q, k, v)
    if not q.is_cuda and _check.device_kind(NAME, q) == "cpu":
        return _promote.restore(ref.flash_attention(q, k, v, causal=causal),
                                out_dtype)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return _promote.restore(out, out_dtype)
    route = path(q, k, v)
    kernel = route.split("/")[0]
    lib = _lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, D, D ** -0.5, int(bool(causal)), DTYPES[q.dtype])
    if kernel in ("wgmma_sliced", "3xtf32_sliced"):
        plan = slice_plan(D) if kernel == "wgmma_sliced" else \
            tf32_slice_plan(D)
        code = _device.launch(lib.flash_attention_sliced_launch, q, *args,
                              LOADS[route], plan.n, plan.panels, plan.chunk,
                              plan.ring, int(plan.q_resident))
    else:
        code = _device.launch(lib.flash_attention_launch, q, *args,
                              LOADS[route])
    _build.check(lib, code, NAME)
    counter = COUNTERS[kernel]
    setattr(flash_attention, counter, getattr(flash_attention, counter) + 1)
    return _promote.restore(out, out_dtype)


flash_attention.launches = 0
flash_attention.tf32_256_launches = 0
flash_attention.wgmma256_launches = 0
flash_attention.wgmma512_launches = 0
flash_attention.sliced_launches = 0
flash_attention.tf32_sliced_launches = 0

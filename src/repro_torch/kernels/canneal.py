"""Canneal swap_cost: CUDA kernels + wrapper.

Replaces ``repro/kernels/canneal.py:34`` (``swap_cost``, ``pallas_call`` at
``:41``): for each of B candidate swaps, the manhattan distance of its F
fan-in locations (``fan_idx < 0`` is padding) to two candidate locations,
summed over the valid entries.  Indices ``>= N`` read row N-1, as the
reference's gather clamps them.

The Pallas kernel kept the whole table in VMEM, but PARSEC simlarge's
400,000-entry table (3.2 MB) does not fit a block's shared memory, so both
CUDA kernels (``csrc/canneal.cu``) gather the locations through L2, one
swap a thread.  ``route`` picks one on the host:

- ``tiles`` (rows of 1 to ``MAX_F`` slots; counted by
  ``swap_cost.launches``): persistent CTAs take tiles of ``TILE`` swaps,
  each tile's contiguous ``[TILE, F]`` index block staged coalesced in
  shared memory by 16-byte cp.async (4-byte copies at an unaligned head or
  tail), double-buffered;
- ``rows`` (wider rows, or none; ``swap_cost.rows_launches``; ``rows``
  runs it at any F): the same persistent CTAs, each tile's rows staged in
  chunks of ``ROW_CHUNK`` slots, a ``[TILE, ROW_CHUNK]`` block of strided
  row segments at a time (16-byte cp.async, 4-byte copies at each
  segment's unaligned head and tail; ``rows_plan``); each thread carries
  its swap's sums across the chunks.

Both keep every gather of eight slots in flight before any sum uses them.

Bound on an H100: memory bandwidth, ~218 MB moved at simlarge (1,920,000
swaps x 22 fan slots), 65 us at 3.35 TB/s.  The Pallas kernel's ``B %
block`` requirement is gone.  Each row sums in slot order; with
integer-valued coordinates every sum is exact, so both kernels equal the
plain version bit for bit.  Locations and candidates in bfloat16, float16
or int32 are widened to float32 first, as the reference's kernel widens
them (``repro/kernels/canneal.py:19,25-26``); the costs are float32
whatever the inputs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch import _build, _device
from repro_torch.kernels import _check, _promote, ref

NAME = "swap_cost"
# swaps a tile (one a thread) and the widest row the tile kernel stages
# (csrc/canneal.cu TILE, MAX_F: two buffers of 256 rows of 96 slots fill
# 192 KB of a CTA's shared memory)
TILE, MAX_F = 256, 96
# the row kernel: slots a stage and words a staged row (a chunk and up to 3
# words ahead of it; csrc/canneal.cu ROW_CHUNK, ROW_PITCH, whose launch
# rejects a plan of another tile or chunk); one stage of 256 such rows in
# static shared memory (36 KB); a CTA's shared memory at most (an H100's
# opt-in)
ROW_CHUNK, ROW_PITCH, MAX_SMEM = 32, 36, 232_448
ROW_STAGES, ROW_SMEM = 1, TILE * ROW_PITCH * 4
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


def route(F: int) -> str:
    """``"tiles"`` for rows of 1 to MAX_F slots, else ``"rows"``."""
    return "tiles" if 1 <= F <= MAX_F else "rows"


class RowsPlan(NamedTuple):
    """How the row kernel runs rows of F slots (``rows_plan``)."""
    tile: int     # swaps a tile, one a thread
    chunk: int    # slots a stage
    chunks: int   # stages a tile (one empty stage where F = 0)
    stages: int   # stages in shared memory at once
    smem: int     # shared bytes a CTA


@functools.lru_cache(maxsize=1024)
def rows_plan(F: int, smem: int = MAX_SMEM) -> RowsPlan:
    """The row kernel's plan for rows of ``F`` slots on a card whose CTA
    may take ``smem`` bytes of shared memory: chunks of ROW_CHUNK slots,
    one stage of ROW_SMEM bytes at a time (within any card's 48 KB, so
    more CTAs an SM; a ring of two stages was slower at every width
    measured, scripts/canneal_variants.py ``ring2``).  The launch runs
    its tile, chunk and chunks as they stand."""
    if F < 0 or ROW_SMEM > smem:
        raise ValueError(f"{NAME}: no row plan for F = {F} in {smem} bytes")
    return RowsPlan(TILE, ROW_CHUNK, max(1, -(-F // ROW_CHUNK)), ROW_STAGES,
                    ROW_SMEM)


def tile_words(F: int) -> int:
    """int32 words of one of a tile CTA's two shared buffers: a tile's
    index block and up to 3 words ahead of it (its offset mod 16)."""
    return -(-(TILE * F + 3) // 4) * 4


def _lib():
    lib = _build.load("canneal")
    if not getattr(lib, "_repro_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.swap_cost_tiles_launch.argtypes = [p, p, p, p, p, p, ll, i, i,
                                               p]
        lib.swap_cost_rows_launch.argtypes = [p, p, p, p, p, p, ll, i, i, i,
                                              i, i, i, p]
        lib.swap_cost_rows_fit.argtypes = [p]
        for fn in (lib.swap_cost_tiles_launch, lib.swap_cost_rows_launch,
                   lib.swap_cost_rows_fit):
            fn.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _ctas(index: int) -> int:
    """The row kernel's CTAs that CUDA card ``index`` holds at once."""
    lib, ctas = _lib(), ctypes.c_int(0)
    with torch.cuda.device(index):
        code = lib.swap_cost_rows_fit(ctypes.byref(ctas))
    _build.check(lib, code, NAME)
    return ctas.value


def _checked(locs, fan_idx, cand_a, cand_b):
    locs, cand_a, cand_b = (_promote.widen(t, WIDENED)
                            for t in (locs, cand_a, cand_b))
    _check_args(locs, fan_idx, cand_a, cand_b)
    return locs, fan_idx, cand_a, cand_b


def _launch(kernel, locs, fan_idx, cand_a, cand_b):
    """The ``kernel`` ("tiles" or "rows") on checked CUDA tensors."""
    for name, t in (("locs", locs), ("cand_a", cand_a), ("cand_b", cand_b)):
        _check.aligned(NAME, name, t, 8)       # read as float2
    B, F = fan_idx.shape
    out_a = torch.empty(B, dtype=torch.float32, device=locs.device)
    out_b = torch.empty_like(out_a)
    if B == 0:
        return out_a, out_b
    lib = _lib()
    args = (locs.data_ptr(), fan_idx.data_ptr(), cand_a.data_ptr(),
            cand_b.data_ptr(), out_a.data_ptr(), out_b.data_ptr(), B, F,
            locs.shape[0])
    if kernel == "tiles":
        code = _device.launch(lib.swap_cost_tiles_launch, locs, *args)
    else:
        plan = rows_plan(F)
        code = _device.launch(lib.swap_cost_rows_launch, locs, *args,
                              plan.tile, plan.chunk, plan.chunks,
                              _ctas(locs.get_device()))
    _build.check(lib, code, NAME)
    if kernel == "tiles":
        swap_cost.launches += 1
    else:
        swap_cost.rows_launches += 1
    return out_a, out_b


def rows(locs, fan_idx, cand_a, cand_b):
    """The row kernel on CUDA tensors, whatever F (checked and widened as
    ``swap_cost``); counted by ``swap_cost.rows_launches``."""
    args = _checked(locs, fan_idx, cand_a, cand_b)
    if args[0].device.type != "cuda":
        raise ValueError(f"{NAME}: the row kernel takes CUDA tensors, got "
                         f"{args[0].device}")
    return _launch("rows", *args)


def swap_cost(locs, fan_idx, cand_a, cand_b):
    """``(cost_a, cost_b)``, float32 ``[B]`` each, for float32 ``locs``
    ``[N,2]``, int32 ``fan_idx`` ``[B,F]`` and float32 ``cand_a``/``cand_b``
    ``[B,2]`` (bfloat16, float16 or int32 coordinates widened to float32
    first).  CUDA tensors launch the kernel of ``route(F)``; CPU tensors
    take the plain version."""
    args = _checked(locs, fan_idx, cand_a, cand_b)
    if _check.device_kind(NAME, args[0]) == "cpu":
        return ref.canneal_swap_cost(*args)
    return _launch(route(fan_idx.shape[1]), *args)


swap_cost.launches = 0
swap_cost.rows_launches = 0

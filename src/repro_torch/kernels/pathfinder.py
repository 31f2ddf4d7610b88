"""Pathfinder (Rodinia's row-by-row dynamic program): CUDA kernels + wrapper.

Replaces ``repro/kernels/pathfinder.py:43`` (``pathfinder``, ``pallas_call``
at ``:46``): from an int32 or float32 wall ``[R, C]``, ``cost = wall[0]``,
then ``cost = wall[i] + min(cost, cost<<1, cost>>1)`` row by row, the
columns past both ends holding the Pallas kernel's 3.0e38
(``ref.PATH_END``); the result is the last cost row, float32 ``[C]``.

``pathfinder`` takes one of two routes (``csrc/pathfinder.cu``), which
``route`` picks on the host:

- ``strips``: one cooperative launch for all rows (after a memset of its
  edge words: two device operations a call, counted by
  ``pathfinder.launches``).  At most one CTA an SM (132 on an H100 SXM;
  the card's count, ``card``), each holding a strip of columns in
  registers, its warps each eight columns a lane, runs the rows in phases
  of ``h``: each warp over its share of the strip and
  ``h`` ghost columns a side, so no warp waits inside a phase.  The wall
  streams in through a ring of slabs of ``sr`` rows, loaded by one more
  warp with TMA bulk copies; between phases a CTA reads only its two
  neighbours' ``h`` edge values, each stored beside its phase's tag.
- ``pyramid``: Rodinia's ghost-zone pyramid, 256-column strips advancing
  20 rows a launch, ``ceil((R - 1) / 20)`` launches (``pyramid_launches``);
  for walls of at most ``PYRAMID_ROWS`` rows, where it measured faster,
  and walls whose strips do not fit a CTA.

Bound on an H100: bytes, the wall read once.  min is exact and each row
adds once, so both routes equal the plain version bit for bit.  A wall in
bfloat16, float16 or int16 is widened to float32 first, exactly, as the
reference widens each row (``repro/kernels/pathfinder.py:23``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch import _build
from repro_torch.kernels import _check, _promote, ref

NAME = "pathfinder"
DTYPES = (torch.int32, torch.float32)
# wall types the reference widens to float32, row by row
WIDENED = (torch.bfloat16, torch.float16, torch.int16)
# the pyramid route's rows a launch (csrc/pathfinder.cu PYRAMID)
PYRAMID = 20
# The strip route: rows a phase and CTAs (one an SM: an H100 SXM's 132,
# or the card's own count, ``card``); smaller h where the strip does not
# fit.  A warp holds 8 columns a lane, WARP_COLS = 256, and after a phase
# of h rows 256 - 2 h of them are right; a CTA has at most MAX_WARPS warps
# and a ring of SLABS slabs of sr wall rows (SR_CHOICES, the first that
# fits) and two cost rows, each of its warps' windows, in its shared memory
# (the opt-in most of a CTA: MAX_SMEM on an H100, or the card's own).
H, CTAS, H_CHOICES, SR_CHOICES = 32, 132, (32, 16, 8), (8, 4, 2)
WARP_COLS, MAX_WARPS, SLABS, MAX_SMEM = 256, 15, 4, 232_448
# The walls the pyramid takes: at most two of its launches.  Back-to-back
# calls at 100,000 columns, the pyramid against the strips: 2 / 21 / 41
# rows 0.0200 / 0.0208 / 0.0233 ms against 0.0251 / 0.0250 / 0.0257; 42 /
# 61 / 100 / 200 rows 0.0259 / 0.0261 / 0.0376 / 0.0821 against 0.0257 /
# 0.0256 / 0.0274 / 0.0466, and so at 1,000 and 10,000 columns from 61
# rows (scripts/pathfinder_variants.py, NVIDIA H100 80GB HBM3, 700 W).
# Calls this short are host-bound: in device time the pyramid stays ahead
# at 1,000 and 10,000 columns to 200 rows, by 2-4 us.
PYRAMID_ROWS = 2 * PYRAMID + 1


class Route(NamedTuple):
    """How ``pathfinder`` runs a wall (``route``)."""
    name: str        # "strips" or "pyramid"
    strip: int = 0   # columns a CTA (a multiple of 4)
    h: int = 0       # rows a phase (a multiple of 4)
    ctas: int = 0    # CTAs of the cooperative launch
    launches: int = 0   # device operations a call
    sr: int = 0      # wall rows a slab of the ring


def strip_warps(strip: int, h: int) -> int:
    """A strip CTA's row warps: their right middles, 256 - 2 h columns
    each, cover the strip (one more warp loads the wall)."""
    return -(-strip // (WARP_COLS - 2 * h))


def strip_smem(strip: int, h: int, sr: int) -> int:
    """A strip CTA's shared memory: the wall ring (SLABS slabs of ``sr``
    rows) and two cost rows, each of its row warps' windows, and the
    slabs' two mbarriers each."""
    pitch = strip_warps(strip, h) * (WARP_COLS - 2 * h) + 2 * h
    return SLABS * sr * pitch * 4 + 2 * pitch * 4 + 2 * SLABS * 8


def pyramid_launches(R: int) -> int:
    """The pyramid route's launches for ``R`` rows."""
    return max(1, -(-(R - 1) // PYRAMID))


def strips(C: int, h: int = H, ctas: int = CTAS,
           smem: int = MAX_SMEM) -> Route | None:
    """The strip route of ``C`` columns at ``h`` rows a phase over at most
    ``ctas`` CTAs of at most ``smem`` bytes of shared memory, or None where
    its CTAs would not fit: strips of ``ceil(C / ctas)`` columns rounded up
    to a multiple of 4 and at least ``h`` (a neighbour's edge is ``h``
    columns of its strip), the wall in the first of SR_CHOICES that divides
    ``h`` and fits."""
    per = -(-C // ctas)
    strip = max(h, -(-per // 4) * 4)
    if strip_warps(strip, h) > MAX_WARPS:
        return None
    for sr in SR_CHOICES:
        if h % sr == 0 and strip_smem(strip, h, sr) <= smem:
            return Route("strips", strip, h, -(-C // strip), 2, sr)
    return None


def route(R: int, C: int, sms: int = CTAS, smem: int = MAX_SMEM) -> Route:
    """The pyramid for walls of at most PYRAMID_ROWS rows, else the strip
    route on a card of ``sms`` SMs and ``smem`` bytes of shared memory a
    CTA (``card``), one CTA an SM, at the first of H_CHOICES whose strips
    fit, else the pyramid.  At Rodinia's 100,000 columns on an H100 SXM:
    132 strips of 760 columns, 32 rows a phase, 8-row slabs."""
    if R <= PYRAMID_ROWS:
        return Route("pyramid", launches=pyramid_launches(R))
    for h in H_CHOICES:
        rt = strips(C, h, sms, smem)
        if rt is not None:
            return rt
    return Route("pyramid", launches=pyramid_launches(R))


def _lib():
    lib = _build.load("pathfinder")
    if not getattr(lib, "_repro_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pathfinder_pyramid_launch.argtypes = [p, i, p, p, ll, i, p]
        lib.pathfinder_pyramid_launch.restype = ctypes.c_int
        lib.pathfinder_strips_launch.argtypes = [p, i, p, p, ll, i, i, i, i,
                                                 i, i, p]
        lib.pathfinder_strips_launch.restype = ctypes.c_int
        lib.pathfinder_strips_fit.argtypes = [i, i, i, i, p]
        lib.pathfinder_strips_fit.restype = ctypes.c_int
        lib.pathfinder_card.argtypes = [p, p]
        lib.pathfinder_card.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _checked(wall, cuda=False):
    wall = _promote.widen(wall, WIDENED)
    _check.tensor(NAME, "wall", wall, DTYPES, 2)
    if cuda and wall.device.type != "cuda":
        raise ValueError(f"{NAME}: the kernel takes a CUDA wall, got "
                         f"{wall.device}")
    R, C = wall.shape
    if R < 1:
        raise ValueError(f"{NAME}: wall needs at least one row, got shape "
                         f"{tuple(wall.shape)}")
    if C > _check.INT32_MAX - 256:
        raise ValueError(f"{NAME}: C = {C} must fit int32")
    return wall


def pyramid(wall):
    """The pyramid route on a CUDA wall (checked and widened as
    ``pathfinder``); counted by ``pathfinder.pyramid_launches``."""
    wall = _checked(wall, cuda=True)
    R, C = wall.shape
    out = torch.empty(C, dtype=torch.float32, device=wall.device)
    if C == 0:
        return out
    scratch = torch.empty_like(out)
    lib = _lib()
    with torch.cuda.device(wall.device):
        code = lib.pathfinder_pyramid_launch(
            wall.data_ptr(), int(wall.dtype == torch.int32), out.data_ptr(),
            scratch.data_ptr(), R, C, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, NAME)
    pathfinder.pyramid_launches += pyramid_launches(R)
    return out


@functools.lru_cache(maxsize=None)
def _card(index: int) -> tuple[int, int]:
    lib, sms, smem = _lib(), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        code = lib.pathfinder_card(ctypes.byref(sms), ctypes.byref(smem))
    _build.check(lib, code, NAME)
    return sms.value, smem.value


def card(device) -> tuple[int, int]:
    """The SMs of the CUDA card ``device`` and the most shared memory a
    CTA of it may opt in to, the arguments ``route`` takes."""
    device = torch.device(device)
    return _card(torch.cuda.current_device() if device.index is None
                 else device.index)


def strips_fit(rt: Route, dtype=torch.int32) -> int:
    """How many CTAs of the strip route ``rt`` the current card holds at
    once."""
    lib, n = _lib(), ctypes.c_int(0)
    code = lib.pathfinder_strips_fit(rt.strip, rt.h, rt.sr,
                                     int(dtype == torch.int32),
                                     ctypes.byref(n))
    _build.check(lib, code, NAME)
    return n.value


def strip_run(wall, rt: Route):
    """The strip route ``rt`` on a CUDA wall (checked and widened as
    ``pathfinder``); counted by ``pathfinder.launches``, two a call (the
    edges' memset and the kernel)."""
    wall = _checked(wall, cuda=True)
    R, C = wall.shape
    out = torch.empty(C, dtype=torch.float32, device=wall.device)
    if C == 0:
        return out
    if rt.name != "strips" or rt.strip % 4 or rt.h % 4 or rt.ctas < 1 \
            or rt.sr < 1 or rt.h % rt.sr or rt.strip < rt.h \
            or (rt.ctas - 1) * rt.strip >= C or rt.ctas * rt.strip < C:
        raise ValueError(f"{NAME}: {rt} does not cut {C} columns into "
                         "strips of a multiple of 4 columns, at least h each")
    # the edges: 2 slots x ctas x 2 sides x h words (a value and its tag)
    edges = torch.empty(4 * rt.ctas * rt.h, dtype=torch.int64,
                        device=wall.device)
    vec = C % 4 == 0 and wall.data_ptr() % 16 == 0
    lib = _lib()
    with torch.cuda.device(wall.device):
        code = lib.pathfinder_strips_launch(
            wall.data_ptr(), int(wall.dtype == torch.int32), out.data_ptr(),
            edges.data_ptr(), R, C, rt.strip, rt.h, rt.sr, rt.ctas, int(vec),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, NAME)
    pathfinder.launches += rt.launches
    return out


def pathfinder(wall):
    """float32 ``[C]``: the last min-cost row of ``wall`` ``[R, C]`` (int32
    or float32, R >= 1; bfloat16, float16 and int16 widened to float32).
    CUDA tensors launch the kernel of ``route(R, C, *card(device))``; CPU
    tensors take the plain version."""
    wall = _checked(wall)
    if _check.device_kind(NAME, wall) == "cpu":
        return ref.pathfinder(wall)
    rt = route(*wall.shape, *card(wall.device))
    return pyramid(wall) if rt.name == "pyramid" else strip_run(wall, rt)


pathfinder.launches = 0
pathfinder.pyramid_launches = 0

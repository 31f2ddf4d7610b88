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
- ``pyramid`` (counted by ``pathfinder.pyramid_launches``): the ghost
  zone at the scale of a warp, with no block barrier and no shared
  memory.  Each warp owns a window of 256 columns, 8 a lane, runs ``h``
  rows over it with the wall's next rows in flight in a ring of
  registers, and writes the window's middle; ``pyramid_plan`` picks
  ``h``: every wall of at most ``PYRAMID_H + 1`` rows in one launch (no
  scratch row), longer ones in ``ceil((R - 1) / PYRAMID_H)``.  It takes
  the walls of one launch, those of two (``PYRAMID_ROWS``) up to
  ``PYRAMID_COLS`` columns, where it measured faster, and the walls whose
  strips do not fit a CTA.

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

from repro_torch import _build, _device
from repro_torch.kernels import _check, _promote, ref

NAME = "pathfinder"
DTYPES = (torch.int32, torch.float32)
# wall types the reference widens to float32, row by row
WIDENED = (torch.bfloat16, torch.float16, torch.int16)
# The pyramid route: at most PYRAMID_H rows a launch, over windows of
# PYRAMID_WINDOW columns, 8 a lane (csrc/pathfinder.cu PYR_K), whose ghost
# zones are h rounded up to 4 columns a side.
PYRAMID_H, PYRAMID_WINDOW = 40, 256
# The strip route: rows a phase and CTAs (one an SM: an H100 SXM's 132,
# or the card's own count, ``card``); smaller h where the strip does not
# fit.  A warp holds 8 columns a lane, WARP_COLS = 256, and after a phase
# of h rows 256 - 2 h of them are right; a CTA has at most MAX_WARPS warps
# and a ring of SLABS slabs of sr wall rows (SR_CHOICES, the first that
# fits) and two cost rows, each of its warps' windows, in its shared memory
# (the opt-in most of a CTA: MAX_SMEM on an H100, or the card's own).
H, CTAS, H_CHOICES, SR_CHOICES = 32, 132, (32, 16, 8), (8, 4, 2)
WARP_COLS, MAX_WARPS, SLABS, MAX_SMEM = 256, 15, 4, 232_448
# The walls the pyramid takes: every wall of one launch (PYRAMID_H + 1
# rows), and the walls of two launches (PYRAMID_ROWS) up to PYRAMID_COLS
# columns, the widest the crossover was measured at.  In device time behind
# a spin at 100,000 columns, the pyramid against the strips: 2 / 21 / 41
# rows 0.0036 / 0.0053 / 0.0081 ms against 0.0060 / 0.0086 / 0.0126; 42 /
# 61 / 81 rows 0.0101 / 0.0115 / 0.0161 against 0.0128 / 0.0151 / 0.0191;
# 100 rows 0.0239 against 0.0238; 150 / 200 rows 0.0409 / 0.0536 against
# 0.0343 / 0.0435.  At 1,000 and 10,000 columns the pyramid stays ahead to
# 200 rows; at 100 x 405,504 it was behind (0.0786 against 0.0667).
# (scripts/pathfinder_variants.py, the crossover run PERF.md's row 10b
# cites; NVIDIA H100 80GB HBM3, 700 W.)  Back to back, calls this short
# are host-bound.
PYRAMID_ROWS, PYRAMID_COLS = 2 * PYRAMID_H + 1, 100_000


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


class PyramidPlan(NamedTuple):
    """How the pyramid route runs a wall (``pyramid_plan``)."""
    window: int     # columns a warp
    h: int          # rows a launch (the last may take fewer)
    ghost: int      # ghost columns a side: h rounded up to 4
    middle: int     # columns a window writes: window - 2 ghost
    windows: int    # warps a launch
    launches: int


@functools.lru_cache(maxsize=1024)
def pyramid_plan(R: int, C: int, window: int = PYRAMID_WINDOW) -> PyramidPlan:
    """The pyramid route's plan for an ``[R, C]`` wall: the fewest launches
    of at most PYRAMID_H rows (one for R <= PYRAMID_H + 1), h rows each, and
    windows of ``window`` columns whose middles tile the C columns.  The
    kernel runs this plan as it stands (its launch rejects one that does
    not fit its window)."""
    launches = max(1, -(-(R - 1) // PYRAMID_H))
    h = -(-(R - 1) // launches)
    ghost = -(-h // 4) * 4
    middle = window - 2 * ghost
    return PyramidPlan(window, h, ghost, middle, -(-C // middle), launches)


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
    """The pyramid for walls of at most PYRAMID_H + 1 rows, and of at most
    PYRAMID_ROWS rows and PYRAMID_COLS columns; else the strip route on a
    card of ``sms`` SMs and ``smem`` bytes of shared memory a CTA
    (``card``), one CTA an SM, at the first of H_CHOICES whose strips fit,
    else the pyramid.  At Rodinia's 100,000 columns on an H100 SXM: 132
    strips of 760 columns, 32 rows a phase, 8-row slabs."""
    pyr = Route("pyramid", launches=pyramid_plan(R, C).launches)
    if R <= PYRAMID_H + 1 or (R <= PYRAMID_ROWS and C <= PYRAMID_COLS):
        return pyr
    for h in H_CHOICES:
        rt = strips(C, h, sms, smem)
        if rt is not None:
            return rt
    return pyr


def _lib():
    lib = _build.load("pathfinder")
    if not getattr(lib, "_repro_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pathfinder_pyramid_launch.argtypes = [p, i, p, p, ll, i, i, i,
                                                  i, ll, i, p]
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
    ``pathfinder``), in ``pyramid_plan(R, C).launches`` launches, counted
    by ``pathfinder.pyramid_launches``; a scratch cost row only where that
    is more than one."""
    return _pyramid(_checked(wall, cuda=True))


def _pyramid(wall):
    """``pyramid`` on a checked CUDA wall."""
    R, C = wall.shape
    out = torch.empty(C, dtype=torch.float32, device=wall.device)
    if C == 0:
        return out
    plan = pyramid_plan(R, C)
    scratch = torch.empty_like(out) if plan.launches > 1 else None
    lib = _lib()
    code = _device.launch(lib.pathfinder_pyramid_launch, wall,
                          wall.data_ptr(), int(wall.dtype == torch.int32),
                          out.data_ptr(),
                          None if scratch is None else scratch.data_ptr(),
                          R, C, plan.h, plan.ghost, plan.middle, plan.windows,
                          plan.launches)
    _build.check(lib, code, NAME)
    pathfinder.pyramid_launches += plan.launches
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
    code = _device.launch(
        lib.pathfinder_strips_launch, wall, wall.data_ptr(),
        int(wall.dtype == torch.int32), out.data_ptr(), edges.data_ptr(), R,
        C, rt.strip, rt.h, rt.sr, rt.ctas, int(vec))
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
    return _pyramid(wall) if rt.name == "pyramid" else strip_run(wall, rt)


pathfinder.launches = 0
pathfinder.pyramid_launches = 0

"""Mamba-2 SSD chunk scan: CUDA kernels + wrapper.

Replaces ``repro/kernels/ssd_scan.py:56`` (``ssd_scan``, ``pallas_call`` at
``:66``): for x ``[b,S,H,P]``, dt ``[b,S,H]``, A ``[H]`` and B, C
``[b,S,N]``, the SSD scan y ``[b,S,H,P]`` (D-skip and gating stay outside).
Every input is widened to float32; y has x's type.  ``Q = min(chunk, S)``
and ``S % Q`` must be 0, as in the Pallas wrapper, which raises there too.

The CUDA kernels (``csrc/ssd_scan.cu``) run the scan chunk-parallel in three
passes over chunks of ``CHUNK`` = 512 steps, every product on the tensor
cores in 3xTF32: ``chunk_states`` (each chunk's own end state and its sum
of dt A, into a ``[b, chunks, H, P, N]`` float32 buffer allocated per
call), ``state_pass`` (in chunk order, each of those becomes the state the
chunk starts from) and ``output_pass`` (y from each chunk's start state;
the only pass where the sequence is one chunk).  Inside a chunk the
kernels walk tiles of 32 or 64 steps with the heads' states in shared
memory; a head wider than 64 is split into equal P-slices of at most 64
columns, one block each; the output pass gives a block up to four heads,
which then share C B^T and the loads of B and C.  A state too wide for
one block (N > 416 at P >= 64) is split along N into panels, one block
each: the chunk and state passes take a panel's columns as they are, the
output pass writes each panel's share of y in float32, and a fourth pass,
``panel_sum``, adds the shares in panel order into x's type (x is widened
to float32 on this route).  ``plan`` picks all of these on the host, the
panels only where one block cannot hold the state.  The result depends on
the chunking only through rounding, so the chunk and tile are the
kernels' own; the bar against the
plain version, which chunks at Q, is the reference's 4e-3.  x may be
float32, bfloat16 or float16; dt, A, B and C are widened to float32 here
before the launch, and other types of x (64-bit, integers) are converted
first by the reference's rule (``_promote``), y keeping x's type.  Any P
and any N.  Bound on an H100: operations.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import _build, _device
from repro_torch.kernels import _check, _promote, ref

NAME = "ssd_scan"
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the opt-in shared memory of one block on an H100
MAX_SMEM = 232_448
# steps a chunk (the state buffer's grain) and the widest P-slice
CHUNK, MAX_PS = 512, 64


class Plan(NamedTuple):
    """How the kernels cut one call's work (``plan``)."""
    steps: int         # a tile's steps in the output pass, 64 or 32
    width: int         # a P-slice's columns (the last may hold fewer)
    slices: int        # P-slices a head
    heads: int         # heads a block of the output pass, 1 to 4
    chunks: int        # chunks of CHUNK steps
    chunk_steps: int   # a tile's steps in the chunk pass, 64 or 32
    panel: int = 0     # an N-panel's columns (0: one panel, all of N)


def smem_bytes(T: int, PS: int, N: int, hg: int, out: bool) -> int:
    """A block's shared memory (csrc/ssd_scan.cu, Layout): the heads'
    states, B, C (output pass), x dt, W (output pass) and four vectors of
    T a head, rows padded as the kernel pads them."""
    n8, ps16 = -(-N // 8) * 8, -(-PS // 16) * 16
    floats = (hg * ps16 * (n8 + 4) + T * -(-n8 // 32) * 32
              + (T * (n8 + 4) if out else 0) + hg * T * (ps16 + 8)
              + (hg * T * (T + 4) if out else 0) + 4 * hg * T)
    return 4 * floats


# the output pass's (tile steps, heads a block), in the order the plan
# tries them: at the suite's size four heads in 32-step tiles ran 11 %
# faster than two in 64-step ones, which held the most heads 64-step tiles
# fit (scripts/ssd_scan_variants.py)
OUTPUT_SHAPES = ((32, 4), (64, 2), (64, 1), (32, 2), (32, 1))


def plan(S: int, H: int, P: int, N: int) -> Plan:
    """P-slices of at most 64 columns, as many as needed, equal but the
    last; then the first of OUTPUT_SHAPES whose block fits shared memory
    (with H or more heads), and for the chunk pass (one head a block)
    64-step tiles where they fit.  Where not even 32-step tiles of one head
    fit, the fewest N-panels (of a multiple of 8 columns, equal but the
    last) with which one of OUTPUT_SHAPES does."""
    slices = -(-P // MAX_PS)
    width = -(-P // slices)
    for panels in range(1, -(-N // 8) + 1):
        nw = N if panels == 1 else (-(-N // panels) + 7) // 8 * 8
        if panels > 1 and -(-N // nw) != panels:
            continue       # the same panel width as fewer panels
        for T, hg in OUTPUT_SHAPES:
            if hg <= H and smem_bytes(T, width, nw, hg, True) <= MAX_SMEM:
                chunk_T = 64 if smem_bytes(64, width, nw, 1, False) \
                    <= MAX_SMEM else 32
                return Plan(T, width, slices, hg, -(-S // CHUNK), chunk_T,
                            0 if panels == 1 else nw)
    raise ValueError(f"{NAME}: P = {P}, N = {N}: no block fits "
                     f"{MAX_SMEM} bytes of shared memory")


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
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_chunk_states_launch.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                                i, i, i, i, i, p]
        lib.ssd_state_pass_launch.argtypes = [p, p, i, i, i, ll, p]
        lib.ssd_output_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                          i, i, i, i, i, ll, p]
        lib.ssd_panel_sum_launch.argtypes = [p, p, i, ll, i, p]
        for fn in (lib.ssd_chunk_states_launch, lib.ssd_state_pass_launch,
                   lib.ssd_output_launch, lib.ssd_panel_sum_launch):
            fn.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [i, i, i, i, i]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
        lib._repro_typed = True
    return lib


def chunk_states(x, dt, A, B, pl: Plan):
    """Pass (a) on checked CUDA operands (x float32 where ``pl`` has
    N-panels): each chunk's end state from zero ``[b, chunks, H, P, N]``
    and its sum of dt A ``[b, chunks, H]``, both float32; counted by
    ``ssd_scan.chunk_launches``."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    Z = torch.empty((b, pl.chunks, H, P, N), dtype=torch.float32,
                    device=x.device)
    seg = torch.empty((b, pl.chunks, H), dtype=torch.float32,
                      device=x.device)
    lib = _lib()
    code = _device.launch(lib.ssd_chunk_states_launch, x, x.data_ptr(),
                          dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                          Z.data_ptr(), seg.data_ptr(), b, S, H, P, N,
                          X_DTYPES[x.dtype], pl.chunk_steps, pl.width,
                          pl.panel or N)
    _build.check(lib, code, NAME)
    ssd_scan.chunk_launches += 1
    return Z, seg


def state_pass(Z, seg):
    """Pass (b), in place: each chunk's end state in ``Z`` becomes the state
    the chunk starts from; counted by ``ssd_scan.state_launches``."""
    b, nc, H, P, N = Z.shape
    lib = _lib()
    code = _device.launch(lib.ssd_state_pass_launch, Z, Z.data_ptr(),
                          seg.data_ptr(), b, nc, H, P * N)
    _build.check(lib, code, NAME)
    ssd_scan.state_launches += 1
    return Z


def output_pass(x, dt, A, B, C, Z, pl: Plan):
    """Pass (c): y in x's type from the chunks' start states ``Z`` (None:
    one chunk, from zero); where ``pl`` has N-panels, each panel's share of
    y, ``[panels, b, S, H, P]`` float32 (x float32).  Counted by
    ``ssd_scan.launches``."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    panels = -(-N // (pl.panel or N))
    out = torch.empty((panels, *x.shape), dtype=x.dtype, device=x.device)
    lib = _lib()
    code = _device.launch(lib.ssd_output_launch, x, x.data_ptr(),
                          dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                          C.data_ptr(), None if Z is None else Z.data_ptr(),
                          out.data_ptr(), b, S, H, P, N, X_DTYPES[x.dtype],
                          pl.steps, pl.width, pl.heads, pl.panel or N,
                          x.numel() if panels > 1 else 0)
    _build.check(lib, code, NAME)
    ssd_scan.launches += 1
    return out if panels > 1 else out[0]


def panel_sum(part, dtype):
    """Pass (d): the panels' float32 shares ``[panels, ...]`` added in panel
    order, into ``dtype`` (a type of ``X_DTYPES``); counted by
    ``ssd_scan.panel_launches``."""
    out = torch.empty(part.shape[1:], dtype=dtype, device=part.device)
    lib = _lib()
    code = _device.launch(lib.ssd_panel_sum_launch, part, part.data_ptr(),
                          out.data_ptr(), part.shape[0], out.numel(),
                          X_DTYPES[dtype])
    _build.check(lib, code, NAME)
    ssd_scan.panel_launches += 1
    return out


def ssd_scan(x, dt, A, B, C, chunk: int = 256):
    """y ``[b,S,H,P]`` in x's type.  CUDA tensors launch the kernels; CPU
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
    pl = plan(S, H, P, N)
    if x.numel() == 0:
        return _promote.restore(torch.empty_like(x), out_dtype)
    xk = x.to(torch.float32) if pl.panel else x
    Z = None
    if pl.chunks > 1:
        Z, seg = chunk_states(xk, dt, A, B, pl)
        state_pass(Z, seg)
    y = output_pass(xk, dt, A, B, C, Z, pl)
    if pl.panel:
        y = panel_sum(y, x.dtype)
    return _promote.restore(y, out_dtype)


ssd_scan.launches = 0
ssd_scan.chunk_launches = 0
ssd_scan.state_launches = 0
ssd_scan.panel_launches = 0

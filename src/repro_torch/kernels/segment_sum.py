"""Segment sums in a fixed order: CUDA kernel + wrapper.

The embedding table's gradient (``models/layers.py:embed_fwd``'s
backward): ``out[r]`` is the sum of the rows of ``rows`` whose index is
``r``, added in position order in float32 and rounded once to
``out_dtype``.  It replaces no Pallas kernel: the reference takes this
gradient by autodiff of its gather, a scatter-add, and on the card a
scatter-add (``index_add_``, ``index_put_`` with accumulate) adds by atomics
in an order that changes from run to run.  The wrapper zero-fills
``out``, sorts the indices with a stable sort (each row's positions stay in
position order) and finds where each run of equal indices ends with
``searchsorted``; the kernel (``csrc/segment_sum.cu``) writes each row an
index points at once, from the block of its run's first position.  The
same inputs give the same bits on every run.

Bound on an H100: bytes, ``rows`` read once and ``out`` written once.  On
CPU tensors the plain version (``segment_sum_plain``) runs: CPU
``index_add_`` adds in position order, the kernel's order; on meta tensors
too (the dry run counts shapes).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build, _device
from repro_torch.kernels import _check

NAME = "segment_sum"
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _lib():
    lib = _build.load(NAME)
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.segment_sum_launch.argtypes = [p, i, p, p, p, p, i,
                                           ctypes.c_longlong, i, p]
        lib.segment_sum_launch.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _check_args(rows, index, n_rows, out_dtype):
    _check.tensor(NAME, "rows", rows, DTYPES, 2)
    _check.tensor(NAME, "index", index, (torch.int32, torch.int64), 1,
                  rows.device)
    if index.shape[0] != rows.shape[0]:
        raise ValueError(f"{NAME}: index of {index.shape[0]} entries for "
                         f"{rows.shape[0]} rows")
    if out_dtype not in DTYPES:
        raise ValueError(f"{NAME}: out_dtype must be float32, bfloat16 or "
                         f"float16, got {out_dtype}")
    if not 0 <= n_rows <= _check.INT32_MAX or \
            max(rows.shape) > _check.INT32_MAX:
        raise ValueError(f"{NAME}: {n_rows} output rows and rows "
                         f"{tuple(rows.shape)} must fit int32")


def segment_sum_plain(rows, index, n_rows, out_dtype):
    """The plain version: ``index_add_`` into float32 zeros, rounded to
    ``out_dtype``.  On the CPU it adds in position order, as the kernel
    does; on the card by atomics, in some order."""
    out = torch.zeros(n_rows, rows.shape[1], dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(0, index, rows.float()).to(out_dtype)


def segment_sum(rows, index, n_rows: int, out_dtype=None):
    """``[n_rows, D]`` sums of ``rows`` [N, D] by ``index`` [N] (each in
    ``[0, n_rows)``), in position order in float32, in ``out_dtype``
    (default ``rows``' type).  CUDA tensors launch the kernel, counted by
    ``segment_sum.launches``; CPU tensors take the plain version."""
    out_dtype = rows.dtype if out_dtype is None else out_dtype
    _check_args(rows, index, n_rows, out_dtype)
    # meta tensors (the dry run's shapes, where nothing runs) take it too
    if rows.is_meta or (not rows.is_cuda
                        and _check.device_kind(NAME, rows) == "cpu"):
        return segment_sum_plain(rows, index, n_rows, out_dtype)
    N, D = rows.shape
    out = torch.zeros(n_rows, D, dtype=out_dtype, device=rows.device)
    if out.numel() == 0 or N == 0:
        return out
    keys, order = torch.sort(index.long(), stable=True)
    ends = torch.searchsorted(keys, keys, right=True)
    lib = _lib()
    code = _device.launch(lib.segment_sum_launch, rows, rows.data_ptr(),
                          DTYPES[rows.dtype], order.data_ptr(),
                          keys.data_ptr(), ends.data_ptr(), out.data_ptr(),
                          DTYPES[out_dtype], N, D)
    _build.check(lib, code, NAME)
    segment_sum.launches += 1
    return out


segment_sum.launches = 0

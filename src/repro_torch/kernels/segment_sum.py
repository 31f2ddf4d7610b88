"""Segment sums in a fixed order: CUDA kernel + wrapper.

The embedding table's gradient (``models/layers.py:embed_fwd``'s
backward): ``out[r]`` is the sum of the rows of ``rows`` whose index is
``r``, added in float32 in a fixed order and rounded once to
``out_dtype``.  It replaces no Pallas kernel: the reference takes this
gradient by autodiff of its gather, a scatter-add, and on the card a
scatter-add (``index_add_``, ``index_put_`` with accumulate) adds by atomics
in an order that changes from run to run.  The wrapper sorts the indices
as int32 keys with a stable sort (each key's positions stay in position
order); the kernel (``csrc/segment_sum.cu``) writes every row of the table
once, so there is no zero fill: zeros where no index points, else the
row's sum.  The order is two-level: a row of at most ``CHUNK`` positions
adds them in position order, the order of adding them one by one; a longer
row (a Zipf batch's hot token) is cut into chunks of ``CHUNK`` positions,
each summed in position order by its own block, and the chunk sums are
added in chunk order.  ``segment_sum_chunked`` spells that order out in
plain torch (tests hold the kernel to it bit for bit).  The same inputs
give the same bits on every run.

Bound on an H100: bytes, ``rows`` read once and ``out`` written once.  On
CPU tensors the plain version (``segment_sum_plain``) runs: CPU
``index_add_`` adds in position order, the kernel's order on rows of at
most ``CHUNK`` positions; on meta tensors too (the dry run counts shapes).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build, _device
from repro_torch.kernels import _check

NAME = "segment_sum"
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
CHUNK = 64           # positions a chunk of a longer row (the kernel's C)


def _lib():
    lib = _build.load(NAME)
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.c_longlong
        lib.segment_sum_launch.argtypes = [p, i, p, p, p, p, i, ll, i, ll,
                                           i, p]
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
    does on rows of at most ``CHUNK`` positions; on the card by atomics, in
    some order."""
    out = torch.zeros(n_rows, rows.shape[1], dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(0, index, rows.float()).to(out_dtype)


def segment_sum_chunked(rows, index, n_rows, out_dtype, chunk=CHUNK):
    """The kernel's order in plain torch, for tests: a row of at most
    ``chunk`` positions sums them in position order from 0.0; a longer row
    sums each chunk of ``chunk`` positions (from the row's first) in
    position order from 0.0, then the chunk sums in chunk order from 0.0;
    float32, rounded once to ``out_dtype``.  Only elementwise adds, so the
    same bits on any device."""
    N, D = rows.shape
    dev = rows.device
    out = torch.zeros(n_rows, D, dtype=torch.float32, device=dev)
    if N == 0:
        return out.to(out_dtype)
    keys, order = torch.sort(index.long(), stable=True)
    x = rows.float()[order]
    counts = torch.bincount(keys, minlength=n_rows)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N, device=dev) - starts[keys]
    # a chunk starts at each row's first position and every `chunk`
    # positions of a row longer than `chunk`
    new = (rank == 0) | ((counts[keys] > chunk) & (rank % chunk == 0))
    first = torch.nonzero(new).squeeze(1)
    length = torch.diff(first, append=first.new_tensor([N]))
    sums = torch.zeros(first.numel(), D, dtype=torch.float32, device=dev)
    for k in range(int(length.max())):
        sel = length > k
        sums[sel] = sums[sel] + x[first[sel] + k]
    # each row's chunks are consecutive: its first chunk and their count
    row = keys[first]
    head = torch.nonzero(rank[first] == 0).squeeze(1)
    n_chunks = torch.diff(head, append=head.new_tensor([first.numel()]))
    for k in range(int(n_chunks.max())):
        sel = n_chunks > k
        out[row[head[sel]]] = out[row[head[sel]]] + sums[head[sel] + k]
    return out.to(out_dtype)


def segment_sum(rows, index, n_rows: int, out_dtype=None):
    """``[n_rows, D]`` sums of ``rows`` [N, D] by ``index`` [N] (each in
    ``[0, n_rows)``), in float32 in the two-level order above, in
    ``out_dtype`` (default ``rows``' type).  CUDA tensors launch the kernel
    (a sort and two launches, counted once by ``segment_sum.launches``);
    CPU tensors take the plain version."""
    out_dtype = rows.dtype if out_dtype is None else out_dtype
    _check_args(rows, index, n_rows, out_dtype)
    # meta tensors (the dry run's shapes, where nothing runs) take it too
    if rows.is_meta or (not rows.is_cuda
                        and _check.device_kind(NAME, rows) == "cpu"):
        return segment_sum_plain(rows, index, n_rows, out_dtype)
    N, D = rows.shape
    if n_rows * D == 0 or N == 0:
        return torch.zeros(n_rows, D, dtype=out_dtype, device=rows.device)
    keys, order = torch.sort(index.to(torch.int32), stable=True)
    partial = torch.empty(2 * -(-N // CHUNK) * D, dtype=torch.float32,
                          device=rows.device)
    out = torch.empty(n_rows, D, dtype=out_dtype, device=rows.device)
    lib = _lib()
    code = _device.launch(lib.segment_sum_launch, rows, rows.data_ptr(),
                          DTYPES[rows.dtype], order.data_ptr(),
                          keys.data_ptr(), partial.data_ptr(),
                          out.data_ptr(), DTYPES[out_dtype], N, D, n_rows,
                          CHUNK)
    _build.check(lib, code, NAME)
    segment_sum.launches += 1
    return out


segment_sum.launches = 0

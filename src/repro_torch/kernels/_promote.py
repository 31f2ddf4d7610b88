"""The reference's operand types, applied by each wrapper before its launch.

The reference runs JAX with 64-bit types off and its Pallas kernels widen
every operand to float32 inside the kernel (``repro/kernels/
flash_attention.py:32-34``, ``decode_attention.py:28-30``,
``streamcluster.py:19-20``, ``ssd_scan.py:25-29``), so it computes operands
the port's kernels do not take as they are.  The port follows it in front
of the kernel, on the CPU and the card alike:

- a 64-bit tensor is narrowed (float64 to float32, int64 to int32), as
  ``ops`` narrows a numpy array and as JAX makes either;
- operands that do not share one type the kernel takes (mixed types, or
  integers) are each widened to float32, exactly for the 16-bit floats and
  as ``astype(float32)`` converts an integer, and the float32 kernel runs;
- the result is cast to the reference's output type, an integer type by
  truncation toward zero, as ``.astype(o_ref.dtype)`` does.

The kernels that take float32 (or int32) alone widen the reference's
other operand types the same way (``widen``): the 16-bit floats, and
int32 or int16 where the reference converts them to float32 itself; the
result is cast back to the reference's output type.

This is a conversion in front of the kernel, not a fallback: the kernel
launches (and counts its launch) on the widened operands.
"""
from __future__ import annotations

import torch

# the 16-bit floats, which widen to float32 exactly
HALF = (torch.bfloat16, torch.float16)
# what JAX with 64-bit types off makes of a 64-bit array
NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def narrow(t):
    """``t`` with a 64-bit type narrowed; anything else as it is."""
    if isinstance(t, torch.Tensor) and t.dtype in NARROW:
        return t.to(NARROW[t.dtype])
    return t


def promote(ts, dtypes):
    """``(operands, out_dtype)``: ``ts`` narrowed, kept where they share
    one type of ``dtypes`` and else each widened to float32; ``out_dtype``
    is the first operand's narrowed type (the reference's output type where
    it follows that operand).  Anything but real tensors is left for the
    wrapper's checks to name."""
    ts = [narrow(t) for t in ts]
    if not all(isinstance(t, torch.Tensor) and not t.is_complex()
               for t in ts):
        return ts, None
    out = ts[0].dtype
    if len({t.dtype for t in ts}) == 1 and out in dtypes:
        return ts, out
    return [t.to(torch.float32) for t in ts], out


def restore(out: torch.Tensor, dtype) -> torch.Tensor:
    """The kernel's result in the reference's output type (float to an
    integer type truncates toward zero)."""
    return out if dtype is None or out.dtype == dtype else out.to(dtype)


def widen(t, types=HALF):
    """``t`` converted to float32 where its type is one of ``types``
    (exactly for the 16-bit types; an int32 past 2^24 rounds to nearest,
    as the reference's ``astype(float32)``); anything else as it is, for
    the wrapper's checks to judge."""
    if isinstance(t, torch.Tensor) and t.dtype in types:
        return t.to(torch.float32)
    return t

"""int8 error-feedback gradient compression.

The port of ``repro/distributed/compression.py``: a per-tensor symmetric
int8 quantization (bf16 / f32 -> int8 with a float32 scale) and its
inverse, with optional error feedback (the residual carried to the next
step keeps SGD convergence, 1-bit Adam lineage).  ``compress_decompress``
is the quantize / dequantize the train step applies when
``compress_grads=True``.  ``torch.round`` rounds half to even as
``jnp.round`` does, so on float32 input the results equal the reference's
bit for bit.  Trees are nested dicts of tensors.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import tree_map


def quantize(x):
    """x -> (int8 q, float32 scale); per-tensor symmetric."""
    x32 = x.to(torch.float32)
    amax = torch.max(torch.abs(x32))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale, dtype=torch.float32):
    return (q.to(torch.float32) * scale).to(dtype)


def compress_decompress(grads, residuals=None):
    """Quantize / dequantize every leaf (optionally with error feedback).

    Returns the new grads, and with ``residuals`` the pair (grads,
    residuals)."""
    if residuals is None:
        def f(g):
            q, s = quantize(g)
            return dequantize(q, s, g.dtype)
        return tree_map(f, grads)

    def f(g, r):
        gc = g.to(torch.float32) + r
        q, s = quantize(gc)
        deq = dequantize(q, s)
        return deq.to(g.dtype), gc - deq

    out = tree_map(f, grads, residuals)
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)

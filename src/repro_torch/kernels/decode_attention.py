"""Flash decoding (one query token against a KV cache): CUDA kernel +
wrapper.

Replaces ``repro/kernels/decode_attention.py:51`` (``decode_attention``,
``pallas_call`` at ``:57``): for q ``[B,H,D]`` and a cache k, v
``[B,S,H,D]``, softmax attention over the keys ``ki < kv_len[b]``, masked
with the Pallas kernel's finite -1e30.  At ``kv_len <= 0`` the result is
therefore the mean of V over all S positions, as the Pallas kernel gives it
(``repro/kernels/ref.py`` gives NaN there; the port follows the kernel).
q and the cache are each float32, bfloat16 or float16, computed in float32
and returned in q's type, as the Pallas kernel widens them; other operand
types (64-bit, integers, k and v of two types) are converted first by the
reference's rule (``_promote``).

The CUDA kernel (``csrc/decode_attention.cu``) is split-KV: each batch
entry's keys are cut into splits of ``len`` positions, one 256-thread block
per (split, b, head group) reads the split's rows of all its heads as one
contiguous run (16-byte loads where D and the cache's alignment allow) and
writes a partial softmax (m, l, acc) to a float32 workspace; a second
kernel merges each (b, h)'s splits in split order, so the result has the
same bits every call.  ``plan`` picks the split from S, B, the head groups
and the SM count, so that the grid fills the card at any shape; the wrapper
never reads ``kv_len`` on the host.  Any S and D (heads past 512 columns
are cut into pieces).  Bound on an H100: bytes, the cache rows the lengths
need, read once.  Each call launches both kernels (``split``, counted by
``decode_attention.launches``, and ``combine``, counted by
``decode_attention.combine_launches``); ``split_plain`` and
``combine_plain`` are their plain versions.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch import _build
from repro_torch.kernels import _check, _promote, ref

NAME = "decode_attention"
# the C entry point's code for each type of q and of the cache
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
THREADS = 256       # a split block's threads
MAX_E = 16          # columns of a head a thread holds
# splits of every batch entry and head group at full length make this many
# blocks a wave of the card's SMs (under uniform lengths half of them run),
# by the cache's element bytes: at the app's shape a 16-bit cache took
# 0.0625 ms at 4 (256-key splits) against 0.0719 at 8 and 0.0733 at 2, a
# float32 one 0.1072 at 2 (512-key splits) against 0.1189 at 4 and 0.1181
# at 8 (scripts/wide_attention_and_decode_variants.py, whole calls behind a
# spin; NVIDIA H100 80GB HBM3, 700.00 W)
WAVES = {2: 4, 4: 2}


def _pow2(n: int) -> int:
    """The least power of two >= n (n >= 1)."""
    return 1 << (n - 1).bit_length()


def _unroll(e: int) -> int:
    """Keys a thread loads at once when it holds ``e`` columns of a head
    (the kernel's UNROLL)."""
    return 8 if e <= 4 else 4 if e <= 8 else 2


@dataclass(frozen=True)
class Plan:
    """How the kernel cuts the work: ``len`` keys a split, ``ns`` splits a
    batch entry; ``vec`` cache elements a load, ``nv`` loads a head a
    thread, ``tph`` threads a head, ``hg`` heads a block (one contiguous
    run of ``hg * D`` values a key position), ``pieces`` column pieces of
    ``tph * nv * vec`` (D past 512)."""
    len: int
    ns: int
    vec: int
    nv: int
    tph: int
    hg: int
    pieces: int


@functools.lru_cache(maxsize=1024)
def plan(B, S, H, D, kv_size, aligned16, sms) -> Plan:
    """The kernel's plan for a ``[B,S,H,D]`` cache of ``kv_size``-byte
    elements (``aligned16``: both k and v 16-byte aligned) on a card of
    ``sms`` SMs."""
    v16 = 16 // kv_size
    vec = v16 if D % v16 == 0 and aligned16 else 1
    nvec = D // vec
    tph = min(32, _pow2(nvec))
    per = -(-nvec // tph)
    if per * vec <= MAX_E:
        nv, pieces = _pow2(per), 1
    else:                  # D > 512: pieces of 32 x 16 columns
        nv, pieces = MAX_E // vec, -(-D // (32 * MAX_E))
    hg = min(_pow2(H), THREADS // tph)
    groups = -(-H // hg)
    step = THREADS // (tph * hg) * _unroll(nv * vec)
    target = _pow2(-(-S * B * groups * pieces // (WAVES[kv_size] * sms)))
    length = max(step, min(max(target, 64), _pow2(S)))
    return Plan(length, -(-S // length), vec, nv, tph, hg, pieces)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_args(q, k, v, lens):
    _check.tensor(NAME, "q", q, DTYPES, 3)
    _check.tensor(NAME, "k", k, DTYPES, 4, q.device)
    _check.tensor(NAME, "v", v, (k.dtype,), 4, q.device)
    _check.tensor(NAME, "kv_len", lens, (torch.int32,), 1, q.device)
    B, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"{NAME}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be [B, S, H, D] for q "
                         f"{tuple(q.shape)}")
    if lens.shape[0] != B:
        raise ValueError(f"{NAME}: kv_len has {lens.shape[0]} entries for "
                         f"B = {B}")
    if D < 1:
        raise ValueError(f"{NAME}: head dim D = {D} must be >= 1")
    if k.shape[1] < 1 or k.shape[1] > _check.INT32_MAX - 4096 \
            or B * H > _check.INT32_MAX:
        raise ValueError(f"{NAME}: S = {k.shape[1]} must be in 1..2^31 and "
                         "B*H must fit int32")


def _lib():
    lib = _build.load("decode_attention")
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_split_launch.argtypes = [
            p, p, p, p, p, i, i, i, i, ctypes.c_float, i, i, i, i, i, i, i,
            i, i, p]
        lib.decode_attention_split_launch.restype = ctypes.c_int
        lib.decode_attention_combine_launch.argtypes = [
            p, p, p, i, i, i, i, i, i, i, p]
        lib.decode_attention_combine_launch.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def plan_for(q, k, v) -> Plan:
    """The plan of the kernels for these (checked, CUDA) operands."""
    B, S, H, D = k.shape
    return plan(B, S, H, D, k.element_size(),
                k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
                _sm_count(q.device.index if q.device.index is not None
                          else torch.cuda.current_device()))


def _split(lib, q, k, v, kv_len, pl: Plan, stream) -> torch.Tensor:
    B, S, H, D = k.shape
    ws = torch.empty(B * pl.ns * H * (D + 2), dtype=torch.float32,
                     device=q.device)
    code = lib.decode_attention_split_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        ws.data_ptr(), B, S, H, D, D ** -0.5, DTYPES[q.dtype],
        DTYPES[k.dtype], pl.len, pl.ns, pl.vec, pl.nv, pl.tph, pl.hg,
        pl.pieces, stream)
    _build.check(lib, code, NAME)
    decode_attention.launches += 1
    return ws


def _combine(lib, ws, kv_len, pl: Plan, S: int, out, stream):
    B, H, D = out.shape
    code = lib.decode_attention_combine_launch(
        ws.data_ptr(), kv_len.data_ptr(), out.data_ptr(), B, S, H, D,
        pl.len, pl.ns, DTYPES[out.dtype], stream)
    _build.check(lib, code, NAME)
    decode_attention.combine_launches += 1
    return out


def split(q, k, v, kv_len, pl: Plan) -> torch.Tensor:
    """Launch the split kernel: the float32 workspace of every split's
    partial softmax, ``[B * ns * H * 2]`` (m, l) then ``[B * ns * H * D]``
    (the unnormalised sums)."""
    with torch.cuda.device(q.device):
        return _split(_lib(), q, k, v, kv_len, pl,
                      torch.cuda.current_stream().cuda_stream)


def combine(ws, kv_len, pl: Plan, S: int, out) -> torch.Tensor:
    """Launch the combine kernel: merge the splits of ``ws`` (a cache of S
    positions) into ``out`` ``[B,H,D]`` (of a type of ``DTYPES``) in split
    order."""
    with torch.cuda.device(out.device):
        return _combine(_lib(), ws, kv_len, pl, S, out,
                        torch.cuda.current_stream().cuda_stream)


def split_plain(q, k, v, kv_len, pl: Plan) -> torch.Tensor:
    """The split kernel's plain version: the same workspace, each split's
    (m, l) and sums in PyTorch (a split at or past kv_len the neutral
    (-1e30, 0) and sums 0)."""
    B, S, H, D = k.shape
    pad = pl.ns * pl.len - S
    kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
              .view(B, pl.ns, pl.len, H, D) for t in (k, v))
    pos = torch.arange(pl.ns * pl.len, device=k.device).view(pl.ns, pl.len)
    n = torch.where(kv_len <= 0, S, kv_len.clamp(max=S))
    keep = (pos[None] < n[:, None, None])[:, :, None, :]    # [B, ns, 1, len]
    masked = (kv_len <= 0)[:, None, None, None]
    with ref._full_float32_matmul():
        sc = torch.einsum("bhd,bnkhd->bnhk", q.float(), kf) * D ** -0.5
        sc = torch.where(keep, torch.where(masked, ref.NEG_INF, sc),
                         float("-inf"))
        m = sc.max(-1).values                                 # [B, ns, H]
        neutral = (pos[:, 0][None] >= n[:, None])[..., None]  # [B, ns, 1]
        m = torch.where(neutral, ref.NEG_INF, m)
        p = torch.where(keep, torch.exp(sc - m[..., None]), 0.0)
        acc = torch.einsum("bnhk,bnkhd->bnhd", p, vf)
    l = torch.where(neutral, 0.0, p.sum(-1))
    return torch.cat([torch.stack([m, l], -1).flatten(), acc.flatten()])


def combine_plain(ws, kv_len, pl: Plan, S: int, out_shape, dtype):
    """The combine's plain version: the same merge of the workspace's
    splits below each ``kv_len``, in PyTorch."""
    B, H, D = out_shape
    n_ml = B * pl.ns * H * 2
    ml = ws[:n_ml].view(B, pl.ns, H, 2)
    acc = ws[n_ml:].view(B, pl.ns, H, D)
    n = torch.where(kv_len <= 0, S, kv_len.clamp(max=S))
    valid = (torch.arange(pl.ns, device=ws.device)[None] * pl.len
             < n[:, None])[:, :, None]                          # [B, ns, 1]
    m = torch.where(valid, ml[..., 0], float("-inf"))
    w = torch.exp(m - m.max(1, keepdim=True).values)            # 0 past n
    L = torch.where(valid, ml[..., 1] * w, 0.0).sum(1)
    a = torch.where(valid[..., None], acc * w[..., None], 0.0).sum(1)
    return (a / L.clamp_min(1e-30)[..., None]).to(dtype)


def decode_attention(q, k, v, kv_len):
    """``[B,H,D]`` in q's type; ``kv_len`` is int32 ``[B]``.  CUDA tensors
    launch the kernels; CPU tensors take the plain version."""
    (q,), out_dtype = _promote.promote((q,), DTYPES)
    (k, v), _ = _promote.promote((k, v), DTYPES)
    _check_args(q, k, v, kv_len)
    if _check.device_kind(NAME, q) == "cpu":
        return _promote.restore(ref.decode_attention(q, k, v, kv_len),
                                out_dtype)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return _promote.restore(out, out_dtype)
    pl, lib = plan_for(q, k, v), _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _combine(lib, _split(lib, q, k, v, kv_len, pl, stream), kv_len, pl,
                 k.shape[1], out, stream)
    return _promote.restore(out, out_dtype)


decode_attention.launches = 0
decode_attention.combine_launches = 0

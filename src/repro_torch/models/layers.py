"""Shared model components: param-def framework, norms, RoPE, attention, MLP.

The port of ``repro/models/layers.py``.  Parameters are declared as
``PD(shape, logical, init)`` leaves in nested dicts; ``init_params``
materializes them from a ``torch.Generator``, ``param_structs`` gives meta
tensors, ``param_logical`` the logical-axis tree.  Every function keeps the
reference's data flow and rounding order (float32 norms rounded to the
input's type, RoPE tables in the compute type, scores masked with -1e30,
probabilities rounded to q's type before the product with V).

Attention routes by device, decided from the operands before the call:

- self-attention of the full sequence (``attention_fwd`` without ``kv``,
  causal or the encoder's non-causal) runs the port's flash-attention
  kernel (``ops.flash_attention``) on CUDA tensors, after ``_repeat_kv``
  as the reference repeats (the kernel has no GQA); on CPU tensors the
  plain ``_exact_attn`` up to ``EXACT_ATTN_MAX_SEQ`` and ``_chunked_attn``
  past it, the reference's split (``layers.py:216``).  While autograd
  records, the CUDA route goes through ``FlashAttention``: the kernel
  forward with its row log-sum-exp, and for the backward the port's
  backward kernel at D <= 128 (the reference differentiates the plain
  formula; it has no backward kernel), the vector-Jacobian product of that
  plain split, recomputed, past it;
- the cached self-attention of a decode step (``attention_decode``) runs
  the port's flash-decoding kernel (``ops.decode_attention``) on CUDA
  tensors and the plain ``_exact_attn`` with ``kv_len`` on CPU tensors;
- cross-attention (``attention_fwd`` with ``kv``, Sq != Sk, which the flash
  kernel refuses as the Pallas one does) is plain torch on every device
  (``_exact_attn`` / ``_chunked_attn``, the plain cross-attention route).

The embedding's gradient is summed in float32 while autograd records
(``embed_fwd``), where the reference's bfloat16 scatter rounds after every
add; in float32 the two are the same.  It is a sorted segment sum, each
token's positions in position order (``EmbedGather``), so a step's
gradient is the same bits on every run on the card.

Remat (``run_layer``): where the reference wraps a layer body in
``jax.checkpoint`` under ``cfg.remat``, the port calls it through
``torch.utils.checkpoint`` (non-reentrant) while autograd records, and
directly otherwise; the values are the same either way.  A training
forward takes its stacked layers apart with ``unstacked`` (one ``unbind``
a leaf, so the backward stacks each leaf's gradients once).

Under a mesh (``distributed.sharding.use_mesh``) a layer computes on this
rank's local tensors: ``fsdp_gather`` gathers a layer's weights from their
shards (its backward reduce-scatters their gradients), ``constraint``
redistributes a DTensor and leaves a local activation in the step's layout,
and ``attention_decode`` takes the flash decode over a sequence-sharded
cache (``distributed.collectives``) where the reference does.  Under a
step's tensor parallelism (``sharding.active_tp``) the weights keep their
"model" shards and each product is this rank's part, as GSPMD partitions
the reference's: the q / k / v projections column-parallel (``_project_q``,
``project_kv``; columns that are not whole heads are all-gathered),
attention on this rank's q heads (``_repeat_kv`` picks each one's kv head
of whole K/V), wo row-parallel (``_out_proj``), the MLP's w1 / w3 column-
and w2 row-parallel, a vocab-parallel lookup (``embed_fwd``),
vocab-sharded logits (``unembed_fwd``) and a vocab-parallel cross-entropy
(``cross_entropy``).  Where the residual is whole on every model rank (a
serve step) each row-parallel product ends in
``collectives.row_parallel_sum``.  Under a train step's sequence
parallelism (``TensorParallel.seq``) the residual is this rank's slice of
the sequence: norms run on the slice, ``gather_seq`` all-gathers a normed
input on the sequence before the column-parallel products (attention runs
on the whole sequence of this rank's heads), a row-parallel product ends
in a reduce-scatter onto the sequence (``to_residual``), and a product
left whole (its dim does not divide the model axis) keeps this rank's
slice of its output.  Without a mesh, or with one rank on "model", all of
this is as before: identities and the one-device code.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.utils.checkpoint

from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import constraint
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops
from repro_torch.kernels.segment_sum import segment_sum


class PD(NamedTuple):
    shape: tuple
    logical: tuple
    init: str = "normal"     # normal | zeros | ones
    scale: Optional[float] = None  # stddev override (default: fan-in)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (and over the same paths of
    ``rest``), keys in sorted order, as ``jax.tree.map`` walks a dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts in ``jax.tree.leaves``' order (sorted
    keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def recording(*trees) -> bool:
    """Whether autograd records an operation on any leaf of ``trees``."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for tree in trees for t in tree_leaves(tree))


def run_layer(body, remat: bool, *args):
    """``body(*args)``, through ``torch.utils.checkpoint`` when ``remat``
    is set and autograd records on ``args`` (its activations recomputed in
    the backward, as ``jax.checkpoint`` does)."""
    if remat and recording(*args):
        return torch.utils.checkpoint.checkpoint(
            body, *args, use_reentrant=False, preserve_rng_state=False)
    return body(*args)


def unstacked(tree) -> list:
    """The per-layer trees of a stacked tree (its leading axis), by one
    ``unbind`` a leaf."""
    parts = tree_map(torch.unbind, tree)     # leaves: tuples of tensors
    n = len(tree_leaves(parts)[0])
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def init_params(defs, generator: torch.Generator, dtype: torch.dtype):
    """Materialize ``defs`` on the generator's device: zeros, ones, or a
    normal draw times the leaf's ``scale`` (default: ``shape[-2] ** -0.5``,
    the fan-in, also for stacked leaves, as the reference takes it) in
    float32, rounded to ``dtype``.  Leaves are drawn in the reference's
    order; the draws are torch's, not JAX's bits."""
    dev = generator.device

    def one(pd: PD):
        if pd.init == "zeros":
            return torch.zeros(pd.shape, dtype=dtype, device=dev)
        if pd.init == "ones":
            return torch.ones(pd.shape, dtype=dtype, device=dev)
        fan_in = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
        scale = pd.scale if pd.scale is not None else fan_in ** -0.5
        w = torch.randn(pd.shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)

    return tree_map(one, defs)


def param_structs(defs, dtype):
    """Meta tensors of the parameters' shapes and type (no storage)."""
    return tree_map(lambda pd: torch.empty(pd.shape, dtype=dtype,
                                           device="meta"), defs)


def param_logical(defs):
    return tree_map(lambda pd: pd.logical, defs)


# ---------------------------------------------------------------------------
# Norms / RoPE
# ---------------------------------------------------------------------------

def fsdp_gather(block_params, block_defs):
    """A block's weights gathered from this rank's shards, inside the layer
    body (so remat gathers again in the backward, and one layer's weights
    are gathered at a time); the identity without a mesh.

    Under tensor parallelism only the data (fsdp) axes are gathered and
    each weight keeps its "model" shards of the TP axes ("heads",
    "kv_heads", "qkv", "ff", "vocab", "ssm_heads", "ssm_inner"), as the
    reference's ``fsdp_gather`` drops only the "embed" axis: the layer
    functions compute this rank's part of each product, in a serve step
    and in a train step alike (``distributed/sharding.py``).  The MoE's
    expert weights stay sharded over "model" under both (the experts under
    expert parallelism, their d_ff under expert-TP), as the reference's
    ``shard_map`` takes them, and ``moe._moe_sharded`` computes on this
    rank's part, so no rank holds every expert."""
    mesh = shd.active_mesh()
    if mesh is None:
        return block_params
    tp = shd.active_tp()
    return tree_map(lambda x, pd: shd.gather(
        x, pd.logical, pd.shape, mesh, keep=shd.kept_axes(pd.logical, tp)),
        block_params, block_defs)


def rmsnorm(x, w, eps):
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * w


def _seq_tp():
    """The active ``TensorParallel`` where it splits the sequence, else
    None."""
    tp = shd.active_tp()
    return tp if tp is not None and tp.seq else None


def gather_seq(x):
    """Under sequence parallelism the whole sequence [B,S,...] from this
    rank's slice ``x`` [B,S/n,...] (an all-gather; backward: a
    reduce-scatter); else ``x``."""
    tp = _seq_tp()
    return collectives.all_gather(x, 1, tp.group) if tp is not None else x


def local_seq(x):
    """Under sequence parallelism this rank's slice of the sequence of a
    tensor ``x`` [B,S,...] every model rank holds whole; else ``x``."""
    tp = _seq_tp()
    if tp is None:
        return x
    n = x.shape[1] // tp.n
    return x.narrow(1, tp.rank * n, n)


def to_residual(y, split: bool):
    """A product's result ``y`` [B,S,D] in the residual's layout: where
    ``split`` (a row-parallel product under tensor parallelism) ``y`` holds
    this rank's partial sums, added over "model"; else ``y`` is whole.
    Under sequence parallelism the result is this rank's slice of the
    sequence: the sums reduce-scattered onto it, a whole ``y`` sliced."""
    tp = shd.active_tp()
    if tp is None:
        return y
    if tp.seq:
        return collectives.reduce_scatter(y, 1, tp.group) if split \
            else local_seq(y)
    return collectives.row_parallel_sum(y, tp.group) if split else y


def rope_tables(positions, head_dim, theta, dtype):
    """positions: int [...]; returns cos/sin [..., head_dim//2] in dtype."""
    half = head_dim // 2
    dev = positions.device
    ar = torch.arange(0, half, dtype=torch.float32, device=dev)
    # theta as a filled device scalar: no host-to-device copy (a copy waits
    # for the stream)
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32, device=dev),
                      -ar / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x: [..., S, H, D]; cos/sin: [..., S, D//2] broadcast over heads."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

ATTN_CHUNK = 1024          # online-softmax KV/Q chunk for long sequences
EXACT_ATTN_MAX_SEQ = 2048  # below this, materialize scores exactly
NEG = -1e30                # the reference's finite mask value


def attention_defs(cfg, d_model=None):
    d = d_model or cfg.d_model
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    defs = {
        "wq": PD((d, H * hd), ("embed", "heads")),
        "wk": PD((d, KV * hd), ("embed", "kv_heads")),
        "wv": PD((d, KV * hd), ("embed", "kv_heads")),
        "wo": PD((H * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = PD((H * hd,), ("heads",), "zeros")
        defs["bk"] = PD((KV * hd,), ("kv_heads",), "zeros")
        defs["bv"] = PD((KV * hd,), ("kv_heads",), "zeros")
    return defs


def _heads(x, hd: int, part: bool):
    """A projection's output [B,S,cols] as [B,S,heads,hd]; where ``part``
    (under tensor parallelism, this rank's columns are a part of a head)
    every rank's columns, all-gathered."""
    if part:
        x = collectives.all_gather(x, -1, shd.active_tp().group)
    return x.reshape(*x.shape[:2], -1, hd)


def _project_q(p, h, cfg):
    q = h @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    tp = shd.active_tp()
    return _heads(q, cfg.head_dim,
                  tp is not None and tp.heads and not tp.whole_heads)


def project_kv(p, x, cfg):
    """K and V of ``x`` [B,S,D] as [B,S,kv,hd]: every kv head, or this
    rank's under tensor parallelism where they are whole heads."""
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    tp = shd.active_tp()
    part = tp is not None and tp.kv_heads and not tp.whole_kv_heads
    return _heads(k, cfg.head_dim, part), _heads(v, cfg.head_dim, part)


def _project_qkv(p, h, cfg):
    q = _project_q(p, h, cfg)
    k, v = project_kv(p, h, cfg)
    return q, k, v


def _q_heads(cfg) -> tuple:
    """(first, count) of the q heads this rank attends with: under tensor
    parallelism those whose outputs its rows of wo take (its own, or where
    its columns are not whole heads the heads they fall in), else all."""
    H, hd = cfg.num_heads, cfg.head_dim
    tp = shd.active_tp()
    if tp is None or not tp.heads:
        return 0, H
    c = H * hd // tp.n
    lo = tp.rank * c // hd
    return lo, -(-(tp.rank + 1) * c // hd) - lo


def _own_heads(q, cfg):
    """q [B,S,heads,hd] at this rank's q heads (``_q_heads``): as it is
    where it holds those alone, else their slice of every head."""
    lo, n = _q_heads(cfg)
    return q if q.shape[2] == n else q[:, :, lo:lo + n]


def _repeat_kv(k, v, cfg):
    """K/V [..., kv, hd] at this rank's q heads: each kv head repeated for
    its group, or, where the q heads are this rank's and K/V whole, each q
    head j's kv head j // group picked."""
    g = cfg.num_heads // cfg.num_kv_heads
    lo, n = _q_heads(cfg)
    if n < cfg.num_heads and k.shape[-2] == cfg.num_kv_heads:
        idx = torch.arange(lo, lo + n, device=k.device) // g
        return k.index_select(-2, idx), v.index_select(-2, idx)
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=-2)
        v = torch.repeat_interleave(v, g, dim=-2)
    return k, v


def _out_proj(p, out, cfg):
    """``wo`` on the attention's output [B,S,heads,hd] of this rank's q
    heads (``_q_heads``); under tensor parallelism this rank's rows of wo
    times its columns of the output (where they are not whole heads, its
    slice of its heads'), the partial sums added over "model" (onto the
    sequence under sequence parallelism, ``to_residual``)."""
    o = out.reshape(*out.shape[:2], -1)
    tp = shd.active_tp()
    split = tp is not None and tp.heads
    if split and not tp.whole_heads:
        c = cfg.num_heads * cfg.head_dim // tp.n
        first = tp.rank * c - _q_heads(cfg)[0] * cfg.head_dim
        o = o[..., first:first + c]
    return to_residual(o @ p["wo"], split)


def _exact_attn(q, k, v, causal, q_offset=0, kv_len=None):
    """q [B,Sq,H,D], k/v [B,Sk,H,D]; ``kv_len`` an int or int ``[B]``
    (keys at or past it masked)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    Sq, Sk = q.shape[1], k.shape[1]
    dev = q.device
    if kv_len is not None:  # decode against a cache filled up to kv_len
        kv_len = torch.as_tensor(kv_len, device=dev)
        ki = torch.arange(Sk, device=dev)
        if kv_len.ndim:
            mask = (ki[None, :] < kv_len[:, None])[:, None, None, :]
        else:
            mask = (ki < kv_len)[None, None, None, :]
        s = torch.where(mask, s, NEG)
    if causal:
        qi = torch.arange(Sq, device=dev) + q_offset
        ki = torch.arange(Sk, device=dev)
        s = torch.where((ki[None, :] <= qi[:, None])[None, None], s, NEG)
    a = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", a, v)


def _chunked_attn(q, k, v, causal):
    """Online-softmax attention over KV chunks of ``ATTN_CHUNK`` (the
    reference's ``lax.scan``): no [Sq, Sk] score tensor beyond a chunk."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    ck = min(ATTN_CHUNK, Sk)
    if Sk % ck:  # pad KV to a chunk multiple; padded keys are masked below
        pad = ck - Sk % ck
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    nk = k.shape[1] // ck
    scale = D ** -0.5
    dev = q.device
    qi = torch.arange(Sq, device=dev)
    f32 = torch.float32
    acc = torch.zeros(B, H, Sq, D, dtype=f32, device=dev)
    m = torch.full((B, H, Sq), float("-inf"), dtype=f32, device=dev)
    l = torch.zeros(B, H, Sq, dtype=f32, device=dev)
    for j in range(nk):
        kb, vb = k[:, j * ck:(j + 1) * ck], v[:, j * ck:(j + 1) * ck]
        s = torch.einsum("bqhd,bkhd->bhqk", q, kb).float() * scale
        ki = j * ck + torch.arange(ck, device=dev)
        if causal:
            s = torch.where((ki[None, :] <= qi[:, None])[None, None], s, NEG)
        else:
            s = torch.where((ki < Sk)[None, None, None], s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), vb).float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _plain_attn(q, k, v, causal):
    """The reference's split between its two plain versions."""
    if max(q.shape[1], k.shape[1]) <= EXACT_ATTN_MAX_SEQ:
        return _exact_attn(q, k, v, causal)
    return _chunked_attn(q, k, v, causal)


class FlashAttention(torch.autograd.Function):
    """Self-attention whose forward is the flash-attention kernel and whose
    backward, for heads up to ``flash_attention_bwd.MAX_D`` (128) columns,
    is the backward kernel (``flash_attention_bwd``) from the saved q,
    repeated k and v, output and row log-sum-exp (the forward runs
    ``flash_attention_lse``); on CPU tensors both are their plain
    versions.  Wider heads keep the vector-Jacobian product of the plain
    route (``_plain_attn``), recomputed from the saved q, k and v, counted
    by ``flash_attention_bwd.plain_vjp_calls``.  The route is chosen by D
    alone (``flash_attention_bwd.route``).  Either way the gradient is the
    one the reference's autodiff takes of its plain formula."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        if fab.route(q.shape[-1]) == "kernel":
            out, lse = fa.flash_attention_lse(q, k, v, causal=causal)
            ctx.save_for_backward(q, k, v, out, lse)
            return out
        ctx.save_for_backward(q, k, v)
        return ops.flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors    # unpacked once (remat's recompute)
        if fab.route(saved[0].shape[-1]) == "kernel":
            dq, dk, dv = fab.flash_attention_bwd(*saved, dout,
                                                 causal=ctx.causal)
            return dq, dk, dv, None
        fab.flash_attention_bwd.plain_vjp_calls += 1
        q, k, v = (t.detach().requires_grad_() for t in saved)
        with torch.enable_grad():
            out = _plain_attn(q, k, v, ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
        return dq, dk, dv, None


class PlainAttention:
    """Stands in for ``FlashAttention`` where the plain route's gradient is
    wanted: ``_plain_attn`` under native autograd, the yardstick the card
    checks hold the kernel route's gradients to (they swap it in for
    ``FlashAttention``)."""

    @staticmethod
    def apply(q, k, v, causal):
        return _plain_attn(q, k, v, causal)


def attention_fwd(p, h, cfg, *, positions, causal=True, kv=None):
    """Full-sequence attention (train / prefill).  Returns (out, (k, v)).

    Self-attention runs the flash-attention kernel on a CUDA tensor (as
    ``FlashAttention`` while autograd records); cross-attention (``kv``
    given) is the plain route on every device.  Under sequence parallelism
    ``h`` is this rank's slice of the sequence, gathered whole here, and
    the output is this rank's slice again (``_out_proj``)."""
    h = gather_seq(h)
    q, k, v = _project_qkv(p, h, cfg)
    if cfg.rope_theta > 0:
        cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                               h.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    cache_kv = (k, v)
    if kv is not None:  # cross-attention: use provided memory k/v
        k, v = kv
        cache_kv = kv
        causal = False
    q = _own_heads(q, cfg)
    k2, v2 = _repeat_kv(k, v, cfg)
    q = constraint(q, ("batch", None, "heads", None))
    if kv is None and q.is_cuda:
        qkv = (q.contiguous(), k2.contiguous(), v2.contiguous())
        if recording(*qkv):
            out = FlashAttention.apply(*qkv, causal)
        else:
            out = ops.flash_attention(*qkv, causal=causal)
    else:
        out = _plain_attn(q, k2, v2, causal)
    return _out_proj(p, out, cfg), cache_kv


def attention_decode(p, h, cfg, cache_k, cache_v, pos: int):
    """Single-token decode.  h [B,1,D]; cache [B,Smax,KV,hd]; pos an int.

    Writes the new K/V at ``pos`` into the caches in place (the reference's
    one-hot select gives the same values) in the cache's type, reads them
    back in h's type, and attends over the keys below ``pos + 1``: the
    flash-decoding kernel on a CUDA tensor, the plain ``_exact_attn`` on a
    CPU one.  Under a mesh whose decode step shards the cache's sequence
    over "model" (the reference's ``collectives.applicable``), the caches
    are this rank's rows and ``collectives.flash_decode_attention`` runs
    instead, on q and the new K/V whole (under tensor parallelism their
    heads all-gathered, and this rank's heads of the output kept).  Under
    tensor parallelism a cache of this rank's kv heads (its "model" shard
    of "kv_heads") or of every kv head is attended with this rank's q
    heads.  Returns (out, cache_k, cache_v)."""
    q, k, v = _project_qkv(p, h, cfg)
    if cfg.rope_theta > 0:
        posv = torch.full((h.shape[0], 1), pos, dtype=torch.int32,
                          device=h.device)
        cos, sin = rope_tables(posv, cfg.head_dim, cfg.rope_theta, h.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    mesh = shd.active_mesh()
    if mesh is not None and shd.active_kv_sharded() and \
            collectives.applicable(mesh, h.shape[0],
                                   cache_k.shape[1] * mesh.size("model"),
                                   cfg.num_heads, cfg.num_kv_heads):
        tp = shd.active_tp()
        if tp is not None and tp.whole_heads:
            q = collectives.all_gather(q, 2, tp.group)
        if tp is not None and tp.whole_kv_heads:
            k = collectives.all_gather(k, 2, tp.group)
            v = collectives.all_gather(v, 2, tp.group)
        out, cache_k, cache_v = collectives.flash_decode_attention(
            q, cache_k, cache_v, k, v, pos, mesh, heads=_q_heads(cfg))
        return _out_proj(p, out, cfg), cache_k, cache_v
    q = _own_heads(q, cfg)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    kk, vv = _repeat_kv(cache_k.to(h.dtype), cache_v.to(h.dtype), cfg)
    if q.is_cuda:
        # the lengths filled on the device (no copy that waits for it)
        lens = torch.full((q.shape[0],), pos + 1, dtype=torch.int32,
                          device=q.device)
        out = ops.decode_attention(q[:, 0].contiguous(), kk.contiguous(),
                                   vv.contiguous(), lens)[:, None]
    else:
        out = _exact_attn(q, kk, vv, causal=False, kv_len=pos + 1)
    return _out_proj(p, out, cfg), cache_k, cache_v


def attention_cached(p, h, cfg, k, v):
    """h's queries against fixed K/V [B,Sk,kv,hd] with no mask or
    positions (a decoder's cross-attention to the encoder's cached K/V):
    the plain route on every device."""
    q = _own_heads(_project_q(p, h, cfg), cfg)
    kk, vv = _repeat_kv(k.to(h.dtype), v.to(h.dtype), cfg)
    return _out_proj(p, _exact_attn(q, kk, vv, causal=False), cfg)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_defs(cfg, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w1": PD((d, f), ("embed", "ff")),
        "w3": PD((d, f), ("embed", "ff")),
        "w2": PD((f, d), ("ff", "embed")),
    }


def mlp_fwd(p, h):
    """SwiGLU; under tensor parallelism on this rank's d_ff columns (w1,
    w3) and rows (w2), the partial sums added over "model" (under
    sequence parallelism ``h`` is this rank's slice of the sequence,
    gathered first, and the sums reduce-scattered onto it; an MLP whose
    d_ff is whole runs on the slice)."""
    tp = shd.active_tp()
    split = tp is not None and tp.ff
    if split:
        h = gather_seq(h)
    g = torch.nn.functional.silu(h @ p["w1"]) * (h @ p["w3"])
    y = g @ p["w2"]
    return to_residual(y, split) if split else y


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_defs(cfg):
    v = cfg.padded_vocab
    defs = {"embedding": PD((v, cfg.d_model), ("vocab", "embed"), scale=1.0)}
    if not cfg.tie_embeddings:
        defs["unembed"] = PD((cfg.d_model, v), ("embed", "vocab"))
    return defs


class EmbedGather(torch.autograd.Function):
    """The table's rows of ``tokens`` in ``dtype``; with ``pad`` a token
    of ``len(w)`` (no row of this table: under tensor parallelism a token
    of another rank's rows) reads zeros.  Its backward is the table's
    gradient as a sorted segment sum (``kernels.segment_sum``): each
    token's positions added in position order in float32 and rounded once
    to the table's type, the same bits on every run (autograd's
    scatter-add adds by atomics on the card); with ``pad`` the sum is over
    a table of one row more, whose last row (the other ranks' tokens) is
    dropped (a view)."""

    @staticmethod
    def forward(ctx, w, tokens, dtype, pad=False):
        ctx.save_for_backward(tokens)
        ctx.rows, ctx.w_dtype, ctx.pad = w.shape[0], w.dtype, pad
        if not pad:
            return w[tokens].to(dtype)
        n = w.shape[0]
        rows = w[tokens.clamp(max=n - 1)].to(dtype)
        return rows.masked_fill((tokens == n)[..., None], 0.0)

    @staticmethod
    def backward(ctx, dout):
        tokens, = ctx.saved_tensors
        g = dout.reshape(-1, dout.shape[-1]).contiguous()
        table = segment_sum(g, tokens.reshape(-1).contiguous(),
                            ctx.rows + ctx.pad, ctx.w_dtype)
        return table[:ctx.rows], None, None, None


def embed_fwd(p, tokens, dtype):
    """The rows of ``tokens`` in ``dtype``.  While autograd records, through
    ``EmbedGather``, whose backward sums each token's positions in float32
    and rounds the sum to the table's type once.  (The reference scatters
    in the table's type: in bfloat16 the sum of a token seen thousands of
    times, as the Zipf batches' first tokens are, stops taking in small
    terms and ends ~0.5 of the leaf's largest magnitude from the float32
    sum.)  Under tensor parallelism the table is this rank's rows of the
    vocabulary: the rows of the tokens in them, zeros for the others, added
    over "model" (``to_residual``: under sequence parallelism
    reduce-scattered onto this rank's slice of the sequence);
    while autograd records the lookup is ``EmbedGather``'s on this rank's
    rows, a token of another rank's rows indexing one row past them."""
    w = p["embedding"]
    tp = shd.active_tp()
    split = tp is not None and tp.vocab
    if split:
        n = w.shape[0]
        idx = tokens.long() - tp.rank * n
        hit = (idx >= 0) & (idx < n)
        if recording(w):
            rows = EmbedGather.apply(w, torch.where(hit, idx, n), dtype, True)
        else:
            rows = torch.where(hit[..., None],
                               w.to(dtype)[idx.clamp(0, n - 1)], 0.0)
    elif recording(w):
        rows = EmbedGather.apply(w, tokens, dtype)
    else:
        rows = w.to(dtype)[tokens]
    return to_residual(rows, split)


def unembed_fwd(p, h):
    """Float32 logits over the padded vocabulary; under tensor parallelism
    over this rank's slice of it (the table's rows, or the unembedding's
    columns, it holds).  Under sequence parallelism ``h`` is this rank's
    slice of the sequence, gathered whole first."""
    h = gather_seq(h)
    w = p.get("unembed")
    if w is None:
        w = p["embedding"].T.to(h.dtype)
    # vocab-sharded logits in the reference (keeps the [V, D] gradient
    # from being replicated); a local tensor stays in the step's layout
    return constraint((h @ w).float(), ("batch", None, "vocab"))


def _vocab_parallel_nll(logits, labels, tp):
    """The NLL of ``labels`` under logits [B,S,V/n] that are this rank's
    slice of the vocabulary: the log-sum-exp from the ranks' row maxima
    (all-gathered, no gradient) and the ``psum`` of the sums of
    exponentials, the gold logit ``psum``-ed from the rank that holds the
    label."""
    n = logits.shape[-1]
    with torch.no_grad():
        m = collectives._all_gather(logits.amax(-1)[None], 0, tp.group)
        m = m.amax(0)
    se = collectives.psum(torch.exp(logits - m[..., None]).sum(-1),
                          tp.group)
    idx = labels.long() - tp.rank * n
    hit = (idx >= 0) & (idx < n)
    gold = torch.gather(logits, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
    gold = collectives.psum(torch.where(hit, gold, 0.0), tp.group)
    return m + torch.log(se) - gold


def cross_entropy(logits, labels, mask=None):
    """logits [B,S,V] fp32, labels [B,S] int; mean NLL over valid tokens.
    Under tensor parallelism of the vocabulary the logits are this rank's
    slice of it (``_vocab_parallel_nll``)."""
    tp = shd.active_tp()
    if tp is not None and tp.vocab:
        nll = _vocab_parallel_nll(logits, labels, tp)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)

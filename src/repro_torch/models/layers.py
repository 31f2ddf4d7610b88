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
  forward, and for the backward the vector-Jacobian product of that plain
  split, recomputed (the reference differentiates the plain formula; it
  has no backward kernel);
- the cached self-attention of a decode step (``attention_decode``) runs
  the port's flash-decoding kernel (``ops.decode_attention``) on CUDA
  tensors and the plain ``_exact_attn`` with ``kv_len`` on CPU tensors;
- cross-attention (``attention_fwd`` with ``kv``, Sq != Sk, which the flash
  kernel refuses as the Pallas one does) is plain torch on every device
  (``_exact_attn`` / ``_chunked_attn``, the plain cross-attention route).

The embedding's gradient is summed in float32 while autograd records
(``embed_fwd``), where the reference's bfloat16 scatter rounds after every
add; in float32 the two are the same.

Remat (``run_layer``): where the reference wraps a layer body in
``jax.checkpoint`` under ``cfg.remat``, the port calls it through
``torch.utils.checkpoint`` (non-reentrant) while autograd records, and
directly otherwise; the values are the same either way.  A training
forward takes its stacked layers apart with ``unstacked`` (one ``unbind``
a leaf, so the backward stacks each leaf's gradients once).

Under a mesh (``distributed.sharding.use_mesh``) a layer computes on this
rank's local tensors: ``fsdp_gather`` gathers a layer's weights whole from
their shards (its backward reduce-scatters their gradients), ``constraint``
redistributes a DTensor and leaves a local activation in the step's layout,
and ``attention_decode`` takes the flash decode over a sequence-sharded
cache (``distributed.collectives``) where the reference does.  Without a
mesh all three are as before: identities and the one-device decode.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.utils.checkpoint

from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import constraint
from repro_torch.kernels import ops


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
    """A block's weights gathered whole from this rank's shards, inside the
    layer body (so remat gathers again in the backward, and one layer's
    weights are whole at a time); the identity without a mesh.

    The reference drops only the "embed" (fsdp) axis here and leaves the
    tensor-parallel axes to GSPMD's partition of the products; the port has
    no propagation, so its layers take every weight whole and split the
    batch instead (``distributed/sharding.py``).  The MoE's expert weights
    are the exception: they stay sharded over "model" (the experts under
    expert parallelism, their d_ff under expert-TP), as the reference's
    ``shard_map`` takes them, and ``moe._moe_sharded`` computes on this
    rank's part, so no rank holds every expert."""
    mesh = shd.active_mesh()
    if mesh is None:
        return block_params
    return tree_map(lambda x, pd: shd.gather(
        x, pd.logical, pd.shape, mesh,
        keep=("model",) if _EXPERT_AXES & set(pd.logical) else ()),
        block_params, block_defs)


# the logical axes of the MoE's expert weights (moe.moe_defs)
_EXPERT_AXES = frozenset(("expert", "expert_ff"))


def rmsnorm(x, w, eps):
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * w


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


def _project_qkv(p, h, cfg):
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, S = h.shape[:2]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    return q, k, v


def _repeat_kv(k, v, cfg):
    g = cfg.num_heads // cfg.num_kv_heads
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=-2)
        v = torch.repeat_interleave(v, g, dim=-2)
    return k, v


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
    """Self-attention whose forward is the flash-attention kernel
    (``ops.flash_attention``) and whose backward is the vector-Jacobian
    product of the plain route (``_plain_attn``), recomputed from the saved
    q and repeated k and v: the gradient the reference's autodiff takes."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return ops.flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
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
    given) is the plain route on every device."""
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
    out = out.reshape(*h.shape[:2], cfg.num_heads * cfg.head_dim)
    return out @ p["wo"], cache_kv


def attention_decode(p, h, cfg, cache_k, cache_v, pos: int):
    """Single-token decode.  h [B,1,D]; cache [B,Smax,KV,hd]; pos an int.

    Writes the new K/V at ``pos`` into the caches in place (the reference's
    one-hot select gives the same values) in the cache's type, reads them
    back in h's type, and attends over the keys below ``pos + 1``: the
    flash-decoding kernel on a CUDA tensor, the plain ``_exact_attn`` on a
    CPU one.  Under a mesh whose decode step shards the cache's sequence
    over "model" (the reference's ``collectives.applicable``), the caches
    are this rank's rows and ``collectives.flash_decode_attention`` runs
    instead.  Returns (out, cache_k, cache_v)."""
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
        out, cache_k, cache_v = collectives.flash_decode_attention(
            q, cache_k, cache_v, k, v, pos, mesh)
        out = out.reshape(h.shape[0], 1, cfg.num_heads * cfg.head_dim)
        return out @ p["wo"], cache_k, cache_v
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
    out = out.reshape(h.shape[0], 1, cfg.num_heads * cfg.head_dim)
    return out @ p["wo"], cache_k, cache_v


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
    g = torch.nn.functional.silu(h @ p["w1"]) * (h @ p["w3"])
    return g @ p["w2"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_defs(cfg):
    v = cfg.padded_vocab
    defs = {"embedding": PD((v, cfg.d_model), ("vocab", "embed"), scale=1.0)}
    if not cfg.tie_embeddings:
        defs["unembed"] = PD((cfg.d_model, v), ("embed", "vocab"))
    return defs


def embed_fwd(p, tokens, dtype):
    """The rows of ``tokens`` in ``dtype``.  While autograd records, the
    rows are read from a float32 copy of the table, so the backward sums
    each token's positions in float32 and rounds the sum to the table's
    type once.  (The reference scatters in the table's type: in bfloat16
    the sum of a token seen thousands of times, as the Zipf batches' first
    tokens are, stops taking in small terms and ends ~0.5 of the leaf's
    largest magnitude from the float32 sum.)"""
    w = p["embedding"]
    if recording(w):
        return w.float()[tokens].to(dtype)
    return w.to(dtype)[tokens]


def unembed_fwd(p, h):
    """Float32 logits over the padded vocabulary."""
    w = p.get("unembed")
    if w is None:
        w = p["embedding"].T.to(h.dtype)
    # vocab-sharded logits in the reference (keeps the [V, D] gradient
    # from being replicated); a local tensor stays in the step's layout
    return constraint((h @ w).float(), ("batch", None, "vocab"))


def cross_entropy(logits, labels, mask=None):
    """logits [B,S,V] fp32, labels [B,S] int; mean NLL over valid tokens."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)

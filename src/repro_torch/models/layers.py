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
  past it, the reference's split (``layers.py:216``);
- the cached self-attention of a decode step (``attention_decode``) runs
  the port's flash-decoding kernel (``ops.decode_attention``) on CUDA
  tensors and the plain ``_exact_attn`` with ``kv_len`` on CPU tensors;
- cross-attention (``attention_fwd`` with ``kv``, Sq != Sk, which the flash
  kernel refuses as the Pallas one does) is plain torch on every device
  (``_exact_attn`` / ``_chunked_attn``, the plain cross-attention route).

``fsdp_gather`` and ``constraint`` are identities on one device and are left
out, as is the mesh branch of ``attention_decode``; ``distributed/`` brings
them back.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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


def attention_fwd(p, h, cfg, *, positions, causal=True, kv=None):
    """Full-sequence attention (train / prefill).  Returns (out, (k, v)).

    Self-attention runs the flash-attention kernel on a CUDA tensor;
    cross-attention (``kv`` given) is the plain route on every device."""
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
    if kv is None and q.is_cuda:
        out = ops.flash_attention(q.contiguous(), k2.contiguous(),
                                  v2.contiguous(), causal=causal)
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
    CPU one.  Returns (out, cache_k, cache_v)."""
    q, k, v = _project_qkv(p, h, cfg)
    if cfg.rope_theta > 0:
        posv = torch.full((h.shape[0], 1), pos, dtype=torch.int32,
                          device=h.device)
        cos, sin = rope_tables(posv, cfg.head_dim, cfg.rope_theta, h.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
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
    return p["embedding"].to(dtype)[tokens]


def unembed_fwd(p, h):
    """Float32 logits over the padded vocabulary."""
    w = p.get("unembed")
    if w is None:
        w = p["embedding"].T.to(h.dtype)
    return (h @ w).float()


def cross_entropy(logits, labels, mask=None):
    """logits [B,S,V] fp32, labels [B,S] int; mean NLL over valid tokens."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)

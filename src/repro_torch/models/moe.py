"""Mixture-of-Experts FFN (dbrx / granite / jamba) with sort-based dispatch.

The port of ``repro/models/moe.py``.  Dispatch is capacity-bucketed
(Switch-style): tokens are sorted by expert id (a stable sort of the
``top_k`` choices), each expert keeps at most ``capacity`` tokens, the rest
are dropped (combine weight zero, the residual passes through).  The
reference scatters in drop mode with the out-of-range sentinels ``E*C`` and
``T``; the port gives each buffer one spare row those sentinels land in and
slices it off, so no index is ever out of range.  The combine sums in
float32.  The experts' products are ``torch.einsum``, as the reference's
are ``jnp.einsum``.

Only the reference's local branch (no mesh, ``moe.py:107-110``) is ported;
its ``shard_map`` branch waits for ``distributed/``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import PD

CAPACITY_FACTOR = 1.25


def moe_defs(cfg, d_ff=None):
    d, f, e = cfg.d_model, d_ff or cfg.d_ff, cfg.num_experts
    return {
        "router": PD((d, e), ("embed", None)),
        "w1": PD((e, d, f), ("expert", "embed", "expert_ff")),
        "w3": PD((e, d, f), ("expert", "embed", "expert_ff")),
        "w2": PD((e, f, d), ("expert", "expert_ff", "embed")),
    }


def capacity(num_tokens, cfg):
    c = int(num_tokens * cfg.experts_per_token / cfg.num_experts
            * CAPACITY_FACTOR)
    # rounded to 64 (the reference keeps the capacity dim shardable)
    return max(64, -(-c // 64) * 64)


def _dispatch(x, router, cfg, C):
    """Local sort-based dispatch.  x [T,D] -> (xe [E,C,D], combine, aux)."""
    T_, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    dev = x.device
    probs = torch.softmax((x @ router).float(), dim=-1)          # [T,E]
    top_w, top_e = torch.topk(probs, K, dim=-1)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    # load-balance aux loss (Switch): E * sum_e frac_tokens_e * mean_prob_e
    me = probs.mean(0)
    ce = torch.zeros(E, device=dev).index_add_(
        0, top_e.reshape(-1), torch.ones(T_ * K, device=dev)) / (T_ * K)
    aux = E * torch.sum(me * ce)

    flat_e = top_e.reshape(-1)
    flat_t = torch.arange(T_, device=dev).repeat_interleave(K)
    flat_w = top_w.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    counts = torch.zeros(E, dtype=se.dtype, device=dev).index_add_(
        0, se, torch.ones_like(se))
    offsets = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T_ * K, device=dev) - offsets[se]
    keep = pos_in_e < C
    slot = torch.where(keep, se * C + pos_in_e, E * C)   # E*C -> dropped

    # the buffers' spare row E*C takes the dropped entries
    buf_tok = torch.zeros(E * C + 1, dtype=torch.long, device=dev)
    buf_tok[slot] = torch.where(keep, st, 0)
    buf_tok = buf_tok[:E * C]
    xe = x[buf_tok].reshape(E, C, D)                               # [E,C,D]

    buf_w = torch.zeros(E * C + 1, dtype=flat_w.dtype, device=dev)
    buf_w[slot] = torch.where(keep, sw, 0.0)
    buf_w = buf_w[:E * C]
    buf_src = torch.full((E * C + 1,), T_, dtype=torch.long, device=dev)
    buf_src[slot] = torch.where(keep, st, T_)
    buf_src = buf_src[:E * C]

    def combine(ye):
        # row T takes the empty slots' (zero-weight) rows
        out = torch.zeros(T_ + 1, D, dtype=torch.float32, device=dev)
        upd = ye.reshape(E * C, D).float() * buf_w[:, None]
        return out.index_add_(0, buf_src, upd)[:T_].to(x.dtype)

    return xe, combine, aux


def _expert_ffn(xe, w1, w3, w2):
    g = F.silu(torch.einsum("ecd,edf->ecf", xe, w1))
    g = g * torch.einsum("ecd,edf->ecf", xe, w3)
    return torch.einsum("ecf,efd->ecd", g, w2)


def moe_fwd(p, h, cfg):
    """h [B,S,D] -> ([B,S,D], aux_loss): the dispatch of all B*S tokens on
    this device."""
    B, S, D = h.shape
    xe, combine, aux = _dispatch(h.reshape(B * S, D), p["router"], cfg,
                                 capacity(B * S, cfg))
    out = combine(_expert_ffn(xe, p["w1"], p["w3"], p["w2"]))
    return out.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# MoE transformer (dbrx / granite): attention + MoE FFN blocks
# ---------------------------------------------------------------------------

def block_defs(cfg):
    return {
        "attn_norm": PD((cfg.d_model,), ("embed",), "ones"),
        "attn": L.attention_defs(cfg),
        "mlp_norm": PD((cfg.d_model,), ("embed",), "ones"),
        "moe": moe_defs(cfg),
    }


def model_defs(cfg):
    return {
        "embed": L.embed_defs(cfg),
        "blocks": T.stacked(block_defs(cfg), cfg.num_layers),
        "final_norm": PD((cfg.d_model,), ("embed",), "ones"),
    }


def block_fwd(p, h, cfg, positions):
    a, _ = L.attention_fwd(p["attn"], L.rmsnorm(h, p["attn_norm"],
                                                cfg.norm_eps),
                           cfg, positions=positions)
    h = h + a
    m, aux = moe_fwd(p["moe"], L.rmsnorm(h, p["mlp_norm"], cfg.norm_eps),
                     cfg)
    return h + m, aux


def forward(params, tokens, cfg):
    h = L.embed_fwd(params["embed"], tokens, cfg.torch_dtype)
    positions = torch.arange(tokens.shape[1], device=h.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    body = lambda h, bp: block_fwd(bp, h, cfg, positions)
    for bp in L.unstacked(params["blocks"]):
        h, a = L.run_layer(body, cfg.remat, h, bp)
        aux = aux + a
    return L.rmsnorm(h, params["final_norm"], cfg.norm_eps), \
        aux / cfg.num_layers


def loss_fn(params, batch, cfg, aux_weight=0.01):
    h, aux = forward(params, batch["tokens"], cfg)
    logits = L.unembed_fwd(params["embed"], h)
    return L.cross_entropy(logits, batch["labels"],
                           batch.get("loss_mask")) + aux_weight * aux


def init_cache(cfg, batch, max_seq, dtype, device=None):
    return T.init_cache(cfg, batch, max_seq, dtype, device)


def cache_logical(cfg):
    return T.cache_logical(cfg)


def decode_step(params, cache, tokens, pos, cfg):
    """Returns (logits, cache), the cache updated in place."""
    h = L.embed_fwd(params["embed"], tokens, cfg.torch_dtype)
    for i in range(T.num_stacked(params["blocks"])):
        bp = T.layer(params["blocks"], i)
        a, _, _ = L.attention_decode(
            bp["attn"], L.rmsnorm(h, bp["attn_norm"], cfg.norm_eps), cfg,
            cache["k"][i], cache["v"][i], pos)
        h = h + a
        m, _ = moe_fwd(bp["moe"], L.rmsnorm(h, bp["mlp_norm"], cfg.norm_eps),
                       cfg)
        h = h + m
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.unembed_fwd(params["embed"], h), cache


def prefill(params, tokens, cfg, max_seq):
    h = L.embed_fwd(params["embed"], tokens, cfg.torch_dtype)
    positions = torch.arange(tokens.shape[1], device=h.device)[None, :]
    ks, vs = [], []
    for i in range(T.num_stacked(params["blocks"])):
        bp = T.layer(params["blocks"], i)
        a, (k, v) = L.attention_fwd(
            bp["attn"], L.rmsnorm(h, bp["attn_norm"], cfg.norm_eps), cfg,
            positions=positions)
        h = h + a
        m, _ = moe_fwd(bp["moe"], L.rmsnorm(h, bp["mlp_norm"], cfg.norm_eps),
                       cfg)
        h = h + m
        ks.append(k)
        vs.append(v)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = L.unembed_fwd(params["embed"], h[:, -1:])
    ck, cv = T.padded_kv(ks, vs, max_seq)
    return logits, {"k": ck, "v": cv}

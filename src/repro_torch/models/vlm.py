"""InternVL2-style VLM backbone (InternLM2 decoder over patch + text embeds).

The port of ``repro/models/vlm.py``.  The InternViT frontend is stubbed as
in the reference: callers give precomputed patch embeddings
[B, num_patches, d_model], projected and joined ahead of the text-token
embeddings; the combined sequence runs through the dense decoder stack
causally, so the cache covers patches and text.  Loss is over the text
positions.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import PD


def model_defs(cfg):
    defs = T.model_defs(cfg)
    # small projection applied to stub patch embeddings (stands in for the
    # mlp1 projector of InternVL2)
    defs["patch_proj"] = PD((cfg.d_model, cfg.d_model), ("embed", None))
    return defs


def _combine(params, patches, tokens, cfg):
    dtype = cfg.torch_dtype
    pe = (patches.to(dtype) @ params["patch_proj"]).to(dtype)
    te = L.embed_fwd(params["embed"], tokens, dtype)
    return torch.cat([pe, te], dim=1)


def forward(params, patches, tokens, cfg):
    h = _combine(params, patches, tokens, cfg)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    body = lambda h, bp: T.block_fwd(bp, h, cfg, positions)
    for bp in L.unstacked(params["blocks"]):
        h = L.run_layer(body, cfg.remat, h, bp)
    return L.rmsnorm(h, params["final_norm"], cfg.norm_eps)


def loss_fn(params, batch, cfg):
    h = forward(params, batch["patches"], batch["tokens"], cfg)
    P = batch["patches"].shape[1]
    logits = L.unembed_fwd(params["embed"], h[:, P:])
    return L.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))


def init_cache(cfg, batch, max_seq, dtype, device=None):
    return T.init_cache(cfg, batch, max_seq, dtype, device)


def cache_logical(cfg):
    return T.cache_logical(cfg)


def prefill(params, patches, tokens, cfg, max_seq):
    """Prompt = patches + text; the cache covers the combined sequence."""
    h = _combine(params, patches, tokens, cfg)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    ks, vs = [], []
    for i in range(T.num_stacked(params["blocks"])):
        bp = T.layer(params["blocks"], i)
        a, (k, v) = L.attention_fwd(
            bp["attn"], L.rmsnorm(h, bp["attn_norm"], cfg.norm_eps), cfg,
            positions=positions)
        h = h + a
        h = h + L.mlp_fwd(bp["mlp"], L.rmsnorm(h, bp["mlp_norm"],
                                               cfg.norm_eps))
        ks.append(k)
        vs.append(v)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = L.unembed_fwd(params["embed"], h[:, -1:])
    ck, cv = T.padded_kv(ks, vs, max_seq)
    return logits, {"k": ck, "v": cv}


def decode_step(params, cache, tokens, pos, cfg):
    return T.decode_step(params, cache, tokens, pos, cfg)

"""Dense decoder-only transformer (llama3 / mistral / qwen family).

The port of ``repro/models/transformer.py``.  The parameter tree is the
reference's: nested dicts with the layer axis stacked first
(``stacked``), so weights carry across name for name.  Where the
reference scans over that axis the port loops over the layers
(``L.unstacked``, or ``layer`` for one), each body through
``L.run_layer`` where the reference remats it.  Decode steps update the
cache in place.

The reference constrains the residual between blocks to ``("batch",
"seq_sp", None)``.  Under a train step's sequence parallelism
(``sharding.TensorParallel.seq``) the residual that arrives there is
already this rank's slice of the sequence: the embedding's lookup ends in
a reduce-scatter onto it, each block's attention and MLP gather their
normed input and reduce-scatter their output (``layers``), and the
``constraint`` calls leave the local tensor as it is.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.distributed.sharding import constraint
from repro_torch.models import layers as L
from repro_torch.models.layers import PD


def block_defs(cfg):
    return {
        "attn_norm": PD((cfg.d_model,), ("embed",), "ones"),
        "attn": L.attention_defs(cfg),
        "mlp_norm": PD((cfg.d_model,), ("embed",), "ones"),
        "mlp": L.mlp_defs(cfg),
    }


def stacked(defs, n):
    return L.tree_map(
        lambda pd: PD((n,) + pd.shape, ("layers",) + pd.logical, pd.init,
                      pd.scale), defs)


def layer(tree, i):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    return L.tree_map(lambda x: x[i], tree)


def num_stacked(tree) -> int:
    """The length of a stacked tree's leading (layer) axis."""
    return L.tree_leaves(tree)[0].shape[0]


def model_defs(cfg):
    return {
        "embed": L.embed_defs(cfg),
        "blocks": stacked(block_defs(cfg), cfg.num_layers),
        "final_norm": PD((cfg.d_model,), ("embed",), "ones"),
    }


def block_fwd(p, h, cfg, positions):
    p = L.fsdp_gather(p, block_defs(cfg))
    a, _ = L.attention_fwd(p["attn"], L.rmsnorm(h, p["attn_norm"],
                                                cfg.norm_eps),
                           cfg, positions=positions)
    h = h + a
    h = constraint(h, ("batch", "seq_sp", None))
    m = L.mlp_fwd(p["mlp"], L.rmsnorm(h, p["mlp_norm"], cfg.norm_eps))
    return constraint(h + m, ("batch", "seq_sp", None))


def _positions(S, device):
    return torch.arange(S, device=device)[None, :]


def forward(params, tokens, cfg):
    """tokens [B,S] -> hidden [B,S,D] (pre-unembed)."""
    h = L.embed_fwd(params["embed"], tokens, cfg.torch_dtype)
    h = constraint(h, ("batch", "seq_sp", None))
    positions = _positions(tokens.shape[1], h.device)
    body = lambda h, bp: block_fwd(bp, h, cfg, positions)
    for bp in L.unstacked(params["blocks"]):
        h = L.run_layer(body, cfg.remat, h, bp)
    return L.rmsnorm(h, params["final_norm"], cfg.norm_eps)


def loss_fn(params, batch, cfg):
    h = forward(params, batch["tokens"], cfg)
    logits = L.unembed_fwd(params["embed"], h)
    return L.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, max_seq, dtype, device=None):
    del dtype  # storage dtype comes from cfg (fp8 KV quantization for MHA)
    cdt = torch_dtype(cfg.cache_dtype)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}


def cache_logical(cfg):
    ax = ("layers", "batch", "seq_kv", "kv_heads", None)
    return {"k": ax, "v": ax}


def padded_kv(k_all, v_all, max_seq):
    """Stacked per-layer K/V [n][B,S,KV,hd] padded with zeros to
    ``max_seq`` positions, in their own (the compute) type."""
    k0 = k_all[0]
    B, S = k0.shape[:2]
    if max_seq < S:
        raise ValueError(f"max_seq = {max_seq} is shorter than the prompt "
                         f"({S} positions)")
    shape = (len(k_all), B, max_seq) + tuple(k0.shape[2:])
    ck = torch.zeros(shape, dtype=k0.dtype, device=k0.device)
    cv = torch.zeros(shape, dtype=k0.dtype, device=k0.device)
    for i, (k, v) in enumerate(zip(k_all, v_all)):
        ck[i, :, :S] = k
        cv[i, :, :S] = v
    return ck, cv


def prefill(params, tokens, cfg, max_seq):
    """Run the full prompt; return (last-position logits, filled cache).
    The cache is in the compute type, zero-padded to ``max_seq``."""
    h = L.embed_fwd(params["embed"], tokens, cfg.torch_dtype)
    positions = _positions(tokens.shape[1], h.device)

    def body(h, bp):
        bp = L.fsdp_gather(bp, block_defs(cfg))
        a, (k, v) = L.attention_fwd(
            bp["attn"], L.rmsnorm(h, bp["attn_norm"], cfg.norm_eps), cfg,
            positions=positions)
        h = h + a
        h = h + L.mlp_fwd(bp["mlp"], L.rmsnorm(h, bp["mlp_norm"],
                                               cfg.norm_eps))
        return constraint(h, ("batch", "seq_sp", None)), k, v

    ks, vs = [], []
    for bp in L.unstacked(params["blocks"]):
        h, k, v = L.run_layer(body, cfg.remat, h, bp)
        ks.append(k)
        vs.append(v)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = L.unembed_fwd(params["embed"], h[:, -1:])
    ck, cv = padded_kv(ks, vs, max_seq)
    return logits, {"k": ck, "v": cv}


def decode_step(params, cache, tokens, pos, cfg):
    """tokens [B,1]; pos an int (current position).  Returns (logits,
    cache), the cache updated in place."""
    h = L.embed_fwd(params["embed"], tokens, cfg.torch_dtype)
    for i in range(num_stacked(params["blocks"])):
        bp = L.fsdp_gather(layer(params["blocks"], i), block_defs(cfg))
        a, _, _ = L.attention_decode(
            bp["attn"], L.rmsnorm(h, bp["attn_norm"], cfg.norm_eps), cfg,
            cache["k"][i], cache["v"][i], pos)
        h = h + a
        h = h + L.mlp_fwd(bp["mlp"], L.rmsnorm(h, bp["mlp_norm"],
                                               cfg.norm_eps))
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = L.unembed_fwd(params["embed"], h)
    return logits, cache

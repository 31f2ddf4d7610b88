"""Whisper-style encoder-decoder backbone.

The port of ``repro/models/encdec.py``.  The conv/mel frontend is stubbed
as in the reference: callers give precomputed frame embeddings
[B, num_frames, d_model].  Positions are sinusoidal for both stacks.
Decoder blocks: causal self-attention (KV cache at serve time) +
cross-attention over the encoder output + MLP.

On a CUDA tensor the encoder's non-causal self-attention and the
decoder's causal self-attention run the flash-attention kernel, and the
cached self-attention of a decode step the flash-decoding kernel
(``layers``).  Cross-attention (Sq != Sk: ``_dec_block`` and ``prefill``
through ``attention_fwd(kv=...)``, ``decode_step`` through
``_exact_attn``) is the plain cross-attention route on every device.

Under a train step's sequence parallelism (``sharding.TensorParallel``)
the decoder's residual is this rank's slice of the token sequence (its
positions' sinusoids with it) and the encoder runs with its residual whole
(``sharding.whole_sequence``): the decoder's cross-attention takes the
encoder's output whole.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import constraint
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import PD


def sinusoid(positions, d_model, dtype):
    half = d_model // 2
    dev = positions.device
    f32 = torch.float32
    step = torch.log(torch.full((), 10000.0, dtype=f32, device=dev)) \
        / max(half - 1, 1)
    freqs = torch.exp(-torch.arange(half, dtype=f32, device=dev) * step)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def enc_block_defs(cfg):
    return {
        "attn_norm": PD((cfg.d_model,), ("embed",), "ones"),
        "attn": L.attention_defs(cfg),
        "mlp_norm": PD((cfg.d_model,), ("embed",), "ones"),
        "mlp": L.mlp_defs(cfg),
    }


def dec_block_defs(cfg):
    return {
        "self_norm": PD((cfg.d_model,), ("embed",), "ones"),
        "self_attn": L.attention_defs(cfg),
        "cross_norm": PD((cfg.d_model,), ("embed",), "ones"),
        "cross_attn": L.attention_defs(cfg),
        "mlp_norm": PD((cfg.d_model,), ("embed",), "ones"),
        "mlp": L.mlp_defs(cfg),
    }


def model_defs(cfg):
    return {
        "embed": L.embed_defs(cfg),
        "enc_blocks": T.stacked(enc_block_defs(cfg), cfg.encoder_layers),
        "enc_norm": PD((cfg.d_model,), ("embed",), "ones"),
        "dec_blocks": T.stacked(dec_block_defs(cfg), cfg.num_layers),
        "final_norm": PD((cfg.d_model,), ("embed",), "ones"),
    }


def _arange(n, device):
    return torch.arange(n, device=device)[None, :]


def encode(params, frames, cfg):
    """frames [B,F,D] (stub embeddings) -> encoder hidden [B,F,D]."""
    dtype = cfg.torch_dtype
    F_ = frames.shape[1]
    positions = _arange(F_, frames.device)
    h = frames.to(dtype) + sinusoid(positions, cfg.d_model, dtype)

    def body(h, bp):
        with shd.whole_sequence():
            bp = L.fsdp_gather(bp, enc_block_defs(cfg))
            a, _ = L.attention_fwd(bp["attn"], L.rmsnorm(h, bp["attn_norm"],
                                                         cfg.norm_eps),
                                   cfg, positions=positions, causal=False)
            h = h + a
            h = h + L.mlp_fwd(bp["mlp"], L.rmsnorm(h, bp["mlp_norm"],
                                                   cfg.norm_eps))
            return constraint(h, ("batch", "seq_sp", None))

    for bp in L.unstacked(params["enc_blocks"]):
        h = L.run_layer(body, cfg.remat, h, bp)
    return L.rmsnorm(h, params["enc_norm"], cfg.norm_eps)


def _dec_block(bp, h, enc_kv, cfg, positions):
    a, _ = L.attention_fwd(bp["self_attn"], L.rmsnorm(h, bp["self_norm"],
                                                      cfg.norm_eps),
                           cfg, positions=positions, causal=True)
    h = h + a
    c, _ = L.attention_fwd(bp["cross_attn"], L.rmsnorm(h, bp["cross_norm"],
                                                       cfg.norm_eps),
                           cfg, positions=positions, kv=enc_kv)
    h = h + c
    h = h + L.mlp_fwd(bp["mlp"], L.rmsnorm(h, bp["mlp_norm"], cfg.norm_eps))
    return constraint(h, ("batch", "seq_sp", None))


def _cross_kv(bp, enc_out, cfg):
    """Precompute cross-attention K/V from encoder output."""
    return L.project_kv(bp["cross_attn"], enc_out, cfg)


def _dec_input(params, tokens, cfg):
    """The decoder's input (this rank's slice of the sequence under
    sequence parallelism) and every position."""
    dtype = cfg.torch_dtype
    h = L.embed_fwd(params["embed"], tokens, dtype)
    positions = _arange(tokens.shape[1], h.device)
    return h + L.local_seq(sinusoid(positions, cfg.d_model, dtype)), \
        positions


def forward(params, frames, tokens, cfg):
    enc_out = encode(params, frames, cfg)
    h, positions = _dec_input(params, tokens, cfg)
    def body(h, bp, enc_out):
        bp = L.fsdp_gather(bp, dec_block_defs(cfg))
        return _dec_block(bp, h, _cross_kv(bp, enc_out, cfg), cfg,
                          positions)

    for bp in L.unstacked(params["dec_blocks"]):
        h = L.run_layer(body, cfg.remat, h, bp, enc_out)
    return L.rmsnorm(h, params["final_norm"], cfg.norm_eps)


def loss_fn(params, batch, cfg):
    h = forward(params, batch["frames"], batch["tokens"], cfg)
    logits = L.unembed_fwd(params["embed"], h)
    return L.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))


def init_cache(cfg, batch, max_seq, dtype, device=None):
    F_ = cfg.num_frames
    cdt = torch_dtype(cfg.cache_dtype)
    kv = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    xkv = (cfg.num_layers, batch, F_, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=cdt, device=device),
        "v": torch.zeros(kv, dtype=cdt, device=device),
        "xk": torch.zeros(xkv, dtype=dtype, device=device),
        "xv": torch.zeros(xkv, dtype=dtype, device=device),
    }


def cache_logical(cfg):
    kv = ("layers", "batch", "seq_kv", "kv_heads", None)
    xkv = ("layers", "batch", None, "kv_heads", None)
    return {"k": kv, "v": kv, "xk": xkv, "xv": xkv}


def prefill(params, frames, tokens, cfg, max_seq):
    """Encode audio + run prompt tokens; returns (logits, cache incl.
    cross-KV)."""
    enc_out = encode(params, frames, cfg)
    h, positions = _dec_input(params, tokens, cfg)
    ks, vs, xks, xvs = [], [], [], []
    for i in range(T.num_stacked(params["dec_blocks"])):
        bp = L.fsdp_gather(T.layer(params["dec_blocks"], i),
                           dec_block_defs(cfg))
        xk, xv = _cross_kv(bp, enc_out, cfg)
        a, (k, v) = L.attention_fwd(
            bp["self_attn"], L.rmsnorm(h, bp["self_norm"], cfg.norm_eps),
            cfg, positions=positions, causal=True)
        h = h + a
        c, _ = L.attention_fwd(bp["cross_attn"],
                               L.rmsnorm(h, bp["cross_norm"], cfg.norm_eps),
                               cfg, positions=positions, kv=(xk, xv))
        h = h + c
        h = h + L.mlp_fwd(bp["mlp"], L.rmsnorm(h, bp["mlp_norm"],
                                               cfg.norm_eps))
        ks.append(k)
        vs.append(v)
        xks.append(xk)
        xvs.append(xv)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = L.unembed_fwd(params["embed"], h[:, -1:])
    ck, cv = T.padded_kv(ks, vs, max_seq)
    return logits, {"k": ck, "v": cv, "xk": torch.stack(xks),
                    "xv": torch.stack(xvs)}


def decode_step(params, cache, tokens, pos, cfg):
    """Returns (logits, cache), the self-attention cache updated in
    place; the cross-attention K/V are read only."""
    dtype = cfg.torch_dtype
    h = L.embed_fwd(params["embed"], tokens, dtype)
    h = h + sinusoid(torch.full((1, 1), pos, dtype=torch.int32,
                                device=h.device), cfg.d_model, dtype)
    for i in range(T.num_stacked(params["dec_blocks"])):
        bp = L.fsdp_gather(T.layer(params["dec_blocks"], i),
                           dec_block_defs(cfg))
        a, _, _ = L.attention_decode(
            bp["self_attn"], L.rmsnorm(h, bp["self_norm"], cfg.norm_eps),
            cfg, cache["k"][i], cache["v"][i], pos)
        h = h + a
        # cross attention against the fixed encoder K/V: the plain route
        h = h + L.attention_cached(
            bp["cross_attn"], L.rmsnorm(h, bp["cross_norm"], cfg.norm_eps),
            cfg, cache["xk"][i], cache["xv"][i])
        h = h + L.mlp_fwd(bp["mlp"], L.rmsnorm(h, bp["mlp_norm"],
                                               cfg.norm_eps))
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.unembed_fwd(params["embed"], h), cache

"""Jamba-style hybrid: Mamba+attention 1:7 interleave with MoE FFNs.

The port of ``repro/models/hybrid.py``.  The layer stack is periodic
(period ``attn_period``): one attention mixer per period (at
``attn_offset``), SSD mixers elsewhere; MoE FFN every ``moe_every``-th
position, dense FFN otherwise.  Parameters are stacked per position of the
period (``periods["pos{i}"]``, the period axis first), as the reference's;
the port loops over periods where the reference scans.  The caches hold
one attention layer's K/V per period and ``conv`` / ``ssm`` states per
Mamba position; decode steps update them in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.layers import PD


def layout(cfg):
    """[(mixer, ffn)] per position in one period."""
    out = []
    for i in range(cfg.attn_period):
        mixer = "attn" if i == cfg.attn_offset else "mamba"
        ffn = "moe" if (cfg.num_experts and i % cfg.moe_every == 1) \
            else "dense"
        out.append((mixer, ffn))
    return out


def _pos_defs(cfg, mixer, ffn):
    d = {"mixer_norm": PD((cfg.d_model,), ("embed",), "ones"),
         "ffn_norm": PD((cfg.d_model,), ("embed",), "ones")}
    d["mixer"] = L.attention_defs(cfg) if mixer == "attn" else S.ssd_defs(cfg)
    d["ffn"] = M.moe_defs(cfg) if ffn == "moe" else L.mlp_defs(cfg)
    return d


def model_defs(cfg):
    n_periods = cfg.num_layers // cfg.attn_period
    periods = {
        f"pos{i}": T.stacked(_pos_defs(cfg, mixer, ffn), n_periods)
        for i, (mixer, ffn) in enumerate(layout(cfg))
    }
    return {
        "embed": L.embed_defs(cfg),
        "periods": periods,
        "final_norm": PD((cfg.d_model,), ("embed",), "ones"),
    }


def _ffn(p, hn, cfg, ffn):
    if ffn == "moe":
        return M.moe_fwd(p["ffn"], hn, cfg)
    return L.mlp_fwd(p["ffn"], hn), None


def _apply_pos(p, h, cfg, mixer, ffn, positions):
    hn = L.rmsnorm(h, p["mixer_norm"], cfg.norm_eps)
    if mixer == "attn":
        a, _ = L.attention_fwd(p["mixer"], hn, cfg, positions=positions)
    else:
        a = S.ssd_block_fwd(p["mixer"], hn, cfg)
    h = h + a
    f, aux = _ffn(p, L.rmsnorm(h, p["ffn_norm"], cfg.norm_eps), cfg, ffn)
    return h + f, aux


def _n_periods(params):
    return T.num_stacked(params["periods"])


def forward(params, tokens, cfg):
    h = L.embed_fwd(params["embed"], tokens, cfg.torch_dtype)
    positions = torch.arange(tokens.shape[1], device=h.device)[None, :]

    def body(h, aux, pp):
        for i, (mixer, ffn) in enumerate(layout(cfg)):
            h, a = _apply_pos(pp[f"pos{i}"], h, cfg, mixer, ffn, positions)
            if a is not None:
                aux = aux + a
        return h, aux

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for pp in L.unstacked(params["periods"]):
        h, aux = L.run_layer(body, cfg.remat, h, aux, pp)
    return L.rmsnorm(h, params["final_norm"], cfg.norm_eps), \
        aux / cfg.num_layers


def loss_fn(params, batch, cfg, aux_weight=0.01):
    h, aux = forward(params, batch["tokens"], cfg)
    logits = L.unembed_fwd(params["embed"], h)
    return L.cross_entropy(logits, batch["labels"],
                           batch.get("loss_mask")) + aux_weight * aux


# ---------------------------------------------------------------------------
# Serving: attention positions carry KV caches; mamba positions carry states
# ---------------------------------------------------------------------------

def _n_mamba(cfg):
    return sum(1 for m, _ in layout(cfg) if m == "mamba")


def init_cache(cfg, batch, max_seq, dtype, device=None):
    n_periods = cfg.num_layers // cfg.attn_period
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    n_mamba = _n_mamba(cfg)
    cdt = torch_dtype(cfg.cache_dtype)
    kv = (n_periods, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=cdt, device=device),
        "v": torch.zeros(kv, dtype=cdt, device=device),
        "conv": torch.zeros(n_periods, n_mamba, batch, S.CONV_K - 1,
                            conv_dim, dtype=dtype, device=device),
        "ssm": torch.zeros(n_periods, n_mamba, batch, cfg.ssm_nheads,
                           cfg.ssm_headdim, cfg.ssm_state,
                           dtype=torch.float32, device=device),
    }


def cache_logical(cfg):
    return {
        "k": ("layers", "batch", "seq_kv", "kv_heads", None),
        "v": ("layers", "batch", "seq_kv", "kv_heads", None),
        "conv": ("layers", None, "batch", None, "ssm_inner"),
        "ssm": ("layers", None, "batch", "ssm_heads", None, None),
    }


def decode_step(params, cache, tokens, pos, cfg):
    """Returns (logits, cache), the caches and states updated in place."""
    h = L.embed_fwd(params["embed"], tokens, cfg.torch_dtype)
    for pi in range(_n_periods(params)):
        pp = T.layer(params["periods"], pi)
        mi = 0
        for i, (mixer, ffn) in enumerate(layout(cfg)):
            p = pp[f"pos{i}"]
            hn = L.rmsnorm(h, p["mixer_norm"], cfg.norm_eps)
            if mixer == "attn":
                a, _, _ = L.attention_decode(p["mixer"], hn, cfg,
                                             cache["k"][pi], cache["v"][pi],
                                             pos)
            else:
                a, c_i, s_i = S.ssd_decode_step(
                    p["mixer"], hn, cfg, cache["conv"][pi, mi],
                    cache["ssm"][pi, mi])
                cache["conv"][pi, mi] = c_i
                cache["ssm"][pi, mi] = s_i
                mi += 1
            h = h + a
            f, _ = _ffn(p, L.rmsnorm(h, p["ffn_norm"], cfg.norm_eps), cfg,
                        ffn)
            h = h + f
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.unembed_fwd(params["embed"], h), cache


def prefill(params, tokens, cfg, max_seq):
    h = L.embed_fwd(params["embed"], tokens, cfg.torch_dtype)
    positions = torch.arange(tokens.shape[1], device=h.device)[None, :]
    B = tokens.shape[0]

    def body(h, pp):
        kv, states = (), []
        for i, (mixer, ffn) in enumerate(layout(cfg)):
            p = pp[f"pos{i}"]
            hn = L.rmsnorm(h, p["mixer_norm"], cfg.norm_eps)
            if mixer == "attn":
                a, kv = L.attention_fwd(p["mixer"], hn, cfg,
                                        positions=positions)
            else:
                a, st = S.ssd_block_fwd(p["mixer"], hn, cfg,
                                        return_state=True)
                states.append(st)
            h = h + a
            f, _ = _ffn(p, L.rmsnorm(h, p["ffn_norm"], cfg.norm_eps), cfg,
                        ffn)
            h = h + f
        return (h, torch.stack(states)) + tuple(kv)

    ks, vs, ssm_all = [], [], []
    for pp in L.unstacked(params["periods"]):
        h, states, *kv = L.run_layer(body, cfg.remat, h, pp)
        if kv:
            ks.append(kv[0])
            vs.append(kv[1])
        ssm_all.append(states)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = L.unembed_fwd(params["embed"], h[:, -1:])
    ck, cv = T.padded_kv(ks, vs, max_seq)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    cache = {
        "k": ck, "v": cv,
        "conv": torch.zeros(len(ssm_all), _n_mamba(cfg), B, S.CONV_K - 1,
                            conv_dim, dtype=cfg.torch_dtype, device=h.device),
        "ssm": torch.stack(ssm_all).float(),
    }
    return logits, cache

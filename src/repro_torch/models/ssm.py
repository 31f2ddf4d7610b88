"""Mamba-2 SSD (state-space duality): the chunked scan, the block and the LM.

The port of ``repro/models/ssm.py``.  ``ssd_chunked`` is the port of
``_ssd_chunked`` (``:51``): quadratic,
attention-like work *within* a chunk and a linear state recurrence *across*
chunks (arXiv:2405.21060 §6), so nothing quadratic in S is ever formed.  It
is the oracle of the SSD scan kernel (``kernels/ssd_scan.py``) through
``kernels/ref.py:ssd_scan``, and the SSD core a Mamba-2 block reuses.

Two choices keep it usable at the suite's size (B 8, S 65,536, H 16, P 64,
N 128): the decay is masked *before* the exponential (above the diagonal
``seg_t - seg_u`` is positive and could overflow to ``inf``; ``inf * 0`` is
NaN), and the intra-chunk product contracts ``(C·Bᵀ) ∘ decay`` over the
chunk first, as the Pallas kernel does, instead of forming the 5-D
``[B, Q, Q, H, P]`` product a three-operand einsum can build (2.1 GB per
chunk at that size).

The block (``ssd_block_fwd``, ``ssd_decode_step``) and the Mamba-2 LM
(mamba2-130m) follow the reference's data flow.  Its prefill runs the
plain ``ssd_chunked`` on every device, as the reference's model calls no
SSD kernel: the port's ``ssd_scan`` kernel returns y alone, and the model
needs the final state.  Like the reference's, the prefill leaves the conv
state at zeros (the last K-1 inputs are not carried out of the prompt).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.layers import PD
from repro_torch.models.transformer import layer, num_stacked, stacked

CONV_K = 4  # depthwise causal conv width


def ssd_defs(cfg):
    D, DI, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    conv_dim = DI + 2 * N
    return {
        "wz": PD((D, DI), ("embed", "ssm_inner")),
        "wx": PD((D, DI), ("embed", "ssm_inner")),
        "wB": PD((D, N), ("embed", None)),
        "wC": PD((D, N), ("embed", None)),
        "wdt": PD((D, H), ("embed", "ssm_heads")),
        "dt_bias": PD((H,), ("ssm_heads",), "zeros"),
        "A_log": PD((H,), ("ssm_heads",), "ones"),
        "D_skip": PD((H,), ("ssm_heads",), "ones"),
        "conv_w": PD((conv_dim, CONV_K), ("ssm_inner", None), scale=0.5),
        "conv_b": PD((conv_dim,), ("ssm_inner",), "zeros"),
        "gate_norm": PD((DI,), ("ssm_inner",), "ones"),
        "wo": PD((DI, D), ("ssm_inner", "embed")),
    }


def _causal_conv(xBC, w, b):
    """Depthwise causal conv, xBC [B,S,C], w [C,K], summed in float32."""
    B, S, C = xBC.shape
    pad = F.pad(xBC, (0, 0, CONV_K - 1, 0))
    out = torch.zeros(B, S, C, dtype=torch.float32, device=xBC.device)
    for k in range(CONV_K):
        out = out + pad[:, k:k + S, :].float() * w[:, k]
    return F.silu(out + b).to(xBC.dtype)


def ssd_chunked(x, dt, A, Bm, Cm, D_skip, chunk: int):
    """SSD core.  x ``[B,S,H,P]``; dt ``[B,S,H]``; A ``[H]``; Bm/Cm
    ``[B,S,N]``; D_skip ``[H]``.

    Returns y ``[B,S,H,P]`` in x's type and the final state ``[B,H,P,N]``
    in float32.  Every input is widened to float32.  ``Q = min(chunk, S)``
    and ``S % Q`` must be 0.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"ssd_chunked: S = {S} is not a multiple of the "
                         f"chunk length Q = min({chunk}, S)")
    nc = S // Q
    f32 = torch.float32
    dev = x.device

    dA = dt.to(f32) * A.to(f32)                               # [B,S,H] (negative)
    xd = x.to(f32) * dt.to(f32)[..., None]                    # dt-weighted input
    Bf, Cf = Bm.to(f32), Cm.to(f32)
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=dev))

    state = torch.zeros(Bsz, H, P, N, dtype=f32, device=dev)
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xq, Bq, Cq = xd[:, sl], Bf[:, sl], Cf[:, sl]          # [B,Q,H,P], [B,Q,N]
        seg = torch.cumsum(dA[:, sl], dim=1)                  # [B,Q,H]
        # intra-chunk: scores[t,u] = (C_t.B_u) * exp(seg_t - seg_u) for u<=t
        diff = seg[:, :, None] - seg[:, None, :, :]           # [B,Q,Q,H]
        diff = diff.masked_fill(~tri[None, :, :, None], float("-inf"))
        decay = torch.exp(diff)                               # mask pre-exp
        cb = torch.einsum("btn,bun->btu", Cq, Bq)             # [B,Q,Q]
        w = cb[..., None] * decay                             # [B,Q,Q,H]
        y_intra = torch.einsum("btuh,buhp->bthp", w, xq)
        # contribution of the carried-in state: exp(seg_t) * C_t . state
        y_state = torch.einsum("btn,bhpn->bthp", Cq, state) \
            * torch.exp(seg)[..., None]
        # chunk end state: exp(seg_Q) * state + sum_u exp(seg_Q-seg_u) B_u x_u
        tot = seg[:, -1]                                      # [B,H]
        sdecay = torch.exp(tot[:, None] - seg)                # [B,Q,H]
        state = (torch.exp(tot)[:, :, None, None] * state
                 + torch.einsum("bun,buhp->bhpn", Bq,
                                xq * sdecay[..., None]))
        ys.append(y_intra + y_state)
    y = torch.cat(ys, dim=1)
    y = y + x.to(f32) * D_skip.to(f32)[None, None, :, None]
    return y.to(x.dtype), state


def ssd_block_fwd(p, h, cfg, return_state=False):
    """Full-sequence SSD block. h [B,S,D] -> [B,S,D] (and the final state
    [B,H,P,N] in float32 with ``return_state``)."""
    B, S, D = h.shape
    DI, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    P = cfg.ssm_headdim
    z = h @ p["wz"]
    xBC = torch.cat([h @ p["wx"], h @ p["wB"], h @ p["wC"]], dim=-1)
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    x, Bm, Cm = torch.split(xBC, [DI, N, N], dim=-1)
    dt = F.softplus((h @ p["wdt"]).float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    x = x.reshape(B, S, H, P)
    y, final_state = ssd_chunked(x, dt, A, Bm, Cm, p["D_skip"],
                                 cfg.ssm_chunk)
    y = y.reshape(B, S, DI)
    y = L.rmsnorm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = y @ p["wo"]
    if return_state:
        return out, final_state
    return out


def ssd_decode_step(p, h, cfg, conv_state, ssm_state):
    """Single-token recurrent update.

    h [B,1,D]; conv_state [B,K-1,conv_dim]; ssm_state [B,H,P,N] (fp32).
    Returns (out, the new conv state, the new ssm state).
    """
    B = h.shape[0]
    DI, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    f32 = torch.float32
    z = h @ p["wz"]
    xBC_new = torch.cat([h @ p["wx"], h @ p["wB"], h @ p["wC"]], dim=-1)
    window = torch.cat([conv_state, xBC_new], dim=1)              # [B,K,C]
    conv_out = (window.float() * p["conv_w"].T[None]).sum(1) + p["conv_b"]
    xBC = F.silu(conv_out).to(h.dtype)                           # [B,C]
    x, Bm, Cm = torch.split(xBC, [DI, N, N], dim=-1)
    dt = F.softplus((h[:, 0] @ p["wdt"]).float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    x = x.reshape(B, H, P).to(f32)
    dA = torch.exp(dt * A)                                        # [B,H]
    dBx = torch.einsum("bn,bhp->bhpn", Bm.to(f32), x * dt[..., None])
    ssm_state = ssm_state * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", ssm_state, Cm.to(f32))
    y = y + x * p["D_skip"].to(f32)[None, :, None]
    y = y.reshape(B, 1, DI).to(h.dtype)
    y = L.rmsnorm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["wo"], window[:, 1:], ssm_state


# ---------------------------------------------------------------------------
# Mamba-2 LM (mamba2-130m)
# ---------------------------------------------------------------------------

def block_defs(cfg):
    return {"norm": PD((cfg.d_model,), ("embed",), "ones"),
            "ssd": ssd_defs(cfg)}


def model_defs(cfg):
    return {
        "embed": L.embed_defs(cfg),
        "blocks": stacked(block_defs(cfg), cfg.num_layers),
        "final_norm": PD((cfg.d_model,), ("embed",), "ones"),
    }


def forward(params, tokens, cfg):
    h = L.embed_fwd(params["embed"], tokens, cfg.torch_dtype)
    body = lambda h, bp: h + ssd_block_fwd(
        bp["ssd"], L.rmsnorm(h, bp["norm"], cfg.norm_eps), cfg)
    for bp in L.unstacked(params["blocks"]):
        h = L.run_layer(body, cfg.remat, h, bp)
    return L.rmsnorm(h, params["final_norm"], cfg.norm_eps)


def loss_fn(params, batch, cfg):
    h = forward(params, batch["tokens"], cfg)
    logits = L.unembed_fwd(params["embed"], h)
    return L.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))


def init_cache(cfg, batch, max_seq, dtype, device=None):
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros(cfg.num_layers, batch, CONV_K - 1, conv_dim,
                            dtype=dtype, device=device),
        "ssm": torch.zeros(cfg.num_layers, batch, cfg.ssm_nheads,
                           cfg.ssm_headdim, cfg.ssm_state,
                           dtype=torch.float32, device=device),
    }


def cache_logical(cfg):
    return {
        "conv": ("layers", "batch", None, "ssm_inner"),
        "ssm": ("layers", "batch", "ssm_heads", None, None),
    }


def decode_step(params, cache, tokens, pos, cfg):
    """Returns (logits, cache), the cache's states updated in place."""
    del pos  # SSM state is position-free
    h = L.embed_fwd(params["embed"], tokens, cfg.torch_dtype)
    for i in range(num_stacked(params["blocks"])):
        bp = layer(params["blocks"], i)
        y, conv, ssm = ssd_decode_step(
            bp["ssd"], L.rmsnorm(h, bp["norm"], cfg.norm_eps), cfg,
            cache["conv"][i], cache["ssm"][i])
        cache["conv"][i] = conv
        cache["ssm"][i] = ssm
        h = h + y
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.unembed_fwd(params["embed"], h), cache


def prefill(params, tokens, cfg, max_seq):
    """Run the prompt through the SSD blocks, returning the final recurrent
    states (the conv state left at zeros, as the reference leaves it)."""
    del max_seq  # state is O(1); no KV growth
    h = L.embed_fwd(params["embed"], tokens, cfg.torch_dtype)
    states = []
    for i in range(num_stacked(params["blocks"])):
        bp = layer(params["blocks"], i)
        y, state = ssd_block_fwd(
            bp["ssd"], L.rmsnorm(h, bp["norm"], cfg.norm_eps), cfg,
            return_state=True)
        h = h + y
        states.append(state)
    hn = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = L.unembed_fwd(params["embed"], hn[:, -1:])
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    cache = {
        "conv": torch.zeros(len(states), tokens.shape[0], CONV_K - 1,
                            conv_dim, dtype=cfg.torch_dtype,
                            device=h.device),
        "ssm": torch.stack(states).float(),
    }
    return logits, cache

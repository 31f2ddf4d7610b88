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

Under tensor parallelism (``sharding.TensorParallel.ssm_inner``) the SSD
heads go over "model", as GSPMD splits the reference's "ssm_heads" /
"ssm_inner" axes: wz, wx and wdt are column-parallel, wB and wC whole; a
rank computes the heads its d_inner columns fall in (``_ssd_heads``: its
own where they are whole heads, else the heads its columns share with its
neighbours, x's columns all-gathered); the conv runs on those heads' x
channels and on B's and C's (conv_w / conv_b gathered whole, since their
"ssm_inner" shards are chunks of the ``d_inner + 2N`` rows that do not
line up with the heads); dt_bias, A_log and D_skip are the rank's heads
(picked from the whole where "ssm_heads" does not divide); the gated
RMSNorm over d_inner takes its sum of squares added over "model"; wo is
row-parallel (``layers.to_residual``).  Under a train step's sequence
parallelism the normed input is gathered on the sequence first.  The
decode step keeps the ``ssm`` cache's heads local where they are whole;
where they are not, and for the ``conv`` cache, a rank's own columns of the
new states are all-gathered into the whole state (``_whole_channels``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import constraint
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


class _Heads(NamedTuple):
    """A rank's SSD heads under tensor parallelism: heads ``lo`` to ``lo +
    n``, of whose channels [``first``, ``first + c``) are its own d_inner
    columns, ``part`` where those are not whole heads; ``tp`` None (every
    head, every column) without it."""
    lo: int
    n: int
    first: int
    c: int
    part: bool
    tp: Optional[shd.TensorParallel]


def _ssd_heads(cfg) -> _Heads:
    DI, P = cfg.d_inner, cfg.ssm_headdim
    tp = shd.active_tp()
    if tp is None or not tp.ssm_inner:
        return _Heads(0, cfg.ssm_nheads, 0, DI, False, None)
    c = DI // tp.n
    lo = tp.rank * c // P
    n = -(-(tp.rank + 1) * c // P) - lo
    return _Heads(lo, n, tp.rank * c - lo * P, c, n * P != c, tp)


def _own(v, hs: _Heads, dim: int):
    """A per-head weight at the rank's heads: as it is where it holds those
    alone (its "ssm_heads" shard), else their slice of the whole."""
    return v if v.shape[dim] == hs.n else v.narrow(dim, hs.lo, hs.n)


def _conv_channels(t, cfg, hs: _Heads, dim: int):
    """``t``'s conv channels along ``dim`` (x's d_inner, then B's and C's)
    at the rank's heads' x channels and B's and C's."""
    P, DI = cfg.ssm_headdim, cfg.d_inner
    return torch.cat([t.narrow(dim, hs.lo * P, hs.n * P),
                      t.narrow(dim, DI, t.shape[dim] - DI)], dim=dim)


def _conv_params(p, cfg, hs: _Heads):
    """conv_w / conv_b at the rank's channels (``_conv_channels``; the
    weights all-gathered whole first where they are "ssm_inner" shards)."""
    w, b = p["conv_w"], p["conv_b"]
    if hs.tp is None:
        return w, b
    if w.shape[0] != cfg.d_inner + 2 * cfg.ssm_state:
        w = collectives.all_gather(w, 0, hs.tp.group)
        b = collectives.all_gather(b, 0, hs.tp.group)
    return _conv_channels(w, cfg, hs, 0), _conv_channels(b, cfg, hs, 0)


def _project_x(p, h, cfg, hs: _Heads):
    """x = h @ wx at the rank's heads' channels (its columns all-gathered
    where they are not whole heads)."""
    x = h @ p["wx"]
    if hs.part:
        x = collectives.all_gather(x, -1, hs.tp.group)
        P = cfg.ssm_headdim
        x = x[..., hs.lo * P:(hs.lo + hs.n) * P]
    return x


def _gated_norm(y, z, w, cfg, hs: _Heads):
    """The gated RMSNorm over d_inner of y [B,S,heads' channels] gated by
    z: under tensor parallelism on the rank's own columns, the sum of
    squares added over "model"."""
    if hs.tp is None:
        return L.rmsnorm(y * F.silu(z), w, cfg.norm_eps)
    if hs.part:
        y = y[..., hs.first:hs.first + hs.c]
    g = y * F.silu(z)
    x32 = g.float()
    ss = (x32 * x32).sum(-1, keepdim=True)
    ss = collectives.psum(ss, hs.tp.group) if L.recording(ss) \
        else collectives._all_reduce_(ss, hs.tp.group)
    rms = torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
    return (x32 * rms).to(g.dtype) * w


def _whole_channels(x, cfg, hs: _Heads, dim: int):
    """The whole d_inner channels along ``dim`` of a state computed at the
    rank's heads' channels: its own columns all-gathered over "model"."""
    return collectives._all_gather(
        x.narrow(dim, hs.first, hs.c).contiguous(), dim, hs.tp.group)


def ssd_block_fwd(p, h, cfg, return_state=False):
    """Full-sequence SSD block. h [B,S,D] -> [B,S,D] (and the final state
    [B,H,P,N] in float32 with ``return_state``).  Under tensor parallelism
    on the rank's heads (module docstring): the final state is its heads'
    where they are whole (its "ssm_heads" shard of the cache), else every
    head's."""
    h = L.gather_seq(h)
    B, S, D = h.shape
    N, P = cfg.ssm_state, cfg.ssm_headdim
    hs = _ssd_heads(cfg)
    z = h @ p["wz"]
    xBC = torch.cat([_project_x(p, h, cfg, hs), h @ p["wB"], h @ p["wC"]],
                    dim=-1)
    xBC = _causal_conv(xBC, *_conv_params(p, cfg, hs))
    x, Bm, Cm = torch.split(xBC, [hs.n * P, N, N], dim=-1)
    dt = F.softplus((h @ _own(p["wdt"], hs, 1)).float()
                    + _own(p["dt_bias"], hs, 0).float())
    A = -torch.exp(_own(p["A_log"], hs, 0).float())
    x = constraint(x.reshape(B, S, hs.n, P),
                   ("batch", None, "ssm_heads", None))
    y, final_state = ssd_chunked(x, dt, A, Bm, Cm, _own(p["D_skip"], hs, 0),
                                 cfg.ssm_chunk)
    y = _gated_norm(y.reshape(B, S, hs.n * P), z, p["gate_norm"], cfg, hs)
    out = L.to_residual(y @ p["wo"], hs.tp is not None)
    if return_state:
        if hs.part:
            final_state = _whole_channels(
                final_state.reshape(B, hs.n * P, N), cfg, hs, 1) \
                .reshape(B, cfg.ssm_nheads, P, N)
        return out, final_state
    return out


def ssd_decode_step(p, h, cfg, conv_state, ssm_state):
    """Single-token recurrent update.

    h [B,1,D]; conv_state [B,K-1,conv_dim]; ssm_state [B,H,P,N] (fp32).
    Returns (out, the new conv state, the new ssm state).  Under tensor
    parallelism on the rank's heads: ``conv_state`` whole, ``ssm_state``
    its heads' where they are whole, else whole, each new state returned
    in the layout it came in.
    """
    B = h.shape[0]
    N, P = cfg.ssm_state, cfg.ssm_headdim
    f32 = torch.float32
    hs = _ssd_heads(cfg)
    z = h @ p["wz"]
    xBC_new = torch.cat([_project_x(p, h, cfg, hs), h @ p["wB"],
                         h @ p["wC"]], dim=-1)
    conv_w, conv_b = _conv_params(p, cfg, hs)
    if hs.tp is not None:
        conv_state = _conv_channels(conv_state, cfg, hs, 2)
    window = torch.cat([conv_state, xBC_new], dim=1)              # [B,K,C]
    conv_out = (window.float() * conv_w.T[None]).sum(1) + conv_b
    xBC = F.silu(conv_out).to(h.dtype)                           # [B,C]
    x, Bm, Cm = torch.split(xBC, [hs.n * P, N, N], dim=-1)
    dt = F.softplus((h[:, 0] @ _own(p["wdt"], hs, 1)).float()
                    + _own(p["dt_bias"], hs, 0).float())
    A = -torch.exp(_own(p["A_log"], hs, 0).float())
    x = x.reshape(B, hs.n, P).to(f32)
    dA = torch.exp(dt * A)                                        # [B,H]
    dBx = torch.einsum("bn,bhp->bhpn", Bm.to(f32), x * dt[..., None])
    state = _own(ssm_state, hs, 1) * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", state, Cm.to(f32))
    y = y + x * _own(p["D_skip"], hs, 0).to(f32)[None, :, None]
    y = y.reshape(B, 1, hs.n * P).to(h.dtype)
    y = _gated_norm(y, z, p["gate_norm"], cfg, hs)
    new_conv = window[:, 1:]
    if hs.tp is not None:
        new_conv = torch.cat([
            _whole_channels(new_conv[..., :hs.n * P], cfg, hs, 2),
            new_conv[..., hs.n * P:]], dim=-1)
        if ssm_state.shape[1] != hs.n:       # the cache's every head
            state = _whole_channels(state.reshape(B, hs.n * P, N), cfg, hs,
                                    1).reshape(ssm_state.shape)
    return L.to_residual(y @ p["wo"], hs.tp is not None), new_conv, state


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
    def body(h, bp):
        bp = L.fsdp_gather(bp, block_defs(cfg))
        return h + ssd_block_fwd(bp["ssd"], L.rmsnorm(h, bp["norm"],
                                                      cfg.norm_eps), cfg)

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
        bp = L.fsdp_gather(layer(params["blocks"], i), block_defs(cfg))
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
        bp = L.fsdp_gather(layer(params["blocks"], i), block_defs(cfg))
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

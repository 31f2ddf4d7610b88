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

Both scatter-adds of the dispatch are gathers in a fixed order, so a call
gives the same bits on every run on the card (CUDA's ``index_add_`` adds
by atomics, in an order that changes from run to run): the combine sums
each token's kept slots in ascending slot order from 0.0 (``_SlotSum``:
the order in which the reference's CPU scatter ``out.at[buf_src].add``
adds them, so the sum is its own), and the dispatch gather's backward
sums each token's slots' gradients the same way (``_SlotGather``).  Both
read the slots through ``inv`` [T, top_k], each token's slots sorted, a
dropped choice pointing at a zero row past the buffer.

Under a mesh ``moe_fwd`` runs the reference's ``shard_map`` branch
(``moe.py:104-163``) on local tensors: dispatch is local to each data shard
(capacity from the shard's tokens), then expert parallelism (an
all-to-all over "model" out to the experts' ranks and back) where the
experts divide the model axis, else expert-TP (a d_ff shard of every
expert, the partial outputs summed over "model").  The tokens are first
brought to the reference's partition (batch over the data axes, sequence
over "model" under EP) from the step's layout, and back after, so every
mesh drops the tokens the reference's sharded dispatch drops; a train
step's sequence-parallel residual is that partition under EP already.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import constraint
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
    # each token's slots in ascending order, a dropped choice's E*C last
    slot_of = torch.empty_like(slot)
    slot_of[order] = slot
    inv = slot_of.reshape(T_, K).sort(dim=-1).values
    xe = _SlotGather.apply(x, buf_tok, inv).reshape(E, C, D)      # [E,C,D]

    buf_w = torch.zeros(E * C + 1, dtype=flat_w.dtype, device=dev)
    buf_w[slot] = torch.where(keep, sw, 0.0)
    buf_w = buf_w[:E * C]
    buf_src = torch.full((E * C + 1,), T_, dtype=torch.long, device=dev)
    buf_src[slot] = torch.where(keep, st, T_)
    buf_src = buf_src[:E * C]

    combine = functools.partial(_combine, inv=inv, src=buf_src,
                                weights=buf_w, dtype=x.dtype)
    return xe, combine, aux


def _combine(ye, inv, src, weights, dtype):
    """The experts' rows ``ye`` [E, C, D] weighted and summed into their
    tokens in float32 (``_SlotSum``), in ``dtype``."""
    upd = ye.reshape(-1, ye.shape[-1]).float() * weights[:, None]
    return _SlotSum.apply(upd, inv, src).to(dtype)


def slot_sum(rows, inv):
    """out[t] = 0.0 + rows[inv[t, 0]] + rows[inv[t, 1]] + ..., added in
    that order in ``rows``' type; an index of ``len(rows)`` reads zeros.
    rows [N, D], inv [T, K] -> [T, D]."""
    pad = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])
    out = rows.new_zeros(inv.shape[0], rows.shape[1])
    for k in range(inv.shape[1]):
        out = out + pad[inv[:, k]]
    return out


class _SlotSum(torch.autograd.Function):
    """The combine's sum of each token's slots (``slot_sum``).  Its
    backward hands each slot its token's gradient (``src``: the slot's
    token, ``T`` for an empty slot, which gets zeros): a gather."""

    @staticmethod
    def forward(ctx, rows, inv, src):
        ctx.save_for_backward(src)
        return slot_sum(rows, inv)

    @staticmethod
    def backward(ctx, dout):
        src, = ctx.saved_tensors
        pad = torch.cat([dout, dout.new_zeros(1, dout.shape[1])])
        return pad[src], None, None


class _SlotGather(torch.autograd.Function):
    """``x[tok]``, the dispatch gather.  Its backward sums each token's
    slots' gradients in ascending slot order (``slot_sum`` through
    ``inv``), where autograd's scatter-add would add by atomics on the
    card.  An empty slot reads token 0 and its gradient is zero (its
    combine weight is 0), so it is left out of the sum."""

    @staticmethod
    def forward(ctx, x, tok, inv):
        ctx.save_for_backward(inv)
        return x[tok]

    @staticmethod
    def backward(ctx, dxe):
        inv, = ctx.saved_tensors
        return slot_sum(dxe, inv), None, None


def _expert_ffn(xe, w1, w3, w2):
    g = F.silu(torch.einsum("ecd,edf->ecf", xe, w1))
    g = g * torch.einsum("ecd,edf->ecf", xe, w3)
    return torch.einsum("ecf,efd->ecd", g, w2)


def moe_fwd(p, h, cfg):
    """h [B,S,D] -> ([B,S,D], aux_loss).  Without a mesh: the dispatch of
    all B*S tokens on this device.  Under a mesh: ``h`` is this rank's
    slice of the batch (split over ``sharding.active_batch_axes()``) and
    the reference's ``shard_map`` branch runs (``_moe_sharded``)."""
    mesh = shd.active_mesh()
    if mesh is not None:
        return _moe_sharded(p, h, cfg, mesh)
    B, S, D = h.shape
    xe, combine, aux = _dispatch(h.reshape(B * S, D), p["router"], cfg,
                                 capacity(B * S, cfg))
    out = combine(_expert_ffn(xe, p["w1"], p["w3"], p["w2"]))
    return out.reshape(B, S, D), aux


def _model_part(w, dim, whole, mesh):
    """This rank's part of an expert weight along ``dim`` over "model":
    ``w`` as it is where it is that part already (``layers.fsdp_gather``
    keeps the expert weights' shards over "model"), else its slice of the
    whole (a direct caller's weights)."""
    if w.shape[dim] != whole:
        return w
    n = whole // mesh.size("model")
    return w.narrow(dim, mesh.coord("model") * n, n)


def _moe_sharded(p, h, cfg, mesh):
    """The reference's ``shard_map`` body on local tensors.  The expert
    weights are this rank's experts (EP) or its d_ff shard of each
    (expert-TP), or whole, and then sliced here (``_model_part``).  Under
    a train step's sequence parallelism ``h`` is this rank's slice of the
    sequence: under EP that is the reference's partition already, under
    expert-TP it is all-gathered whole and the output sliced back."""
    have = shd.active_batch_axes()           # axes h's batch is split over
    tp = shd.active_tp()
    seq_in = tp is not None and tp.seq       # h: this rank's sequence slice
    B = h.shape[0] * mesh.size(have)         # the global batch
    S = h.shape[1] * (tp.n if seq_in else 1)  # the whole sequence
    D = h.shape[2]
    dp = C._dp_axes(mesh, B)
    ep = mesh.size("model")
    use_ep = cfg.num_experts % ep == 0
    seq_model = use_ep and S % ep == 0
    # from the step's layout to the reference's partition: batch over dp,
    # and under EP the sequence over "model"
    extra = tuple(a for a in have if a not in dp)
    hl = h
    for a in reversed(extra):                # undo the split past dp
        hl = C.all_gather(hl, 0, mesh.group(a))
    missing = tuple(a for a in dp if a not in have)
    if missing:                              # a caller's whole batch
        hl = shd.Sharding(mesh, (missing,)).local(hl)
    if seq_in and not seq_model:
        hl = C.all_gather(hl, 1, mesh.group("model"))
    elif seq_model and not seq_in:
        hl = shd.Sharding(mesh, (None, "model")).local(hl)
    Bl, Sl = hl.shape[0], hl.shape[1]
    T_local = Bl * Sl
    C_ = capacity(T_local, cfg)
    E = cfg.num_experts
    group = mesh.group("model")
    if use_ep:
        ne = E // ep
        w1, w3, w2 = (_model_part(p[n], 0, E, mesh)
                      for n in ("w1", "w3", "w2"))
    else:            # w1/w3 [E, D, F] and w2 [E, F, D]: this rank's F
        w1, w3 = (_model_part(p[n], 2, cfg.d_ff, mesh) for n in ("w1", "w3"))
        w2 = _model_part(p["w2"], 1, cfg.d_ff, mesh)
    xe, combine, aux = _dispatch(hl.reshape(T_local, D), p["router"], cfg, C_)
    if use_ep:
        # [E, C, D] -> [E/ep, ep*C, D]: capacity buckets travel to experts
        xe = C.all_to_all(xe, group).reshape(ep, ne, C_, D) \
            .transpose(0, 1).reshape(ne, ep * C_, D)
        ye = _expert_ffn(xe, w1, w3, w2)
        ye = ye.reshape(ne, ep, C_, D).transpose(0, 1).contiguous()
        ye = C.all_to_all(ye, group).reshape(E, C_, D)
    else:
        ye = C.psum(_expert_ffn(xe, w1, w3, w2), group)
    out = combine(ye).reshape(Bl, Sl, D)
    for a in dp:
        aux = C.pmean(aux, mesh.group(a))
    if seq_model:
        aux = C.pmean(aux, group)
    # back to the step's layout
    if seq_model and not seq_in:
        out = C.all_gather(out, 1, group)
    elif seq_in and not seq_model:
        out = out.narrow(1, mesh.coord("model") * (S // ep), S // ep)
    for a in reversed(missing):
        out = C.all_gather(out, 0, mesh.group(a))
    if extra:
        out = shd.Sharding(mesh, (extra,)).local(out)
    return out, aux


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
    p = L.fsdp_gather(p, block_defs(cfg))
    a, _ = L.attention_fwd(p["attn"], L.rmsnorm(h, p["attn_norm"],
                                                cfg.norm_eps),
                           cfg, positions=positions)
    h = h + a
    m, aux = moe_fwd(p["moe"], L.rmsnorm(h, p["mlp_norm"], cfg.norm_eps),
                     cfg)
    return constraint(h + m, ("batch", "seq_sp", None)), aux


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
        bp = L.fsdp_gather(T.layer(params["blocks"], i), block_defs(cfg))
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
        bp = L.fsdp_gather(T.layer(params["blocks"], i), block_defs(cfg))
        a, (k, v) = L.attention_fwd(
            bp["attn"], L.rmsnorm(h, bp["attn_norm"], cfg.norm_eps), cfg,
            positions=positions)
        h = h + a
        m, _ = moe_fwd(bp["moe"], L.rmsnorm(h, bp["mlp_norm"], cfg.norm_eps),
                       cfg)
        h = constraint(h + m, ("batch", "seq_sp", None))
        ks.append(k)
        vs.append(v)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = L.unembed_fwd(params["embed"], h[:, -1:])
    ck, cv = T.padded_kv(ks, vs, max_seq)
    return logits, {"k": ck, "v": cv}

"""The forward pass of the dense and MoE decoders the configurations
define, in plain PyTorch.

The architecture, as the program's configurations define it (and as each
configuration file records its departures from the published model):
pre-norm blocks ``h + attn(rms(h)) ; h + ffn(rms(h))``, RMSNorm
``x / sqrt(mean(x^2) + eps) * g``, rotary embeddings on the two halves of
each head (``theta ** (-i / (D/2))``), causal grouped-query attention
scaled by ``D ** -0.5`` (optional q / k / v biases), a SwiGLU MLP
``(silu(x W1) * (x W3)) W2``, or a mixture of experts: a softmax router,
the top-k experts with their weights renormalised to sum to 1, each
expert keeping at most ``capacity`` of the tokens that chose it in token
order (Switch-style, the rest dropped), the kept outputs summed by their
weights; an unembedding over the vocabulary rounded up to 128, its own
matrix or the embedding table's transpose (tied).

Weights are the benchmark's tree (``yardstick.weights``), read in float32.
``Prec`` says how products are computed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CAPACITY_FACTOR = 1.25
CAPACITY_ROUND = 64


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude onto 448), back in float32.  The rounding passes the
    gradient through unchanged (a straight-through estimator), so a
    backward takes its products with the rounded operands and keeps its
    gradients in float32."""
    with torch.no_grad():
        s = 448.0 / x.abs().amax().clamp_min(1e-30)
        r = (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s
    return x + (r - x).detach() if x.requires_grad else r


class Prec:
    """``fp32``: products in float32 (TF32 off); ``fp8``: each product's
    operands rounded to float8 e4m3 first, accumulated in float32."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(mode)
        self.mode = mode

    def op(self, x):
        return q8(x) if self.mode == "fp8" else x

    def mm(self, x, w):
        return self.op(x) @ self.op(w)

    def einsum(self, spec, a, b):
        return torch.einsum(spec, self.op(a), self.op(b))


def f32(x):
    return x.to(torch.float32)


def rmsnorm(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * f32(g)


def rope(x, positions, theta):
    """x [B,S,heads,D]; positions [S]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) / half)
    ang = (positions.to(torch.float64)[:, None] * freqs).to(torch.float32)
    c, s = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(p, x, a, prec):
    """Causal grouped-query self-attention of x [B,S,D]; p one layer's."""
    B, S, _ = x.shape
    H, KV, hd = a["num_heads"], a["num_kv_heads"], a["head_dim"]
    q = prec.mm(x, f32(p["wq"]))
    k = prec.mm(x, f32(p["wk"]))
    v = prec.mm(x, f32(p["wv"]))
    if "bq" in p:
        q, k, v = q + f32(p["bq"]), k + f32(p["bk"]), v + f32(p["bv"])
    pos = torch.arange(S, device=x.device)
    theta = a.get("rope_theta", 10000.0)
    q = rope(q.reshape(B, S, H, hd), pos, theta)
    k = rope(k.reshape(B, S, KV, hd), pos, theta)
    v = v.reshape(B, S, KV, hd)
    g = H // KV
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    outs = []
    for b in range(B):
        per_head = []
        for j in range(KV):
            qj = q[b, :, j * g:(j + 1) * g].transpose(0, 1)     # [g,S,hd]
            s = prec.einsum("hqd,kd->hqk", qj, k[b, :, j]) * hd ** -0.5
            s = s.masked_fill(~mask, float("-inf"))
            pr = torch.softmax(s, dim=-1)
            per_head.append(prec.einsum("hqk,kd->qhd", pr, v[b, :, j]))
        outs.append(torch.cat(per_head, dim=1))                 # [S,H,hd]
    o = torch.stack(outs).reshape(B, S, H * hd)
    return prec.mm(o, f32(p["wo"]))


def mlp(p, x, prec):
    return prec.mm(F.silu(prec.mm(x, f32(p["w1"]))) * prec.mm(x, f32(p["w3"])),
                   f32(p["w2"]))


def capacity(tokens: int, a: dict) -> int:
    c = int(tokens * a["experts_per_token"] / a["num_experts"]
            * CAPACITY_FACTOR)
    return max(CAPACITY_ROUND, -(-c // CAPACITY_ROUND) * CAPACITY_ROUND)


def moe(p, x, a, prec):
    """Returns (output [B,S,D], the Switch load-balance term)."""
    B, S, D = x.shape
    E, K = a["num_experts"], a["experts_per_token"]
    xt = x.reshape(B * S, D)
    T = xt.shape[0]
    probs = torch.softmax(prec.mm(xt, f32(p["router"])), dim=-1)
    top_w, top_e = torch.topk(probs, K, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    chose = torch.zeros(T, E, dtype=torch.int64, device=x.device)
    chose.scatter_(1, top_e, 1)
    aux = E * torch.sum(probs.mean(0) * chose.sum(0).float() / (T * K))
    # each choice's place among the tokens that chose its expert, in token
    # order; kept below the capacity
    rank = torch.cumsum(chose, 0) - 1
    keep = torch.gather(rank, 1, top_e) < capacity(T, a)
    out = torch.zeros_like(xt)
    for e in range(E):
        hit = (top_e == e) & keep
        tok = hit.any(-1).nonzero().squeeze(1)
        if tok.numel() == 0:
            continue
        w = (top_w * hit).sum(-1)[tok]
        xe = xt[tok]
        y = prec.mm(F.silu(prec.mm(xe, f32(p["w1"][e])))
                    * prec.mm(xe, f32(p["w3"][e])), f32(p["w2"][e]))
        out = out.index_add(0, tok, y * w[:, None])
    return out.reshape(B, S, D), aux


def layer_params(blocks: dict, i: int) -> dict:
    return {k: (layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in blocks.items()}


def block(p, h, a, prec):
    """One block; returns (h, load-balance term or 0)."""
    eps = a.get("norm_eps", 1e-5)
    h = h + attention(p["attn"], rmsnorm(h, p["attn_norm"], eps), a, prec)
    x = rmsnorm(h, p["mlp_norm"], eps)
    if "moe" in p:
        m, aux = moe(p["moe"], x, a, prec)
        return h + m, aux
    return h + mlp(p["mlp"], x, prec), h.new_zeros(())


def embed(tree, tokens):
    return f32(tree["embed"]["embedding"])[tokens.long()]


def unembed_matrix(tree):
    e = tree["embed"]
    return f32(e["unembed"]) if "unembed" in e else f32(e["embedding"]).T


@torch.no_grad()
def last_logits(tree, tokens, a, prec) -> torch.Tensor:
    """The last position's logits [B, V] (float32) of a forward over
    tokens [B, S], layer by layer."""
    h = embed(tree, tokens)
    for i in range(a["num_layers"]):
        h, _ = block(layer_params(tree["blocks"], i), h, a, prec)
    x = rmsnorm(h[:, -1], tree["final_norm"], a.get("norm_eps", 1e-5))
    return prec.mm(x, unembed_matrix(tree))

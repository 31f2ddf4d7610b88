"""FLOP and byte counts of the work a cell's inputs need, written for the
benchmark from the architecture's equations (not the program's counters).

``arch`` is a configuration file's ``program`` object (the widths the
program runs).  A causal attention of ``n`` positions keeps ``n(n+1)/2``
pairs a head.  Recomputation (remat) is never counted: these are model
FLOPs, the work the step needs, not the work the program chooses to do.
"""
from __future__ import annotations


def padded_vocab(a: dict) -> int:
    """The vocabulary as the model computes it: rounded up to 128."""
    return -(-a["vocab_size"] // 128) * 128


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def attn_params(a: dict) -> int:
    D, H, KV, hd = a["d_model"], a["num_heads"], a["num_kv_heads"], a["head_dim"]
    return D * H * hd + 2 * D * KV * hd + H * hd * D


def ffn_params(a: dict) -> int:
    """Parameters a token multiplies in one layer's feed-forward: the MLP's
    three, or the router and its top-k experts' three (no capacity
    slack)."""
    D, F = a["d_model"], a["d_ff"]
    if a.get("num_experts", 0):
        return D * a["num_experts"] + a["experts_per_token"] * 3 * D * F
    return 3 * D * F


def block_params(a: dict) -> int:
    """Parameters in products a token meets in one block."""
    return attn_params(a) + ffn_params(a)


def unembed_params(a: dict) -> int:
    return a["d_model"] * padded_vocab(a)


def attn_pair_flops(a: dict) -> int:
    """A kept pair's forward FLOPs over every head of a layer: 2·D for
    Q·K and 2·D for P·V, a head."""
    return 4 * a["head_dim"] * a["num_heads"]


def train_step_flops(a: dict, batch: int, seq: int) -> float:
    """A training step's model FLOPs: 6 x the parameters in products (the
    blocks and the unembedding, not the lookup) a token, plus 12·D a kept
    pair a head a layer (4·D forward, 8·D backward)."""
    L, T = a["num_layers"], batch * seq
    dense = 6 * (L * block_params(a) + unembed_params(a)) * T
    attn = 3 * attn_pair_flops(a) * L * batch * causal_pairs(seq)
    return float(dense + attn)


def prefill_flops(a: dict, lengths) -> float:
    """The model FLOPs a prefill of prompts of ``lengths`` needs (padding
    not counted): 2 x the active parameters in products a real token, 4·D
    a kept pair between real positions a head a layer, and the
    unembedding at the one position each request needs."""
    L = a["num_layers"]
    tokens = sum(lengths)
    pairs = sum(causal_pairs(n) for n in lengths)
    return float(2 * L * block_params(a) * tokens
                 + attn_pair_flops(a) * L * pairs
                 + 2 * unembed_params(a) * len(lengths))


def flash_fwd_call(a: dict, lengths, esize: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) one layer's attention forward needs over sequences of
    ``lengths`` real positions: 4·D a kept pair a head; Q, K and V read
    once (K and V at the model's KV heads) and O written once."""
    H, KV, hd = a["num_heads"], a["num_kv_heads"], a["head_dim"]
    flops = attn_pair_flops(a) * sum(causal_pairs(n) for n in lengths)
    nbytes = sum(lengths) * (2 * H + 2 * KV) * hd * esize
    return float(flops), float(nbytes)


def flash_bwd_call(a: dict, lengths, esize: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) one layer's attention backward needs: 8·D a kept
    pair a head (dV, dP, dQ, dK; recomputing S not counted); Q, K, V, O and
    dO read once, the row log-sum-exp (float32) read once, dQ, dK and dV
    written once."""
    H, KV, hd = a["num_heads"], a["num_kv_heads"], a["head_dim"]
    flops = 2 * attn_pair_flops(a) * sum(causal_pairs(n) for n in lengths)
    n = sum(lengths)
    nbytes = n * ((3 * H + 2 * KV) * hd * esize + H * 4
                  + (H + 2 * KV) * hd * esize)
    return float(flops), float(nbytes)


def roofline_share(flops: float, nbytes: float, seconds: float,
                   peak_flops: float, bytes_per_s: float) -> float | None:
    """The least time the chip could take (the larger of FLOPs over the
    peak and bytes over the bandwidth) over the time taken, in %."""
    if seconds <= 0 or (flops <= 0 and nbytes <= 0):
        return None
    return 100.0 * max(flops / peak_flops, nbytes / bytes_per_s) / seconds

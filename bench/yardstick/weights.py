"""The weights of a cell, drawn from its seed on the device.

Each leaf of the model's parameter tree is drawn from a generator of its
own on the device, seeded from ``(seed, leaf index)``, in one call: a
standard normal in float32 times the leaf's scale (1 + 0.1 x N for a norm's
gain), rounded to the configuration's type.  So a leaf can be drawn again
alone (the train check redraws the start after the program has updated its
parameters in place), and the program and the plain reference get the same
values.  The tree's layout (nested dicts, the layers stacked first) is the
program's parameter format; its values are the benchmark's.
"""
from __future__ import annotations

import numpy as np
import torch

# a bias's scale: large enough that dropping a bias shows
BIAS_STD = 0.5
NORM_STD = 0.1


def leaf_specs(a: dict) -> list[tuple[tuple[str, ...], tuple[int, ...], str, float]]:
    """(path, shape, kind, scale) of every leaf, in a fixed order.  Kinds:
    ``normal`` (scale x N), ``norm`` (1 + scale x N), ``bias`` (scale x
    N).  Matrices take the fan-in's inverse square root; the embedding
    table 1.0, or ``d_model ** -0.5`` where it is tied (it is then the
    unembedding too, and its logits take an untied unembedding's scale)."""
    L, D = a["num_layers"], a["d_model"]
    H, KV, hd, F = a["num_heads"], a["num_kv_heads"], a["head_dim"], a["d_ff"]
    V = -(-a["vocab_size"] // 128) * 128
    tied = a.get("tie_embeddings", False)
    out = [(("embed", "embedding"), (V, D), "normal", D ** -0.5 if tied else 1.0)]
    if not tied:
        out.append((("embed", "unembed"), (D, V), "normal", D ** -0.5))
    out.append((("final_norm",), (D,), "norm", NORM_STD))
    b = "blocks"
    out += [
        ((b, "attn_norm"), (L, D), "norm", NORM_STD),
        ((b, "attn", "wq"), (L, D, H * hd), "normal", D ** -0.5),
        ((b, "attn", "wk"), (L, D, KV * hd), "normal", D ** -0.5),
        ((b, "attn", "wv"), (L, D, KV * hd), "normal", D ** -0.5),
        ((b, "attn", "wo"), (L, H * hd, D), "normal", (H * hd) ** -0.5),
        ((b, "mlp_norm"), (L, D), "norm", NORM_STD),
    ]
    if a.get("qkv_bias", False):
        out += [((b, "attn", "bq"), (L, H * hd), "bias", BIAS_STD),
                ((b, "attn", "bk"), (L, KV * hd), "bias", BIAS_STD),
                ((b, "attn", "bv"), (L, KV * hd), "bias", BIAS_STD)]
    E = a.get("num_experts", 0)
    if E:
        out += [((b, "moe", "router"), (L, D, E), "normal", D ** -0.5),
                ((b, "moe", "w1"), (L, E, D, F), "normal", D ** -0.5),
                ((b, "moe", "w3"), (L, E, D, F), "normal", D ** -0.5),
                ((b, "moe", "w2"), (L, E, F, D), "normal", F ** -0.5)]
    else:
        out += [((b, "mlp", "w1"), (L, D, F), "normal", D ** -0.5),
                ((b, "mlp", "w3"), (L, D, F), "normal", D ** -0.5),
                ((b, "mlp", "w2"), (L, F, D), "normal", F ** -0.5)]
    return out


def _generator(seed: int, index: int, device) -> torch.Generator:
    s = np.random.SeedSequence([seed, 1 << 20, index]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s) >> 1)


def draw_leaf(spec, index: int, seed: int, device, dtype) -> torch.Tensor:
    _, shape, kind, scale = spec
    w = torch.randn(shape, generator=_generator(seed, index, device),
                    device=device, dtype=torch.float32)
    w.mul_(scale)
    if kind == "norm":
        w.add_(1.0)
    return w.to(dtype)


def put(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def get(tree: dict, path):
    for k in path:
        tree = tree[k]
    return tree


def draw(a: dict, seed: int, device, dtype) -> dict:
    """The parameter tree of ``a`` (nested dicts, the program's layout)."""
    tree: dict = {}
    for i, spec in enumerate(leaf_specs(a)):
        put(tree, spec[0], draw_leaf(spec, i, seed, device, dtype))
    return tree

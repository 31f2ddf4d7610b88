"""The bfloat16 gradients of the port against the reference's (CPU), on
a batch whose tokens repeat as the card's training batches do: the
qwen2.5-3b smoke config in bfloat16 on the reference's weights, the
reference's Zipf batch of B 2 x S 4,096 (its first token ~2,100 times).

The port sums the embedding's gradient in float32 (``layers.embed_fwd``);
the reference scatters it in bfloat16, which rounds after every add, and
a row summed ~2,100 times ends ~0.5 of the leaf's largest magnitude from
the float32 sum.  So the port's embedding gradient is held to the
reference's with the gather read from a float32 copy of the table (the
port's formula, in the reference), and to the float32 gradient; every
other leaf to the reference's own bfloat16 gradient, and each to the
float32 gradient.  Every bar is ``TOL_BF16``: two bfloat16 units at the
leaf's largest magnitude (the leaves measured ~0.3-1.1e-2 from the
reference's and ~0.2-0.5e-2 from float32)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_model_parity as parity
from repro.data import pipeline as ref_dpipe
from repro.models import layers as ref_layers
from repro_torch.models import layers as L
from repro_torch.train import trainstep as ts

B, S = 2, 4096


def _ref_grads(rm, rp, rb):
    return jax.jit(jax.value_and_grad(rm.loss))(rp, rb)


@functools.lru_cache(maxsize=None)
def grads():
    """{name: (reference, port)} float64 gradients, with the float32
    reference gradient and the reference's float32-summed embedding."""
    rm, rp, pm, pp = parity.models("qwen2.5-3b", dtype="bfloat16")
    host = ref_dpipe.batch_at(ref_dpipe.DataConfig(rm.cfg.vocab_size, S, B,
                                                   2), 0)
    rb = {k: jnp.asarray(v) for k, v in host.items()}
    pb = {k: torch.from_numpy(np.array(v)) for k, v in host.items()}
    rl, rg = _ref_grads(rm, rp, rb)
    pl, pg = ts.value_and_grad(pm, pp, pb)
    f32 = jax.tree.map(lambda x: x.astype(jnp.float32), rp)
    rm32 = parity.models("qwen2.5-3b")[0]
    _, rg32 = _ref_grads(rm32, f32, rb)
    embed = ref_layers.embed_fwd
    try:
        ref_layers.embed_fwd = lambda p, tokens, dtype: (
            p["embedding"].astype(jnp.float32)[tokens].astype(dtype))
        _, rg_sum32 = _ref_grads(rm, rp, rb)
    finally:
        ref_layers.embed_fwd = embed
    names = ["/".join(str(k.key) for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(rg)[0]]
    out = {n: (parity.f64(r), parity.f64(p), parity.f64(r32))
           for n, r, p, r32 in zip(names, jax.tree.leaves(rg),
                                   L.tree_leaves(pg), jax.tree.leaves(rg32))}
    out["summed32"] = parity.f64(rg_sum32["embed"]["embedding"])
    out["loss"] = (float(rl), float(pl))
    out["top"] = int(np.bincount(np.asarray(host["tokens"]).ravel()).max())
    return out


def rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_the_batch_repeats_its_first_token_thousands_of_times():
    assert grads()["top"] > 2000


@pytest.mark.parametrize("leaf", [
    "blocks/attn/bk", "blocks/attn/bq", "blocks/attn/bv", "blocks/attn/wk",
    "blocks/attn/wo", "blocks/attn/wq", "blocks/attn/wv",
    "blocks/attn_norm", "blocks/mlp/w1", "blocks/mlp/w2", "blocks/mlp/w3",
    "blocks/mlp_norm", "embed/unembed", "final_norm"])
def test_bf16_gradient_leaf_matches_the_reference(leaf):
    ref, port, f32 = grads()[leaf]
    assert rel(port, ref) <= parity.TOL_BF16
    assert rel(port, f32) <= parity.TOL_BF16


def test_bf16_embedding_gradient_is_summed_in_float32():
    g = grads()
    ref, port, f32 = g["embed/embedding"]
    print(f"embedding gradient, bf16: port vs the reference summed in "
          f"float32 {rel(port, g['summed32']):.3g}; port vs float32 "
          f"{rel(port, f32):.3g}; the reference's bf16 scatter vs float32 "
          f"{rel(ref, f32):.3g}")
    assert rel(port, g["summed32"]) <= parity.TOL_BF16
    assert rel(port, f32) <= parity.TOL_BF16
    # the reference's own bfloat16 sum, which the port does not follow
    assert rel(ref, f32) > 10 * rel(port, f32)


def test_bf16_loss_matches_the_reference():
    rl, pl = grads()["loss"]
    assert abs(pl - rl) <= 1e-3 * abs(rl)

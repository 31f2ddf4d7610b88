"""The plain reference (``bench/reference``) against the port's CPU path at
``.smoke()`` widths, in float32: the prefill's last logits (dense and MoE,
with the wave's left padding), and the loss and every gradient."""
import dataclasses

import pytest
import torch

from bench_small import SEED  # noqa: F401  (puts bench/ and src/ on the path)
from reference import model as RM
from reference import train as RT
from yardstick import weights as W
from yardstick.kinds import prefill_waves, train as K

from repro_torch.configs.base import get_config
from repro_torch.models import api as mapi
from repro_torch.train import trainstep


# each configuration untied (the repository's files) and tied (the
# benchmark's cells, as published)
CASES = [(n, t) for t in (False, True)
         for n in ("qwen2.5-3b", "granite-moe-3b-a800m")]
IDS = [n + (".tied" if t else "") for n, t in CASES]


def _arch(name, tie=False):
    cfg = dataclasses.replace(get_config(name).smoke(), tie_embeddings=tie)
    keys = ("name", "family", "num_layers", "d_model", "num_heads",
            "num_kv_heads", "head_dim", "d_ff", "vocab_size", "qkv_bias",
            "rope_theta", "norm_eps", "tie_embeddings", "num_experts",
            "experts_per_token", "dtype", "cache_dtype", "remat")
    return cfg, {k: getattr(cfg, k) for k in keys}


@pytest.mark.parametrize("name,tie", CASES, ids=IDS)
def test_last_logits_match_the_program_prefill(name, tie):
    cfg, a = _arch(name, tie)
    model = mapi.build(cfg)
    params = W.draw(a, SEED, "cpu", torch.float32)
    K._layout_matches(params, model.param_structs())
    prompts = [torch.randint(0, a["vocab_size"], (n,),
                             generator=torch.Generator().manual_seed(n)).numpy()
               for n in (9, 3, 14)]
    toks = prefill_waves.left_padded(prompts, "cpu")
    logits, _ = model.prefill(params, {"tokens": toks.to(torch.int32)}, 16)
    ref = RM.last_logits(params, toks, a, RM.Prec("fp32"))
    assert torch.allclose(logits[:, -1], ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("name,tie", CASES, ids=IDS)
def test_loss_and_gradients_match_the_program(name, tie):
    cfg, a = _arch(name, tie)
    model = mapi.build(cfg)
    params = W.draw(a, SEED, "cpu", torch.float32)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, a["vocab_size"], (2, 12), generator=g)
    labels = torch.randint(0, a["vocab_size"], (2, 12), generator=g)
    loss, grads = trainstep.value_and_grad(
        model, params, {"tokens": tokens.to(torch.int32),
                        "labels": labels.to(torch.int32)})
    rloss, rgrads = RT.loss_and_grads(params, tokens, labels, a,
                                      RM.Prec("fp32"), rows=7)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    for path, _ in RT._leaf_paths(params):
        p, r = RT._get(grads, path), RT._get(rgrads, path)
        assert torch.allclose(p, r, atol=1e-5 * float(r.abs().max()) + 1e-7,
                              rtol=1e-4), path


def test_adamw_matches_the_program_optimizer():
    from repro_torch.train import optimizer as opt
    o = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
         "clip_norm": 1.0, "warmup_steps": 2, "total_steps": 10,
         "min_lr_frac": 0.1}
    g = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(4, 5, generator=g), "b": {"c": torch.randn(3, generator=g)}}
    ref = {"a": params["a"].clone(), "b": {"c": params["b"]["c"].clone()}}
    state = opt.init(params)
    mu, nu = RT.zeros_like_tree(ref), RT.zeros_like_tree(ref)
    for step in range(1, 5):
        grads = {"a": torch.randn(4, 5, generator=g) * step,
                 "b": {"c": torch.randn(3, generator=g)}}
        rg = {"a": grads["a"].clone(), "b": {"c": grads["b"]["c"].clone()}}
        params, state, _ = opt.apply_(opt.OptConfig(**o), params, grads, state)
        RT.adamw_step(ref, rg, mu, nu, step, o)
        assert torch.allclose(params["a"], ref["a"], atol=1e-7)
        assert torch.allclose(params["b"]["c"], ref["b"]["c"], atol=1e-7)

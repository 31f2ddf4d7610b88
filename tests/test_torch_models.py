"""The port's dense and VLM models against the reference's on carried
weights (smoke configs, float32, CPU: the plain attention route): the
prefill's logits and cache, three decode steps fed the same tokens and the
caches after them, ``forward`` and ``loss_fn``, each within 1e-4 of the
reference's largest magnitude (``_torch_model_parity.TOL``).  Also: the
reference's chunked attention (S 2,176), a bfloat16 model, an fp8 KV cache
decoded from ``init_cache``, and ``interop.model_params_from_numpy``'s
refusals.  The MoE, SSM, hybrid and encoder-decoder families are in
``test_torch_models_families.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_model_parity as parity
from repro_torch import interop
from repro_torch.configs import get_config

ARCHS = ("llama3-8b", "mistral-large-123b", "qwen1.5-32b", "qwen2.5-3b",
         "internvl2-76b")
KINDS = ("prefill_logits", "prefill_cache", "decode", "forward", "loss")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_model_matches_the_reference(arch, kind):
    parity.check(arch, kind)


@pytest.mark.parametrize("kind", ("prefill_logits", "prefill_cache",
                                  "decode"))
def test_chunked_attention_matches_the_reference(kind):
    """S 2,176 > EXACT_ATTN_MAX_SEQ: both sides take the online-softmax
    route over 1,024-key chunks (the last one padded and masked)."""
    parity.check("llama3-8b", kind, B=1, S=2176, max_seq=2184)


@pytest.mark.parametrize("kind", KINDS)
def test_bfloat16_model_matches_the_reference(kind):
    """llama3-8b smoke in bfloat16: the type flow (float32 norms rounded
    to bfloat16, RoPE tables in bfloat16, probabilities rounded before the
    PV product, float32 logits) within two bfloat16 units of the largest
    magnitude (``TOL_BF16``)."""
    parity.check("llama3-8b", kind, tol=parity.TOL_BF16, dtype="bfloat16")


def test_fp8_cache_decodes_from_init_cache_as_the_reference():
    """qwen1.5-32b smoke with its published float8_e4m3fn cache, decoded
    from ``init_cache`` on both sides: each step's logits within TOL, and
    the fp8 cache equal bit for bit (each writes k.astype(fp8))."""
    rm, rp, pm, pp = parity.models("qwen1.5-32b",
                                   cache_dtype="float8_e4m3fn")
    rc, pc = rm.init_cache(2, 8), pm.init_cache(2, 8, device="cpu")
    assert pc["k"].dtype == torch.float8_e4m3fn
    rng = np.random.default_rng(3)
    for t in range(4):
        tok = rng.integers(0, rm.cfg.vocab_size, (2, 1)).astype(np.int32)
        rl, rc = rm.decode_step(rp, rc, jnp.asarray(tok), jnp.int32(t))
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(tok), t)
        parity.assert_close(parity.f64(rl), parity.f64(pl), what=f"step {t}")
    for k in ("k", "v"):
        assert np.array_equal(parity.f64(rc[k]), parity.f64(pc[k]))


def _ref_tree(arch="llama3-8b"):
    rm, rp, _, _ = parity.models(arch)
    return jax.tree.map(np.asarray, rp)


def test_interop_carries_the_weights_bit_for_bit():
    tree = _ref_tree()
    cfg = get_config("llama3-8b").smoke()
    got = interop.model_params_from_numpy(cfg, tree, device="cpu")
    assert np.array_equal(got["blocks"]["attn"]["wq"].numpy(),
                          tree["blocks"]["attn"]["wq"])
    assert got["embed"]["embedding"].dtype == torch.float32


def test_interop_refuses_a_missing_name():
    tree = _ref_tree()
    del tree["blocks"]["mlp"]["w3"]
    with pytest.raises(ValueError, match="w3"):
        interop.model_params_from_numpy(get_config("llama3-8b").smoke(),
                                        tree, device="cpu")


def test_interop_refuses_a_wrong_shape():
    tree = _ref_tree()
    tree["blocks"]["attn"]["wo"] = tree["blocks"]["attn"]["wo"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        interop.model_params_from_numpy(get_config("llama3-8b").smoke(),
                                        tree, device="cpu")


def test_interop_refuses_a_wrong_type():
    tree = _ref_tree()
    tree["final_norm"] = tree["final_norm"].astype(np.float16)
    with pytest.raises(ValueError, match="dtype"):
        interop.model_params_from_numpy(get_config("llama3-8b").smoke(),
                                        tree, device="cpu")
    # the config's type decides: bfloat16 weights carry into a bfloat16
    # model, bit for bit
    rm, rp, pm, pp = parity.models("llama3-8b", dtype="bfloat16")
    w = pp["blocks"]["mlp"]["w2"]
    assert w.dtype == torch.bfloat16
    assert np.array_equal(w.float().numpy(), np.asarray(
        rp["blocks"]["mlp"]["w2"].astype(jnp.float32)))

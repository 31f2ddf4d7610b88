"""The port's MoE, SSM, hybrid and encoder-decoder models against the
reference's on carried weights (smoke configs, float32, CPU): the
prefill's logits and caches (KV, cross-KV, conv and SSM states), three
decode steps fed the same tokens and the caches after them, ``forward``
and ``loss_fn`` (with the MoE aux loss), each within 1e-4 of the
reference's largest magnitude (``_torch_model_parity.TOL``)."""
import numpy as np
import pytest
import torch

import _torch_model_parity as parity
from repro_torch.configs import get_config
from repro_torch.models import moe

ARCHS = ("whisper-small", "mamba2-130m", "dbrx-132b",
         "granite-moe-3b-a800m", "jamba-v0.1-52b")
KINDS = ("prefill_logits", "prefill_cache", "decode", "forward", "loss")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_family_model_matches_the_reference(arch, kind):
    parity.check(arch, kind)


def test_ssm_prefill_leaves_the_conv_state_at_zeros():
    """As the reference's does (ssm.py:234-241): a standing finding, the
    decode after a prefill starts from a zero conv window."""
    res = parity.run("mamba2-130m")
    ref, got = res["prefill_cache_conv"]
    assert not ref.any() and not got.any()


def test_moe_capacity_and_drops_match_the_reference():
    """``capacity`` rounds to 64 with a floor of 64, and a dispatch with
    more tokens an expert than its capacity drops the overflow (zero
    combine weight, the residual passes) as the reference's does."""
    from repro.models import moe as rmoe
    import jax.numpy as jnp
    cfg = get_config("dbrx-132b").smoke()
    for n in (1, 64, 100, 1000, 4096):
        assert moe.capacity(n, cfg) == rmoe.capacity(n, cfg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((300, cfg.d_model)).astype(np.float32)
    router = rng.standard_normal((cfg.d_model, cfg.num_experts)) \
        .astype(np.float32)
    router[:, 0] += 3.0           # most tokens prefer expert 0: it overflows
    w = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in (
        (cfg.num_experts, cfg.d_model, cfg.d_ff),
        (cfg.num_experts, cfg.d_model, cfg.d_ff),
        (cfg.num_experts, cfg.d_ff, cfg.d_model))]
    C = 64
    rxe, rcomb, raux = rmoe._dispatch(jnp.asarray(x), jnp.asarray(router),
                                      cfg, C)
    pxe, pcomb, paux = moe._dispatch(torch.from_numpy(x),
                                     torch.from_numpy(router), cfg, C)
    assert np.array_equal(np.asarray(rxe), pxe.numpy())
    ref = np.asarray(rcomb(rmoe._expert_ffn(rxe, *map(jnp.asarray, w))))
    got = pcomb(moe._expert_ffn(pxe, *map(torch.from_numpy, w))).numpy()
    parity.assert_close(ref, got, what="combine")
    parity.assert_close(np.asarray(raux), paux.numpy(), what="aux")

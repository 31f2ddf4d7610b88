"""The differentiable self-attention (``layers.FlashAttention``) on the
CPU: its backward against ``jax.vjp`` of the reference's ``_exact_attn``
and ``_chunked_attn``, within 1e-5 of the largest magnitude
(``ATTN_TOL``: float32, products summed in other orders), and the route
that takes it.  On the CPU its forward is the flash kernel's plain version
with the row log-sum-exp (``ref.flash_attention_lse``) and its backward
the backward kernel's plain version (``ref.flash_attention_bwd``); the
plain version alone, at more widths and lengths:
``test_torch_flash_attention_bwd.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_model_parity as parity
from repro.models import layers as ref_layers
from repro_torch.configs import get_config
from repro_torch.models import layers as L

ATTN_TOL = 1e-5


@pytest.mark.parametrize("S,causal", [(48, True), (48, False),
                                      (2304, True), (2304, False)])
def test_flash_attention_backward_matches_the_references_vjp(S, causal):
    """``FlashAttention`` (on the CPU its forward is the kernel's plain
    version) against ``jax.vjp`` of the reference's plain route at that
    length: ``_exact_attn`` up to 2,048 positions, ``_chunked_attn`` past
    it (2,304: two full chunks and a padded one)."""
    rng = np.random.default_rng(S + causal)
    q, k, v, dout = (rng.standard_normal((1, S, 2, 8)).astype(np.float32)
                     for _ in range(4))
    ref_fn = (ref_layers._exact_attn
              if S <= ref_layers.EXACT_ATTN_MAX_SEQ
              else ref_layers._chunked_attn)
    out, vjp = jax.vjp(lambda a, b, c: ref_fn(a, b, c, causal),
                       *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got_out = L.FlashAttention.apply(tq, tk, tv, causal)
    got = torch.autograd.grad(got_out, (tq, tk, tv),
                              torch.from_numpy(dout))
    parity.assert_close(parity.f64(out), parity.f64(got_out.detach()),
                        tol=ATTN_TOL, what="out")
    for name, w, g in zip("qkv", want, got):
        parity.assert_close(parity.f64(w), parity.f64(g), tol=ATTN_TOL,
                            what=f"d{name}")


def test_attention_takes_the_function_only_on_the_kernel_route():
    """On a CPU tensor ``attention_fwd`` stays the plain route (its
    gradient is native autograd's); the Function is the CUDA route's."""
    cfg = get_config("qwen2.5-3b").smoke()
    rng = np.random.default_rng(0)
    p = {k: torch.from_numpy(rng.standard_normal(s.shape).astype(
        np.float32) * 0.1).requires_grad_()
        for k, s in L.tree_map(lambda pd: np.empty(pd.shape),
                               L.attention_defs(cfg)).items()}
    h = torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model)).astype(
        np.float32))
    out, _ = L.attention_fwd(p, h, cfg, positions=torch.arange(8)[None])
    names = set()
    fn = out.grad_fn
    stack = [fn]
    while stack:
        f = stack.pop()
        if f is None or type(f).__name__ in names:
            continue
        names.add(type(f).__name__)
        stack.extend(g for g, _ in f.next_functions)
    assert "FlashAttentionBackward" not in names

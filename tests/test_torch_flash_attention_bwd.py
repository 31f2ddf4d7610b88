"""The attention backward's plain version (``ref.flash_attention_bwd``, what
the backward kernel computes, and ``layers.FlashAttention``'s backward on
the CPU) against ``jax.vjp`` of the reference's plain attention, on the
CPU; the forward's row log-sum-exp (``ref.flash_attention_lse``) against
the reference's scores; and the backward's route, chosen by D alone.

Inputs are drawn with numpy from a seed.  ``ATTN_TOL`` is
``test_torch_flash_attention_grad.py``'s bar: float32, products summed in
other orders, within 1e-5 of the largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_model_parity as parity
from repro.models import layers as ref_layers
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ref
from repro_torch.models import layers as L

ATTN_TOL = 1e-5
# bf16 inputs through the plain backward, held to the float32 VJP of the
# same values: the forward's output rounds its probabilities and itself to
# bf16 (2^-9 each), which enters Delta = rowsum(dO * O), and dq, dk, dv are
# rounded to bf16 (2^-9): the bar is two bf16 units of the largest
# magnitude, 2^-7
BF16_TOL = 2 ** -7


def _inputs(S, D, seed, H=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, S, H, D)).astype(np.float32)
            for _ in range(4)]


def _reference_vjp(q, k, v, dout, causal):
    fn = (ref_layers._exact_attn if q.shape[1] <= ref_layers.EXACT_ATTN_MAX_SEQ
          else ref_layers._chunked_attn)
    out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, causal),
                       *map(jnp.asarray, (q, k, v)))
    return out, vjp(jnp.asarray(dout))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [48, 200, 2304])
@pytest.mark.parametrize("D", [16, 32, 64, 128, 20])
def test_plain_backward_matches_the_references_vjp(D, S, causal):
    """D 16 to 128 and 20 (no multiple of 16); S 48, 200 (no tile
    multiple) and 2,304 (the reference's chunked route past
    ``EXACT_ATTN_MAX_SEQ``)."""
    q, k, v, dout = _inputs(S, D, seed=D * 7 + S + causal)
    out, want = _reference_vjp(q, k, v, dout, causal)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    t_out, lse = ref.flash_attention_lse(tq, tk, tv, causal)
    parity.assert_close(parity.f64(out), parity.f64(t_out), tol=ATTN_TOL,
                        what="out")
    got = ref.flash_attention_bwd(tq, tk, tv, t_out, lse, tdo, causal)
    for name, w, g in zip("qkv", want, got):
        parity.assert_close(parity.f64(w), parity.f64(g), tol=ATTN_TOL,
                            what=f"d{name}")


@pytest.mark.parametrize("S,causal", [(48, True), (200, False),
                                      (2304, True)])
def test_plain_lse_is_the_logsumexp_of_the_references_scores(S, causal):
    """The row log-sum-exp of the reference's scaled scores, masked with
    its finite -1e30 (``layers.py:142-157``), ``[B, H, S]``."""
    q, k, _, _ = _inputs(S, 32, seed=S)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k).astype(jnp.float32) \
        * q.shape[-1] ** -0.5
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((S, S), bool))[None, None], s,
                      -1e30)
    want = jax.nn.logsumexp(s, axis=-1)
    got = ref.flash_attention_lse(*map(torch.from_numpy, (q, k, k)),
                                  causal)[1]
    assert got.shape == (1, 2, S) and got.dtype == torch.float32
    parity.assert_close(parity.f64(want), parity.f64(got), tol=ATTN_TOL,
                        what="lse")


@pytest.mark.parametrize("S,causal", [(200, True), (2304, False)])
def test_bf16_backward_is_within_a_bf16_bar_of_float32(S, causal):
    """bf16 inputs through the forward and the plain backward (bf16
    gradients) against the float32 VJP of the same values, at
    ``BF16_TOL``."""
    q, k, v, dout = _inputs(S, 64, seed=S + 1)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, dout)]
    f32 = [t.float().numpy() for t in bf]
    _, want = _reference_vjp(*f32, causal)
    out, lse = ref.flash_attention_lse(*bf[:3], causal)
    got = ref.flash_attention_bwd(*bf[:3], out, lse, bf[3], causal)
    assert all(g.dtype == torch.bfloat16 for g in got)
    for name, w, g in zip("qkv", want, got):
        parity.assert_close(parity.f64(w), parity.f64(g.float()),
                            tol=BF16_TOL, what=f"d{name}")


def test_backward_route_is_chosen_by_d_alone():
    """The kernel for every head up to 128 columns, the plain route's VJP
    past it; ``FlashAttention`` takes the plain VJP only there (counted),
    whatever the type, and saves the kernel route's output and row
    log-sum-exp below it."""
    assert all(fab.route(D) == "kernel" for D in range(1, 129))
    assert all(fab.route(D) == "plain_vjp" for D in (129, 160, 256, 512))
    for D, dtype, plain in ((100, torch.float32, 0), (128, torch.bfloat16, 0),
                            (160, torch.float32, 1), (256, torch.bfloat16, 1)):
        q, k, v, dout = (torch.from_numpy(x).to(dtype)
                         for x in _inputs(40, D, seed=D))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        n0 = fab.flash_attention_bwd.plain_vjp_calls
        out = L.FlashAttention.apply(*leaves, True)
        assert len(out.grad_fn.saved_tensors) == (3 if plain else 5)
        grads = torch.autograd.grad(out, leaves, dout)
        assert fab.flash_attention_bwd.plain_vjp_calls - n0 == plain
        assert all(g.shape == q.shape and g.dtype == dtype for g in grads)


@pytest.mark.parametrize("D", [64, 160])
def test_function_backward_under_remat_is_the_same(D):
    """``FlashAttention`` recomputed by ``torch.utils.checkpoint`` (as
    ``layers.run_layer`` runs a layer under remat) gives the gradients it
    gives without, on both routes: its backward unpacks its saved tensors
    once, as the checkpoint's recompute requires."""
    q, k, v, dout = map(torch.from_numpy, _inputs(40, D, seed=D + 1))
    body = lambda *t: L.FlashAttention.apply(*t, True)
    grads = []
    for remat in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = (torch.utils.checkpoint.checkpoint(body, *leaves,
                                                 use_reentrant=False)
               if remat else body(*leaves))
        grads.append(torch.autograd.grad(out, leaves, dout))
    assert all(torch.equal(a, b) for a, b in zip(*grads))

"""The port's fixed-order sums where the card's scatter-adds use atomics,
on the CPU: the MoE combine (``moe._SlotSum``) against the reference's
scatter (``repro/models/moe.py:77-80``) bit for bit, the dispatch gather's
backward (``moe._SlotGather``) against ``jax.vjp`` of the reference's
dispatch bit for bit, both with dropped slots, and the embedding gradient's
segment sum (``kernels.segment_sum``, ``layers.EmbedGather``) against
float64 sums within float32 rounding.  Inputs drawn with numpy from a
seed.  Their repeatability on the card: ``test_torch_cuda.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as rmoe
from repro_torch.configs import get_config
from repro_torch.kernels import segment_sum as ss
from repro_torch.models import layers as L
from repro_torch.models import moe

# (arch, overrides): dbrx's smoke config (top 2), and granite's with eight
# experts and top 4, where the order of a token's adds matters
CONFIGS = [("dbrx-132b", {}),
           ("granite-moe-3b-a800m", dict(num_experts=8, experts_per_token=4))]


def _dispatch_inputs(cfg, T, seed):
    """Tokens and a router under which expert 0 overflows its capacity."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, cfg.d_model)).astype(np.float32)
    router = rng.standard_normal((cfg.d_model, cfg.num_experts)) \
        .astype(np.float32)
    router[:, 0] += 3.0
    return x, router


@pytest.mark.parametrize("arch,over", CONFIGS)
def test_moe_combine_is_the_references_scatter_bit_for_bit(arch, over):
    """The combine's inputs (``_combine``'s keywords) through the
    reference's scatter, ``zeros.at[buf_src].add(upd, mode="drop")``, give
    the port's combine's bits: each token's slots added from 0.0 in
    ascending slot order.  Rows of very different magnitudes make the
    order show; some choices are dropped and some slots empty."""
    cfg = get_config(arch).smoke().scaled(**over)
    x, router = _dispatch_inputs(cfg, 300, seed=5)
    C = 64
    xe, comb, _ = moe._dispatch(torch.from_numpy(x),
                                torch.from_numpy(router), cfg, C)
    kw = comb.keywords
    E, K = cfg.num_experts, cfg.experts_per_token
    assert kw["inv"].shape == (300, K)
    assert bool((kw["inv"] == E * C).any())            # dropped choices
    rng = np.random.default_rng(6)
    ye = (rng.standard_normal(xe.shape)
          * 10.0 ** rng.integers(-6, 6, xe.shape[:2])[..., None]) \
        .astype(np.float32)
    got = comb(torch.from_numpy(ye)).numpy()
    upd = ye.reshape(E * C, -1) * kw["weights"].numpy()[:, None]
    want = np.asarray(jnp.zeros((300, cfg.d_model), jnp.float32)
                      .at[jnp.asarray(kw["src"].numpy())]
                      .add(jnp.asarray(upd), mode="drop"))
    assert np.array_equal(want, got)


@pytest.mark.parametrize("arch,over", CONFIGS)
def test_dispatch_gather_backward_is_the_references_vjp_bit_for_bit(arch,
                                                                    over):
    """``xe = x[buf_tok]``'s gradient (each token's slots summed in slot
    order) against ``jax.vjp`` of the reference's dispatch, the same
    buffers (the dispatched rows equal), bit for bit."""
    cfg = get_config(arch).smoke().scaled(**over)
    x, router = _dispatch_inputs(cfg, 300, seed=7)
    C = 64
    rxe, vjp = jax.vjp(lambda a: rmoe._dispatch(a, jnp.asarray(router), cfg,
                                                C)[0], jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    pxe = moe._dispatch(tx, torch.from_numpy(router), cfg, C)[0]
    assert np.array_equal(np.asarray(rxe), pxe.detach().numpy())
    dxe = np.random.default_rng(8).standard_normal(pxe.shape) \
        .astype(np.float32)
    want = np.asarray(vjp(jnp.asarray(dxe))[0])
    got = torch.autograd.grad(pxe, tx, torch.from_numpy(dxe))[0].numpy()
    assert np.array_equal(want, got)


def test_slot_sum_adds_in_the_given_order_from_zero():
    """``slot_sum`` adds row by row in ``inv``'s order from 0.0, an index
    past the rows reading zeros: a sum that depends on the order."""
    rows = torch.tensor([[1e8], [1.0], [-1e8], [3.0]], dtype=torch.float32)
    inv = torch.tensor([[0, 1, 2], [0, 2, 1], [4, 3, 4]])
    got = moe.slot_sum(rows, inv)[:, 0].tolist()
    assert got == [0.0, 1.0, 3.0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_is_the_float64_sum_within_float32_rounding(dtype):
    """Each output row's positions summed in float32: within n * 2^-24 of
    the sum of magnitudes of the float64 sum (n the row's count, the bound
    of n - 1 rounded adds), rows no index points at zero, and in position
    order: the same bits as adding the rows one by one.  ``EmbedGather``'s
    backward is this sum, rounded once to the table's type."""
    rng = np.random.default_rng(1)
    V, N, D = 500, 3000, 24
    idx = torch.from_numpy(np.minimum(rng.zipf(1.3, N) - 1, V - 1))
    rows = torch.from_numpy((rng.standard_normal((N, D))
                             * 10.0 ** rng.integers(-3, 4, (N, 1)))
                            .astype(np.float32))
    got = ss.segment_sum(rows, idx, V, torch.float32)
    f64 = torch.zeros(V, D, dtype=torch.float64).index_add_(
        0, idx, rows.double())
    mag = torch.zeros(V, D, dtype=torch.float64).index_add_(
        0, idx, rows.double().abs())
    n = torch.bincount(idx, minlength=V).double()[:, None]
    assert bool(((got.double() - f64).abs() <= n * 2 ** -24 * mag).all())
    assert not got[n[:, 0] == 0].any()
    one = torch.zeros(D)
    for i in np.flatnonzero(idx.numpy() == 0):
        one = one + rows[i]
    assert torch.equal(got[0], one)
    w = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32)) \
        .to(dtype).requires_grad_()
    tokens = idx.reshape(3, N // 3)
    out = L.EmbedGather.apply(w, tokens, torch.float32)
    assert torch.equal(out, w.detach()[tokens].float())
    (g,) = torch.autograd.grad(out, w, rows.reshape(3, N // 3, D))
    assert g.dtype == dtype and torch.equal(g, got.to(dtype))

"""The port's train step against the reference's, continued (CPU; the
harness and its tolerances are ``_torch_train_parity``).

The hybrid, encoder-decoder and VLM families' loss, every gradient and
one step; remat on against remat off, bit for bit, for all six families,
and the recompute it adds.
"""
import pytest
import torch

import _torch_model_parity as parity
import _torch_train_parity as tp
from repro_torch.models import layers as L
from repro_torch.train import trainstep as ts

B, S = tp.B, tp.S


@pytest.mark.parametrize("family", ["hybrid", "encdec", "vlm"])
def test_loss_gradients_and_one_step_match_the_reference(family):
    tp.check_family(tp.FAMILIES[family])


@pytest.mark.parametrize("family", tp.FAMILIES)
def test_remat_on_equals_remat_off_bitwise(family):
    arch = tp.FAMILIES[family]
    out = {}
    for remat in (False, True):
        _, _, pm, pp = parity.models(arch, remat=remat)
        _, pb = parity.inputs(pm.cfg, B, S, seed=1)
        out[remat] = ts.value_and_grad(pm, pp, pb)
    (l0, g0), (l1, g1) = out[False], out[True]
    assert torch.equal(l0, l1)
    for a, b in zip(L.tree_leaves(g0), L.tree_leaves(g1)):
        assert torch.equal(a, b)


def test_remat_recomputes_each_layer_in_the_backward(monkeypatch):
    """With remat the layer bodies run again in the backward (a
    checkpoint each), without it once; with no gradient recorded, once."""
    from repro_torch.models import transformer as T
    calls = {"n": 0}
    block_fwd = T.block_fwd

    def counting(*a, **k):
        calls["n"] += 1
        return block_fwd(*a, **k)

    monkeypatch.setattr(T, "block_fwd", counting)
    for remat, want in ((False, 2), (True, 4)):
        _, _, pm, pp = parity.models("qwen2.5-3b", remat=remat)
        _, pb = parity.inputs(pm.cfg, 2, 8, seed=1)
        calls["n"] = 0
        ts.value_and_grad(pm, pp, pb)
        assert calls["n"] == want, (remat, calls["n"])
        calls["n"] = 0
        pm.loss(pp, pb)
        assert calls["n"] == 2
